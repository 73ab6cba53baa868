// Shared helpers of the PipeBoost Hopper kernels: element conversion,
// vector loads/stores (16-byte accesses at most), warp reductions, dtype
// codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace pb {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF mask value

__device__ __forceinline__ float minus_inf() {  // a score that weighs 0
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// Load N consecutive elements (N * sizeof(T) bytes, naturally aligned) as
// one vector access, or as 16-byte accesses where they are wider, and
// widen them to float.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES > 16) {
    constexpr int M = 16 / (int)sizeof(T);
    static_assert(N % M == 0, "wide vectors split into 16-byte pieces");
#pragma unroll
    for (int i = 0; i < N; i += M) load_vec<T, M>(p + i, out + i);
  } else {
    using V = typename VecOf<BYTES>::type;
    const V raw = *reinterpret_cast<const V*>(p);
    T v[N];
    memcpy(v, &raw, sizeof(V));
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(v[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float* in) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES > 16) {
    constexpr int M = 16 / (int)sizeof(T);
    static_assert(N % M == 0, "wide vectors split into 16-byte pieces");
#pragma unroll
    for (int i = 0; i < N; i += M) store_vec<T, M>(p + i, in + i);
  } else {
    using V = typename VecOf<BYTES>::type;
    T v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = from_float<T>(in[i]);
    V raw;
    memcpy(&raw, v, sizeof(V));
    *reinterpret_cast<V*>(p) = raw;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace pb
