// Fused residual add and RMSNorm over rows, for the captured decode step:
// with a residual, s = x + residual (rounded to the rows' dtype, the new
// residual stream) and h = (s * rsqrt(mean(s^2) + eps)) * w; without one,
// h of x alone.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses each into one loop.  It was added because the port's decode step
// ran every RMSNorm as nine PyTorch kernels (two casts, the square, the
// mean, the eps add, rsqrt, two products, the cast back) and a residual
// add before it as a tenth, all captured into the step's CUDA graph, where
// each node costs its launch latency: at opt-1.3b's decode rows (32 x 2048
// bf16, 128 KB) the bytes take 0.04-0.16 us at 3.35 TB/s and each launch
// a few microseconds.
//
// Bound on the H100: the bytes (x, the residual and w read once, s and h
// written once); the arithmetic is about five operations an element.  At
// decode sizes one launch, not bandwidth, sets the time, so everything
// happens in one.
//
// Design: one CTA a row (a decode step has 4-64 independent rows), a warp
// per 32 16-byte vectors of the row (V = 8 bf16 or 4 float32 elements),
// at most kMaxThreads threads, each holding at most kMaxVecs vectors in
// registers: every input is read once and s and h are written once.  The
// float32 sum of squares runs across each warp by shuffles and across the
// warps through shared memory.  The arithmetic and its order are those of
// models/layers.py's rms_norm after a rounded add: s widened to float32,
// squared, summed, multiplied by 1/D, eps added, rsqrtf taken, then
// (s * r) * w rounded once to the output dtype, each step rounded to
// nearest (no fused multiply-add), so only the sum's order differs from
// PyTorch's.
//
// Layouts: x, residual, h, s contiguous (rows, D); w (D,); one dtype for
// all (bfloat16 or float32), 16-byte aligned; D a multiple of V and D / V
// at most kMaxThreads * kMaxVecs.
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kMaxThreads = 512;
constexpr int kMaxVecs = 4;

struct NormArgs {
  const void* x; const void* res; const void* w; void* h; void* s;
  int D; float eps; float inv_d;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_kernel(NormArgs a) {
  constexpr int V = 16 / (int)sizeof(T);
  const int nvec = a.D / V;
  const long long row = (long long)blockIdx.x * a.D;
  const T* x = static_cast<const T*>(a.x) + row;
  float v[kMaxVecs][V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      load_vec<T, V>(x + i * V, v[k]);
      if (a.res != nullptr) {
        float r[V];
        load_vec<T, V>(static_cast<const T*>(a.res) + row + i * V, r);
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[k][e] = to_float(from_float<T>(__fadd_rn(v[k][e], r[e])));
        store_vec<T, V>(static_cast<T*>(a.s) + row + i * V, v[k]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e)
        ss = __fadd_rn(ss, __fmul_rn(v[k][e], v[k][e]));
    }
  }
  __shared__ float part[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(part[0], a.inv_d), a.eps));
  const T* w = static_cast<const T*>(a.w);
  T* h = static_cast<T*>(a.h) + row;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      float wv[V], o[V];
      load_vec<T, V>(w + i * V, wv);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = __fmul_rn(__fmul_rn(v[k][e], r), wv[e]);
      store_vec<T, V>(h + i * V, o);
    }
  }
}

template <typename T>
cudaError_t launch_t(const NormArgs& a, int rows, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  if (a.D % V != 0) return cudaErrorInvalidValue;
  const int nvec = a.D / V;
  const int threads = nvec >= kMaxThreads ? kMaxThreads : (nvec + 31) / 32 * 32;
  if (nvec > threads * kMaxVecs) return cudaErrorInvalidValue;
  rms_norm_kernel<T><<<rows, threads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pb_rms_norm(int dtype, int device, const void* x,
                           const void* res, const void* w, void* h, void* s,
                           int rows, int D, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (D <= 0 || (res != nullptr && s == nullptr)) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  NormArgs a;
  a.x = x; a.res = res; a.w = w; a.h = h; a.s = s;
  a.D = D; a.eps = eps; a.inv_d = 1.0f / (float)D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, rows, st);
  if (dtype == kDtypeF32) return launch_t<float>(a, rows, st);
  return cudaErrorInvalidValue;
}
