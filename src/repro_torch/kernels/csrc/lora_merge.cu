// Fused merged-LoRA weight update for Hopper: W' = W + scale * (A @ B)
// over stacked layers, float32 accumulation, stored in W's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lora_merge.py
// (lora_merge / _lora_kernel), the adapter switch of paper section 4.3.2.
//
// Bound on the H100: the bytes of W (read once) and W' (written once).
// The rank-r product costs 2r + 1 FLOPs per element of W, against 4 bytes
// moved per bf16 element: at r = 16 that is 8 FLOPs per byte, under the
// ridge of the float32 CUDA cores (67 TFLOP/s over 3.35 TB/s, 20 FLOPs per
// byte), so the product stays on the CUDA cores.  Design: one CTA of 256 threads per
// (64-row, 128-column) tile of one layer's W.  The CTA stages its A row
// block (64 x r) and B column block (r x 128) in shared memory, so the
// rank-r delta never exists in device memory; each thread owns 8
// consecutive columns of 4 rows, reads W as one 16-byte vector per row,
// adds the delta and stores W' with one vector store.  One streaming pass
// over W.
//
// Layouts (contiguous): W, out (L, Din, Dout); A (L, Din, r) float32;
// B (L, r, Dout) float32.  Dout % 8 == 0, r <= 32.
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kBI = 64, kBJ = 128, kVec = 8, kMaxRank = 32;
constexpr int kThreads = 256;
constexpr int kColGroups = kBJ / kVec;             // 16
constexpr int kRowGroups = kThreads / kColGroups;  // 16

struct LoraArgs {
  const void* W; const float* A; const float* B; void* out;
  int Din, Dout, r;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_merge_kernel(const LoraArgs a) {
  constexpr int kLoad = 16 / sizeof(T);      // elements per 16-byte access
  __shared__ float as[kBI][kMaxRank];
  __shared__ __align__(16) float bs[kMaxRank][kBJ];
  const int l = blockIdx.z, i0 = blockIdx.y * kBI, j0 = blockIdx.x * kBJ;
  const int r = a.r, t = threadIdx.x;
  const float* A = a.A + (long long)l * a.Din * r;
  const float* Bm = a.B + (long long)l * r * a.Dout;
  for (int idx = t; idx < kBI * r; idx += kThreads) {
    const int ii = idx / r, kk = idx % r;
    as[ii][kk] = i0 + ii < a.Din ? A[(long long)(i0 + ii) * r + kk] : 0.f;
  }
  for (int idx = t; idx < r * kBJ; idx += kThreads) {
    const int kk = idx / kBJ, jj = idx % kBJ;
    bs[kk][jj] = j0 + jj < a.Dout ? Bm[(long long)kk * a.Dout + j0 + jj]
                                  : 0.f;
  }
  __syncthreads();

  const int cj = (t % kColGroups) * kVec;
  const int j = j0 + cj;
  if (j >= a.Dout) return;
  const long long lbase = (long long)l * a.Din * a.Dout;
  for (int ii = t / kColGroups; ii < kBI; ii += kRowGroups) {
    const int i = i0 + ii;
    if (i >= a.Din) break;
    float d[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) d[e] = 0.f;
    for (int kk = 0; kk < r; ++kk) {
      const float av = as[ii][kk];
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][cj]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][cj + 4]);
      d[0] += av * b0.x; d[1] += av * b0.y; d[2] += av * b0.z;
      d[3] += av * b0.w; d[4] += av * b1.x; d[5] += av * b1.y;
      d[6] += av * b1.z; d[7] += av * b1.w;
    }
    const long long off = lbase + (long long)i * a.Dout + j;
    const T* wp = static_cast<const T*>(a.W) + off;
    T* op = static_cast<T*>(a.out) + off;
    float w[kVec];
#pragma unroll
    for (int c = 0; c < kVec; c += kLoad) load_vec<T, kLoad>(wp + c, w + c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) w[e] += a.scale * d[e];
#pragma unroll
    for (int c = 0; c < kVec; c += kLoad) store_vec<T, kLoad>(op + c, w + c);
  }
}

template <typename T>
cudaError_t launch_t(const LoraArgs& a, int L, cudaStream_t stream) {
  const dim3 grid((a.Dout + kBJ - 1) / kBJ, (a.Din + kBI - 1) / kBI, L);
  lora_merge_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pb_lora_merge(int dtype, int device, const void* W,
                             const void* A, const void* B, void* out, int L,
                             int Din, int Dout, int r, float scale,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (r < 1 || r > kMaxRank || Dout % kVec != 0) return cudaErrorInvalidValue;
  if (L <= 0 || Din <= 0 || Dout <= 0) return cudaSuccess;
  LoraArgs a;
  a.W = W; a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B); a.out = out;
  a.Din = Din; a.Dout = Dout; a.r = r; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, L, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, L, s);
  return cudaErrorInvalidValue;
}
