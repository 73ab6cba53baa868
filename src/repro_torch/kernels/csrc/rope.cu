// Split-half RoPE on a decode step's q (B, 1, Hq, hd) and k (B, 1, Hkv,
// hd) in one launch: for each head and j < hd/2, with ang = pos[b] *
// inv_freq[j],
//   out[j]        = x[j] cos(ang) - x[j + hd/2] sin(ang)
//   out[j + hd/2] = x[j] sin(ang) + x[j + hd/2] cos(ang).
//
// Replaces no TPU kernel: the JAX package leaves RoPE to XLA, which fuses
// it into one loop.  It was added because the port's decode step ran each
// RoPE as seventeen PyTorch kernels (the inverse frequencies rebuilt, the
// angles, cos, sin, the casts, four products, the sum, the difference and
// the concatenation), twice a layer, all captured into the step's CUDA
// graph, where each node costs its launch latency: at opt-1.3b's decode
// shapes q and k hold 256 KB in bf16, 0.15 us of reads and writes at 3.35
// TB/s.
//
// Bound on the H100: the bytes (q and k read and written once, the
// positions and inv_freq read once).  At decode sizes one launch sets the
// time, so q and k go through the same one.
//
// Design: one thread per (row b, head of q then k, pair j): it reads
// x[j] and x[j + hd/2], takes cosf and sinf of its angle (precise, as
// PyTorch's cos and sin kernels take them: the build has no fast-math
// flag) and writes the pair.  The grid is (ceil((Hq + Hkv) hd / 2 / 256),
// B); neighbouring threads read neighbouring elements.  Every product,
// sum and difference is rounded to nearest on its own (no fused
// multiply-add) in models/layers.py's apply_rope order, so the result is
// that of the plain version's PyTorch kernels.
//
// Layouts: q, k any strides over (b, head) with hd contiguous; pos (B,)
// int32; inv_freq (hd/2,) float32; qo (B, Hq, hd), ko (B, Hkv, hd)
// contiguous.  q, k, qo, ko in one dtype (bfloat16 or float32).
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kThreads = 256;

struct RopeArgs {
  const void* q; const void* k; const int* pos; const float* inv;
  void* qo; void* ko;
  long long q_sb, q_sh, k_sb, k_sh;
  int Hq, Hkv, half;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rope_qk_kernel(RopeArgs a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (a.Hq + a.Hkv) * a.half) return;
  const int b = blockIdx.y;
  const int head = t / a.half, j = t - head * a.half;
  const T* src;
  T* dst;
  if (head < a.Hq) {
    src = static_cast<const T*>(a.q) + b * a.q_sb + head * a.q_sh;
    dst = static_cast<T*>(a.qo) + ((long long)b * a.Hq + head) * 2 * a.half;
  } else {
    const int hk = head - a.Hq;
    src = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    dst = static_cast<T*>(a.ko) + ((long long)b * a.Hkv + hk) * 2 * a.half;
  }
  const float ang = __fmul_rn((float)a.pos[b], a.inv[j]);
  const float c = cosf(ang), s = sinf(ang);
  const float x1 = to_float(src[j]), x2 = to_float(src[j + a.half]);
  dst[j] = from_float<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  dst[j + a.half] = from_float<T>(__fadd_rn(__fmul_rn(x1, s),
                                            __fmul_rn(x2, c)));
}

}  // namespace

extern "C" int pb_rope_qk(int dtype, int device, const void* q,
                          const void* k, const void* pos, const void* inv,
                          void* qo, void* ko, const long long* st, int B,
                          int Hq, int Hkv, int hd, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hd <= 0 || hd % 2 != 0 || Hq < 0 || Hkv < 0 || B > 65535)
    return cudaErrorInvalidValue;
  if (B <= 0 || Hq + Hkv == 0) return cudaSuccess;
  RopeArgs a;
  a.q = q; a.k = k; a.pos = static_cast<const int*>(pos);
  a.inv = static_cast<const float*>(inv); a.qo = qo; a.ko = ko;
  a.q_sb = st[0]; a.q_sh = st[1]; a.k_sb = st[2]; a.k_sh = st[3];
  a.Hq = Hq; a.Hkv = Hkv; a.half = hd / 2;
  const dim3 grid((unsigned)(((Hq + Hkv) * a.half + kThreads - 1) / kThreads),
                  (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16)
    rope_qk_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  else if (dtype == kDtypeF32)
    rope_qk_kernel<float><<<grid, kThreads, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
