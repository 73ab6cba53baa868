// Flash attention forward (prefill) for Hopper: online-softmax attention
// with a causal mask, a sliding window and a query offset, GQA by h / G.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  Semantics are the reference's:
// scores use q * scale in float32, masked keys score -1e30 and weigh 0,
// a row with no valid key writes zeros.
//
// Bound on the H100: at the prefill shapes of the serving path (Sq = Sk <=
// 1024, hd 64, 128 or 256) the bytes of q, k, v and out and the tensor-core
// time are of one order, so a kernel doing the products on the CUDA cores
// in float32 (this one) is bound by its FMA rate, not by the card's.  That
// is the simple first version: wgmma and TMA come later.  Design: one CTA
// per (64-query block, query head, batch row); TPR threads share a query
// row (two at hd 64 and 128, four at hd 256) and each keeps hd / TPR
// dimensions of it (q * scale and the float32 accumulator, at most 64 + 64
// registers) in registers, so a score is TPR partial dot products and one
// or two shuffles.  K/V tiles of 8 KB each (16 keys at least: 16 KB at
// float32 hd 256) are staged in shared memory; all threads of a part read the same shared address
// (broadcast, no bank conflicts).  The online softmax runs over chunks of
// 16 keys.
// Key tiles that the causal mask or the window hides from every query of
// the block are never loaded; the ragged edges (Sq, Sk not multiples of
// the blocks) are masked in the kernel, so nothing is padded or copied.
//
// Layouts (element strides, innermost dimension contiguous):
//   q (B, Hq, Sq, hd); k/v (B, Hkv, Sk, hd); out (B, Hq, Sq, hd).
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kChunk = 16;     // keys per online-softmax update

// threads sharing one query row: each holds at most 64 dims of q and acc
__host__ __device__ constexpr int threads_per_row(int hd) {
  return hd <= 128 ? 2 : hd / 64;
}

struct FlashArgs {
  const void* q; const void* k; const void* v; void* out;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int Sq, Sk, G, causal, window, q_offset;
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ * threads_per_row(HD))
flash_attention_kernel(const FlashArgs a) {
  constexpr int TPR = threads_per_row(HD);
  constexpr int kThreads = kBQ * TPR;
  constexpr int PART = HD / TPR;                       // dims per thread
  constexpr int VEC = 16 / sizeof(T);                  // elements per 16 B
  constexpr int BK8K = 8192 / (HD * (int)sizeof(T));  // keys in 8 KB
  constexpr int BK = BK8K > kChunk ? BK8K : kChunk;    // keys per tile
  static_assert(BK % kChunk == 0, "tile must hold whole chunks");
  constexpr int TILE_VECS = BK * HD * (int)sizeof(T) / 16;
  __shared__ uint4 ks_raw[TILE_VECS];      // raw 16-byte storage, viewed
  __shared__ uint4 vs_raw[TILE_VECS];      // as T below
  T* ks = reinterpret_cast<T*>(ks_raw);
  T* vs = reinterpret_cast<T*>(vs_raw);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int t = threadIdx.x, row = t / TPR, part_i = t % TPR;
  const int qi = qb * kBQ + row;
  const bool row_ok = qi < a.Sq;
  const int qpos = a.q_offset + qi;

  float qr[PART];
  if (row_ok) {
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh
                  + qi * a.q_ss + part_i * PART;
#pragma unroll
    for (int c = 0; c < PART; c += VEC) load_vec<T, VEC>(qp + c, qr + c);
#pragma unroll
    for (int e = 0; e < PART; ++e) qr[e] *= a.scale;
  } else {
#pragma unroll
    for (int e = 0; e < PART; ++e) qr[e] = 0.f;
  }

  // keys any query of this block can see
  const int q_first = a.q_offset + qb * kBQ;
  const int q_last = a.q_offset + min(qb * kBQ + kBQ, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q_first - a.window + 1);
  k_begin = (k_begin / BK) * BK;

  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float m = kNegInf, l = 0.f, acc[PART];
#pragma unroll
  for (int e = 0; e < PART; ++e) acc[e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                       // previous tile consumed
    constexpr int CPR = HD / VEC;          // 16-byte chunks per row
    for (int c = t; c < BK * CPR; c += kThreads) {
      const int r = c / CPR, cc = (c % CPR) * VEC, j = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(kbase + j * a.k_ss + cc);
        vv = *reinterpret_cast<const uint4*>(vbase + j * a.v_ss + cc);
      }
      *reinterpret_cast<uint4*>(ks + r * HD + cc) = kv;
      *reinterpret_cast<uint4*>(vs + r * HD + cc) = vv;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BK && k0 + c0 < k_end; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const T* kr = ks + (c0 + jj) * HD + part_i * PART;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < PART; c += VEC) {
          float kf[VEC];
          load_vec<T, VEC>(kr + c, kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) part += qr[c + e] * kf[e];
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[jj] = part;
      }
      float mc = kNegInf;
      bool ok[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int kp = k0 + c0 + jj;
        bool o = row_ok && kp < a.Sk;
        if (a.causal) o = o && kp <= qpos;
        if (a.window > 0) o = o && kp > qpos - a.window;
        ok[jj] = o;
        if (o) mc = fmaxf(mc, s[jj]);
      }
      const float mn = fmaxf(m, mc);
      const float corr = expf(m - mn);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = ok[jj] ? expf(s[jj] - mn) : 0.f;
        ps += s[jj];
      }
      l = l * corr + ps;
#pragma unroll
      for (int e = 0; e < PART; ++e) acc[e] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const T* vr = vs + (c0 + jj) * HD + part_i * PART;
#pragma unroll
        for (int c = 0; c < PART; c += VEC) {
          float vf[VEC];
          load_vec<T, VEC>(vr + c, vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[c + e] += s[jj] * vf[e];
        }
      }
      m = mn;
    }
  }

  if (row_ok) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int e = 0; e < PART; ++e) acc[e] *= inv;
    T* op = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + qi * a.o_ss
            + part_i * PART;
#pragma unroll
    for (int c = 0; c < PART; c += VEC) store_vec<T, VEC>(op + c, acc + c);
  }
}

template <typename T>
cudaError_t launch_t(const FlashArgs& a, int B, int Hq, int hd,
                     cudaStream_t stream) {
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, Hq, B);
  if (hd == 64)
    flash_attention_kernel<T, 64><<<grid, kBQ * threads_per_row(64), 0,
                                    stream>>>(a);
  else if (hd == 128)
    flash_attention_kernel<T, 128><<<grid, kBQ * threads_per_row(128), 0,
                                     stream>>>(a);
  else if (hd == 256)
    flash_attention_kernel<T, 256><<<grid, kBQ * threads_per_row(256), 0,
                                     stream>>>(a);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" int pb_flash_attention(
    int dtype, int device, const void* q, const void* k, const void* v,
    void* out, const long long* st, int B, int Hq, int Hkv, int Sq, int Sk,
    int hd, int causal, int window, int q_offset, float scale,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.Sq = Sq; a.Sk = Sk; a.G = Hq / Hkv; a.causal = causal;
  a.window = window; a.q_offset = q_offset; a.scale = scale;
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, B, Hq, hd, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, B, Hq, hd, s);
  return cudaErrorInvalidValue;
}
