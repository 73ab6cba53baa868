// Decode attention for Hopper: one query token per (batch row, query head)
// against a KV cache, masked by per-row valid lengths and an optional
// per-slot mask, with the current token's K/V folded in after the cache
// (zero-copy decode).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  Semantics are the reference's:
// scores use q * scale in float32; masked slots score -1e30 and weigh 0;
// the new token merges as one more online-softmax partial; rows with no
// valid key write zeros.
//
// Bound on the H100: the bytes of the valid K/V rows (every row is read
// once, two FMAs per element), far below the 295 FLOP/byte ridge.  Design:
// one CTA per (batch row, KV head) serves the G query heads of that group,
// so each K/V row is read from memory once per group, not once per query
// head.  A group wider than a CTA holds (8 heads at hd <= 128, 5 at hd 256,
// where the per-warp partial states fill the 48 KB of static shared memory
// and q and the accumulators the registers) is split evenly over CTAs on
// the grid's third dimension: recurrentgemma's 10 heads of 256 run as two
// CTAs of 5, each reading the K/V rows (the second read mostly from L2).
// The CTA's 8 warps stream disjoint runs of 4 or 8 cache rows each; a lane
// holds hd/32 elements of a row, so one warp reads one whole row per load
// instruction and keeps 8-16 row loads in flight.  Each warp keeps its own
// (m, l, acc) online-softmax state in registers; the 8 states merge
// through shared memory at the end, where the new token is folded in.
// Only rows below the row's valid length are visited.
//
// Layouts (element strides, innermost dimension contiguous):
//   q (B, Hq, hd); k/v (B, Hkv, C, hd); lens (B,) int32;
//   k_new/v_new (B, Hkv, hd) or null; slot_mask (B, C) uint8 or null;
//   out (B, Hq, hd).
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kWarps = 8;

struct DecodeArgs {
  const void* q; const void* k; const void* v; const int* lens;
  const void* k_new; const void* v_new; const uint8_t* slot_mask;
  void* out;
  long long q_sb, q_sh, k_sb, k_sh, k_sc, v_sb, v_sh, v_sc;
  long long kn_sb, kn_sh, vn_sb, vn_sh, sm_sb, o_sb, o_sh;
  int C, G, Gc;          // group size, query heads per CTA
  float scale;
};

// query heads one CTA serves at most, by head dim
__host__ __device__ constexpr int max_heads_per_cta(int hd) {
  return hd >= 256 ? 5 : 8;
}

template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const DecodeArgs a) {
  constexpr int EPL = HD / 32;                 // elements per lane
  constexpr int ROWS = (MAXG >= 8 || HD >= 256) ? 4 : 8;  // rows per step
  __shared__ float s_m[kWarps][MAXG];
  __shared__ float s_l[kWarps][MAXG];
  __shared__ float s_acc[kWarps][MAXG][HD];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g0 = blockIdx.z * a.Gc;            // this CTA's first head
  const int G = min(a.Gc, a.G - g0);           // and its number of heads
  const int hq0 = kvh * a.G + g0;              // query head of g = 0
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb
               + (long long)hq0 * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const uint8_t* sm = a.slot_mask ? a.slot_mask + b * a.sm_sb : nullptr;
  const int valid = min(max(a.lens[b], 0), a.C);

  float qr[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      load_vec<T, EPL>(q + g * a.q_sh + lane * EPL, qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = warp * ROWS; base < valid; base += kWarps * ROWS) {
    float kr[ROWS][EPL], vr[ROWS][EPL];
    bool ok[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = base + r;
      ok[r] = j < valid && (sm == nullptr || sm[j] != 0);
      if (ok[r]) {
        load_vec<T, EPL>(kb + j * a.k_sc + lane * EPL, kr[r]);
        load_vec<T, EPL>(vb + j * a.v_sc + lane * EPL, vr[r]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[r][e] = vr[r][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[ROWS];
      float mc = kNegInf;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[g][e] * kr[r][e];
        s[r] = warp_sum(part);
        if (ok[r]) mc = fmaxf(mc, s[r]);
      }
      const float mn = fmaxf(m[g], mc);
      const float corr = expf(m[g] - mn);
      float ps = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        s[r] = ok[r] ? expf(s[r] - mn) : 0.f;
        ps += s[r];
      }
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = acc[g][e] * corr;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) x += s[r] * vr[r][e];
        acc[g][e] = x;
      }
      m[g] = mn;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();

  // warp g merges the 8 partial states of query head g, folds the new
  // token and writes the output row
  for (int g = warp; g < G; g += kWarps) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w][g]);
    float L = 0.f, A[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) A[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - M);
      L += s_l[w][g] * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) A[e] += s_acc[w][g][lane * EPL + e] * c;
    }
    if (a.k_new != nullptr) {
      float qg[EPL], kn[EPL], vn[EPL];
      load_vec<T, EPL>(q + g * a.q_sh + lane * EPL, qg);
      load_vec<T, EPL>(static_cast<const T*>(a.k_new) + b * a.kn_sb
                       + kvh * a.kn_sh + lane * EPL, kn);
      load_vec<T, EPL>(static_cast<const T*>(a.v_new) + b * a.vn_sb
                       + kvh * a.vn_sh + lane * EPL, vn);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part += (qg[e] * a.scale) * kn[e];
      const float s_new = warp_sum(part);
      const float m2 = fmaxf(M, s_new);
      const float c = expf(M - m2);
      const float p_new = expf(s_new - m2);
      L = L * c + p_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) A[e] = A[e] * c + p_new * vn[e];
    }
    if (L == 0.f) L = 1.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) A[e] /= L;
    T* o = static_cast<T*>(a.out) + b * a.o_sb
           + (long long)(hq0 + g) * a.o_sh;
    store_vec<T, EPL>(o + lane * EPL, A);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(DecodeArgs a, int B, int Hkv, cudaStream_t stream) {
  constexpr int kMax = max_heads_per_cta(HD);
  const int n_cta = (a.G + kMax - 1) / kMax;   // CTAs per group
  a.Gc = (a.G + n_cta - 1) / n_cta;            // heads per CTA, even split
  const dim3 grid(Hkv, B, n_cta);
  const dim3 block(kWarps * 32);
  if (a.Gc <= 1) decode_attention_kernel<T, HD, 1><<<grid, block, 0, stream>>>(a);
  else if (a.Gc <= 2) decode_attention_kernel<T, HD, 2><<<grid, block, 0, stream>>>(a);
  else if (a.Gc <= 4) decode_attention_kernel<T, HD, 4><<<grid, block, 0, stream>>>(a);
  else decode_attention_kernel<T, HD, kMax><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const DecodeArgs& a, int B, int Hkv, int hd,
                     cudaStream_t stream) {
  if (hd == 64) return launch_hd<T, 64>(a, B, Hkv, stream);
  if (hd == 128) return launch_hd<T, 128>(a, B, Hkv, stream);
  if (hd == 256) return launch_hd<T, 256>(a, B, Hkv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pb_decode_attention(
    int dtype, int device, const void* q, const void* k, const void* v,
    const void* lens, const void* k_new, const void* v_new,
    const void* slot_mask, void* out, const long long* st, int B, int Hq,
    int Hkv, int C, int hd, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.lens = static_cast<const int*>(lens);
  a.k_new = k_new; a.v_new = v_new;
  a.slot_mask = static_cast<const uint8_t*>(slot_mask);
  a.out = out;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sb = st[2]; a.k_sh = st[3]; a.k_sc = st[4];
  a.v_sb = st[5]; a.v_sh = st[6]; a.v_sc = st[7];
  a.kn_sb = st[8]; a.kn_sh = st[9]; a.vn_sb = st[10]; a.vn_sh = st[11];
  a.sm_sb = st[12]; a.o_sb = st[13]; a.o_sh = st[14];
  a.C = C; a.G = Hq / Hkv; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, B, Hkv, hd, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, B, Hkv, hd, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* pb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
