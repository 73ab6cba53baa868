// Decode attention for Hopper: one query token per (batch row, query head)
// against a KV cache, masked by per-row valid lengths and an optional
// per-slot mask, with the current token's K/V folded in after the cache
// (zero-copy decode).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  Semantics are the reference's:
// scores use q * scale in float32; masked slots weigh 0; the new token
// merges as one more online-softmax partial; rows with no valid key write
// zeros.
//
// Bound on the H100: the bytes of the valid K/V rows (every row is read
// once, about 2 G FLOP per bf16 element, far below the 295 FLOP/byte
// ridge), and at the serving shapes (a few MB) the latency of a pass over
// them.  Design: split-K over the cache in two launches on the caller's
// stream.
//
// 1. Partial kernel, grid (split, KV head, batch row): a CTA of 4 warps
//    takes the contiguous cache rows [s R, (s + 1) R) (R = ceil(C /
//    splits)) cut at the row's valid length, which it reads itself, for
//    all G <= 16 query heads of its KV head, so each K/V row is read once
//    per group.  K/V tiles stream through a ring of stages in shared
//    memory filled by 16-byte cp.async copies (later tiles load while one
//    is used; an empty range loads nothing and returns m = -1e30, l = 0).
//    bf16: the products run on the tensor cores (mma.sync m16n8k16, the G
//    query heads padded to the 16 rows of the tile): a warp takes chunks
//    of 16 cache rows, S = Q K^T and O += P V with P rounded to bf16 in
//    registers, Q, K and V read with ldmatrix from 128-byte-swizzled tiles
//    (V transposed), an online softmax per head in float32; the 4 warps'
//    states merge in warp order through shared memory.  float32 (not on
//    the serving path; the tests hold it to 2e-5, which TF32 cannot give):
//    the products stay on the CUDA cores in full float32; a lane holds 16
//    bytes (32 at hd 256) of a row, so a score is its slice's dot product
//    and log2(lanes per row) shuffles; the 4 warps split the group's
//    heads (a group of 1-3 leaves warps idle), the rows of a tile are
//    scored first (independent shuffles), then each head's state is
//    rescaled once and the V rows are added.  Either way one partial (m,
//    l, acc) per (row, query head, split) goes to a float32 workspace the
//    wrapper allocates.
// 2. Merge kernel, grid (query head, batch row, 128-element slice):
//    combines the splits in split order with no atomics (a result does
//    not change between runs), folds k_new / v_new as one more partial,
//    writes zeros where no key was valid, and writes out.  It is launched
//    as a programmatic dependent of the partial kernel: it loads the
//    fold's inputs while the partial kernel finishes and waits for its
//    results (griddepcontrol) before reading them.
//
// Layouts (element strides, innermost dimension contiguous):
//   q (B, Hq, hd); k/v (B, Hkv, C, hd); lens (B,) int32;
//   k_new/v_new (B, Hkv, hd) or null; slot_mask (B, C) uint8 or null;
//   out (B, Hq, hd); workspace float32: acc (B, Hq, splits, hd), then
//   (m, l) (B, Hq, splits, 2).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace pb;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 8192;     // float32: K (and V) bytes of a stage
constexpr int kStages = 4;           // float32: stages of the cp.async ring
constexpr int kMaxSplits = 1024;     // the wrapper's cap (decode_splits)
constexpr int kMaxGroup = 16;        // query heads a KV head: one mma M
constexpr int kMergeBatch = 32;      // splits the merge loads at a time

struct DecodeArgs {
  const void* q; const void* k; const void* v; const int* lens;
  const void* k_new; const void* v_new; const uint8_t* slot_mask;
  void* out; float* ws_acc; float* ws_ml;
  long long q_sb, q_sh, k_sb, k_sh, k_sc, v_sb, v_sh, v_sc;
  long long kn_sb, kn_sh, vn_sb, vn_sh, sm_sb, o_sb, o_sh;
  int C, G, Hq, splits;
  float scale;
};

// the float32 kernel's lanes and tiles
template <typename T, int HD>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);          // per 16 B
  static constexpr int EPL = HD / 32 > VEC ? HD / 32 : VEC;  // per lane
  static constexpr int LPR = HD / EPL;                      // lanes a row
  static constexpr int RPW = 32 / LPR;                      // rows a warp
  static constexpr int ROW_BYTES = HD * (int)sizeof(T);
  static constexpr int TR = kTileBytes / ROW_BYTES;         // rows a tile
  static_assert(LPR <= 32 && TR % RPW == 0, "tile geometry");
};

// merge online-softmax state (m2, l2, a2) into (m, l, a)
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&a)[N],
                                            float m2, float l2,
                                            const float (&a2)[N]) {
  const float mn = fmaxf(m, m2);
  const float c1 = expf(m - mn), c2 = expf(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * c1 + a2[e] * c2;
  m = mn;
}

template <typename T, int HD, int HPW>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const DecodeArgs a) {
  grid_dependents_launch();
  using Gm = Geo<T, HD>;
  constexpr int EPL = Gm::EPL, LPR = Gm::LPR, RPW = Gm::RPW;
  constexpr int RB = Gm::ROW_BYTES, TR = Gm::TR, CPR = RB / 16;
  constexpr int STEPS = TR / RPW;          // row steps of a warp in a tile
  extern __shared__ __align__(128) uint8_t s_kv[];  // stage s: K, then V
  __shared__ bool s_ok[kStages][TR];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp w scores heads w, w + 4, ... on every row of the tile; lane
  // group lg of the warp takes row lg of each step
  const int lg = lane / LPR, c = lane % LPR;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const uint8_t* sm = a.slot_mask ? a.slot_mask + b * a.sm_sb : nullptr;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb
                + (long long)kvh * a.G * a.q_sh;

  // q is loaded before lens is read, so the two loads are in flight
  // together
  float qr[HPW][EPL], acc[HPW][EPL], m[HPW], l[HPW];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int g = warp + h * kWarps;
    if (g < a.G) {
      load_vec<T, EPL>(qb + g * a.q_sh + c * EPL, qr[h]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[h][e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[h][e] = 0.f;
    }
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
  }

  const int R = (a.C + a.splits - 1) / a.splits;
  const int lo = split * R;
  const int hi = min(min(lo + R, a.C), max(a.lens[b], 0));
  const long long part0 = ((long long)b * a.Hq + (long long)kvh * a.G)
                          * a.splits + split;   // partial of head g: + g S
  if (lo >= hi) {                                // past the valid length
    for (int g = tid; g < a.G; g += kThreads) {
      a.ws_ml[2 * (part0 + (long long)g * a.splits)] = kNegInf;
      a.ws_ml[2 * (part0 + (long long)g * a.splits) + 1] = 0.f;
    }
    return;
  }

  const int n_tiles = (hi - lo + TR - 1) / TR;
  auto stage_k = [&](int t) { return s_kv + (t % kStages) * 2 * kTileBytes; };
  auto issue = [&](int t) {                     // cp.async tile t, if any
    if (t < n_tiles) {
      const int r0 = lo + t * TR, n = min(TR, hi - r0);
      const uint32_t dk = smem_u32(stage_k(t)), dv = dk + kTileBytes;
      for (int i = tid; i < n * CPR; i += kThreads) {
        const int r = i / CPR, cc = i % CPR;
        cp_async16(dk + r * RB + cc * 16,
                   kb + (long long)(r0 + r) * a.k_sc + cc * Gm::VEC);
        cp_async16(dv + r * RB + cc * 16,
                   vb + (long long)(r0 + r) * a.v_sc + cc * Gm::VEC);
      }
    }
    cp_async_commit();                          // empty past the last tile
  };
  auto ok_of = [&](int t, int r) {              // row r of tile t is valid
    const int j = lo + t * TR + r;
    return j < hi && (sm == nullptr || sm[j] != 0);
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t)
    if (tid < TR) s_ok[t][tid] = ok_of(t, tid);
  const bool active = warp < a.G;               // a group of 1-3: idle warps
  for (int t = 0; t < n_tiles; ++t) {
    const int tn = t + kStages - 1;             // the tile loaded now
    issue(tn);
    const bool ok_next = tn < n_tiles && tid < TR && ok_of(tn, tid);
    cp_async_wait<kStages - 1>();               // tile t has landed
    __syncthreads();
    const uint8_t* ks = stage_k(t);
    const uint8_t* vs = ks + kTileBytes;
    const bool* okt = s_ok[t % kStages];
    const int rows = min(TR, hi - lo - t * TR);
    // the scores of all the tile's rows for this warp's heads first (each
    // K row read once for them; the rows are independent, so their
    // shuffles overlap), one rescale of each head's state, then the V rows
    if (active) {
      float sc[STEPS][HPW];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = st * RPW + lg;
        float kf[EPL];
        if (st * RPW < rows)                      // uniform over the warp
          load_vec<T, EPL>(reinterpret_cast<const T*>(ks + r * RB) + c * EPL,
                           kf);
        const bool ok = r < rows && okt[r];
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          float x = 0.f;
          if (st * RPW < rows) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) x += qr[h][e] * kf[e];
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1)
              x += __shfl_xor_sync(0xffffffffu, x, off);
          }
          sc[st][h] = ok ? x : minus_inf();
        }
      }
      float mn[HPW];
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        float mx = minus_inf();
#pragma unroll
        for (int st = 0; st < STEPS; ++st) mx = fmaxf(mx, sc[st][h]);
        mn[h] = fmaxf(m[h], mx);
        const float corr = expf(m[h] - mn[h]);
        m[h] = mn[h];
        l[h] *= corr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] *= corr;
      }
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = st * RPW + lg;
        if (!(r < rows && okt[r])) continue;    // uniform over the row
        float vf[EPL];
        load_vec<T, EPL>(reinterpret_cast<const T*>(vs + r * RB) + c * EPL,
                         vf);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          const float p = expf(sc[st][h] - mn[h]);
          l[h] += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[h][e] += p * vf[e];
        }
      }
    }
    if (tn < n_tiles && tid < TR) s_ok[tn % kStages][tid] = ok_next;
    __syncthreads();                            // stage t is free
  }

  // lane groups of a warp hold the same heads: merge them
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      float a2[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        a2[e] = __shfl_xor_sync(0xffffffffu, acc[h][e], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[h], off);
      merge_state(m[h], l[h], acc[h], m2, l2, a2);
    }
  }
  if (lg != 0) return;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int g = warp + h * kWarps;
    if (g >= a.G) break;
    const long long p = part0 + (long long)g * a.splits;
    float* dst = a.ws_acc + p * HD + c * EPL;
#pragma unroll
    for (int e = 0; e < EPL; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(acc[h][e], acc[h][e + 1], acc[h][e + 2], acc[h][e + 3]);
    if (c == 0) {
      a.ws_ml[2 * p] = m[h];
      a.ws_ml[2 * p + 1] = l[h];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int HD>
struct MmaGeo {
  static constexpr int TR = HD >= 256 ? 32 : 64;   // rows a tile
  static constexpr int NS = HD == 64 ? 4 : 3;       // most stages
  static constexpr int TILE = TR * HD * 2;          // bytes of a K (V) tile
  static constexpr int QB = 16 * HD * 2;            // the Q tile, 16 rows
  static constexpr int RED = kWarps * (16 * HD + 32) * 4;  // warp states
};

// A warp's online softmax over one chunk of 16 cache rows for the G <= 16
// query heads of its KV head, padded to the 16 rows of an mma tile: S =
// Q K^T (HD / 16 k-steps, two n-tiles of 8 keys), P = exp(S - m) rounded to
// bf16 in registers as the A operand of O += P V (HD / 8 n-tiles).  Q, K
// and V are SW128 tiles in shared memory, read with ldmatrix (V
// transposed).  Thread (g8, t4) of the warp holds rows g8 and g8 + 8;
// scores are in log2 units.
template <int HD, int TR>
__device__ __forceinline__ void mma_chunk(
    float (&o)[HD / 8][4], float (&m)[2], float (&l)[2], uint32_t sQ,
    uint32_t sK, uint32_t sV, const bool* okt, int kb0, int rows,
    float sl2, int lane) {
  const int mat = lane >> 3, r8 = lane & 7, t4 = lane & 3;
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t qa[4], kf[4];
    ldmatrix_x4(qa, sQ + sw128(r8 + (mat & 1) * 8, kk * 2 + (mat >> 1), 16));
    ldmatrix_x4(kf, sK + sw128(kb0 + r8 + (mat >> 1) * 8, kk * 2 + (mat & 1),
                               TR));
    mma_bf16_16816(s[0], qa, kf[0], kf[1]);
    mma_bf16_16816(s[1], qa, kf[2], kf[3]);
  }
  float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb0 + j * 8 + 2 * t4 + (e & 1);
      const bool ok = key < rows && okt[key];
      s[j][e] = ok ? s[j][e] * sl2 : minus_inf();
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - mn);
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);   // 0 for a masked key
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
  const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]),
                          pack_bf16x2(s[0][2], s[0][3]),
                          pack_bf16x2(s[1][0], s[1][1]),
                          pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
  for (int j = 0; j < HD / 8; j += 2) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, sV + sw128(kb0 + r8 + (mat & 1) * 8,
                                     j + (mat >> 1), TR));
    mma_bf16_16816(o[j], pa, vf[0], vf[1]);
    mma_bf16_16816(o[j + 1], pa, vf[2], vf[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_mma_kernel(const DecodeArgs a, int ns) {
  grid_dependents_launch();
  using Gm = MmaGeo<HD>;
  constexpr int TR = Gm::TR, CPR = HD / 8, CHUNKS = TR / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const uint32_t sQ = smem_u32(base);                  // SW128, 16 rows
  uint8_t* const stages = base + Gm::QB;              // stage: K, V
  __shared__ bool s_ok[Gm::NS][TR];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const uint8_t* sm = a.slot_mask ? a.slot_mask + b * a.sm_sb : nullptr;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb
                   + (long long)kvh * a.G * a.q_sh;

  // Q rows of the group (zeros past G) go out before lens is read
  for (int i = tid; i < 16 * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(sQ + sw128(r, c, 16), qb + (long long)(r < a.G ? r : 0) * a.q_sh
               + c * 8, r < a.G);
  }
  cp_async_commit();
  const int R = (a.C + a.splits - 1) / a.splits;
  const int lo = split * R;
  const int hi = min(min(lo + R, a.C), max(a.lens[b], 0));
  const long long part0 = ((long long)b * a.Hq + (long long)kvh * a.G)
                          * a.splits + split;   // partial of head g: + g S
  if (lo >= hi) {                                // past the valid length
    for (int g = tid; g < a.G; g += kThreads) {
      a.ws_ml[2 * (part0 + (long long)g * a.splits)] = kNegInf;
      a.ws_ml[2 * (part0 + (long long)g * a.splits) + 1] = 0.f;
    }
    cp_async_wait<0>();
    return;
  }

  const int n_tiles = (hi - lo + TR - 1) / TR;
  auto stage_k = [&](int t) {
    return smem_u32(stages) + (uint32_t)((t % ns) * 2 * Gm::TILE);
  };
  auto issue = [&](int t) {                     // tile t; zeros past hi
    const int r0 = lo + t * TR;
    const uint32_t dk = stage_k(t), dv = dk + Gm::TILE;
    for (int i = tid; i < TR * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r0 + r < hi;
      const long long row = ok ? r0 + r : lo;
      cp_async16(dk + sw128(r, c, TR), kb + row * a.k_sc + c * 8, ok);
      cp_async16(dv + sw128(r, c, TR), vb + row * a.v_sc + c * 8, ok);
    }
    cp_async_commit();
  };
  auto ok_of = [&](int t, int r) {              // row r of tile t is valid
    const int j = lo + t * TR + r;
    return j < hi && (sm == nullptr || sm[j] != 0);
  };

  const int ahead = min(ns - 1, n_tiles);       // tiles in flight ahead
  for (int t = 0; t < ahead; ++t) issue(t);
  for (int t = 0; t < ahead; ++t)
    if (tid < TR) s_ok[t][tid] = ok_of(t, tid);

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * 1.4426950408889634f;   // log2 units

  for (int t = 0; t < n_tiles; ++t) {
    const int tn = t + ns - 1;                  // the tile loaded now
    bool ok_next = false;
    if (tn < n_tiles) {
      issue(tn);
      ok_next = tid < TR && ok_of(tn, tid);
      if (tn == t && tid < TR) s_ok[0][tid] = ok_next;   // one stage
    }
    switch (min(ns - 1, n_tiles - 1 - t)) {     // tiles issued after t
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
    const int rows = min(TR, hi - lo - t * TR);
    // chunk c of the split goes to warp c % 4
#pragma unroll
    for (int ci = 0; ci < CHUNKS; ++ci) {
      if ((t * CHUNKS + ci) % kWarps != warp || ci * 16 >= rows) continue;
      mma_chunk<HD, TR>(o, m, l, sQ, stage_k(t), stage_k(t) + Gm::TILE,
                        s_ok[t % ns], ci * 16, rows, sl2, lane);
    }
    if (tn < n_tiles && tn > t && tid < TR) s_ok[tn % ns][tid] = ok_next;
    __syncthreads();                            // stage t is free
  }

  // the 4 warps' states merge through shared memory, in warp order
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* red = reinterpret_cast<float*>(stages);
  float* mine = red + warp * (16 * HD + 32);     // o (16, HD), m, l
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(mine + g8 * HD + j * 8 + 2 * t4) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(mine + (g8 + 8) * HD + j * 8 + 2 * t4) =
        make_float2(o[j][2], o[j][3]);
  }
  if (t4 == 0) {
    mine[16 * HD + g8] = m[0];
    mine[16 * HD + g8 + 8] = m[1];
    mine[16 * HD + 16 + g8] = l[0];
    mine[16 * HD + 16 + g8 + 8] = l[1];
  }
  __syncthreads();
  for (int i = tid; i < a.G * HD; i += kThreads) {
    const int row = i / HD, e = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = red + w * (16 * HD + 32) + 16 * HD;
      if (st[16 + row] > 0.f) M = fmaxf(M, st[row]);
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = red + w * (16 * HD + 32);
      const float lw = st[16 * HD + 16 + row];
      if (lw == 0.f) continue;
      const float c = exp2f(st[16 * HD + row] - M);
      L += lw * c;
      A += st[row * HD + e] * c;
    }
    const long long p = part0 + (long long)row * a.splits;
    a.ws_acc[p * HD + e] = A;
    if (e == 0) {                                // natural-log units
      a.ws_ml[2 * p] = M * 0.6931471805599453f;
      a.ws_ml[2 * p + 1] = L;
    }
  }
}

__device__ __forceinline__ float block_sum(float x, float* s_part) {
  x = warp_sum(x);
  __syncthreads();                                // s_part free
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_part[w];  // fixed order
  return t;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const DecodeArgs a) {
  constexpr int DOT = (HD + kThreads - 1) / kThreads;   // fold dot terms
  __shared__ float s_w[kMaxSplits];              // weight of split s
  __shared__ float s_l[kMaxSplits];
  __shared__ float s_part[kWarps];
  const int hq = blockIdx.x, b = blockIdx.y, kvh = hq / a.G;
  const int tid = threadIdx.x, S = a.splits;
  const int e = blockIdx.z * kThreads + tid;     // this thread's element
  const bool has_e = e < HD;
  const long long p0 = ((long long)b * a.Hq + hq) * S;
  const float* ml = a.ws_ml + 2 * p0;
  const float* acc = a.ws_acc + p0 * HD + e;
  const bool fold = a.k_new != nullptr;

  // the fold's inputs are the caller's: load them while the partial
  // kernel finishes (programmatic dependent launch), then wait for it
  float qd[DOT], kd[DOT], vn = 0.f;
#pragma unroll
  for (int i = 0; i < DOT; ++i) {
    const int d = tid + i * kThreads;
    qd[i] = kd[i] = 0.f;
    if (fold && d < HD) {
      qd[i] = to_float(static_cast<const T*>(a.q)[b * a.q_sb + hq * a.q_sh
                                                  + d]);
      kd[i] = to_float(static_cast<const T*>(a.k_new)[
          b * a.kn_sb + kvh * a.kn_sh + d]);
    }
  }
  if (fold && has_e)
    vn = to_float(static_cast<const T*>(a.v_new)[b * a.vn_sb + kvh * a.vn_sh
                                                 + e]);
  grid_dependency_wait();
  // the loads that do not depend on the weights go out first: the first
  // batch of partial accumulators, the (m, l) of every split
  float x[kMergeBatch];
#pragma unroll
  for (int u = 0; u < kMergeBatch; ++u)
    x[u] = u < S && has_e ? acc[(long long)u * HD] : 0.f;
  float M = kNegInf;
  for (int s = tid; s < S; s += kThreads) {
    const float2 v = reinterpret_cast<const float2*>(ml)[s];
    s_l[s] = v.y;
    s_w[s] = v.x;
    if (v.y > 0.f) M = fmaxf(M, v.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if ((tid & 31) == 0) s_part[tid >> 5] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_part[w]);
  for (int s = tid; s < S; s += kThreads)
    s_w[s] = s_l[s] > 0.f ? expf(s_w[s] - M) : 0.f;
  __syncthreads();

  // sum in split order, a batch of splits' loads in flight at a time; an
  // empty split (or one that weighs 0) is skipped
  float L = 0.f, A = 0.f;
  for (int s0 = 0; s0 < S; s0 += kMergeBatch) {
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        x[u] = s0 + u < S && has_e ? acc[(long long)(s0 + u) * HD] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const int s = s0 + u;
      if (s >= S || s_w[s] == 0.f) continue;
      L += s_l[s] * s_w[s];
      A += x[u] * s_w[s];
    }
  }

  if (fold) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < DOT; ++i) part += (qd[i] * a.scale) * kd[i];
    const float s_new = block_sum(part, s_part);
    const float m2 = fmaxf(M, s_new);
    const float c = expf(M - m2), p_new = expf(s_new - m2);
    L = L * c + p_new;
    A = A * c + p_new * vn;
  }
  if (has_e) {
    T* o = static_cast<T*>(a.out) + b * a.o_sb + hq * a.o_sh;
    o[e] = from_float<T>(A / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int HD, int HPW>
cudaError_t launch_partial(const DecodeArgs& a, int B, int Hkv,
                           cudaStream_t stream) {
  constexpr int bytes = kStages * 2 * kTileBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T, HD, HPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T, HD, HPW>
      <<<dim3(a.splits, Hkv, B), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_partial_mma(const DecodeArgs& a, int B, int Hkv,
                               cudaStream_t stream) {
  using Gm = MmaGeo<HD>;
  const int R = (a.C + a.splits - 1) / a.splits;
  const int ns = max(1, min(Gm::NS, (R + Gm::TR - 1) / Gm::TR));
  const int bytes = 128 + Gm::QB + max(ns * 2 * Gm::TILE, Gm::RED);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  decode_partial_mma_kernel<HD>
      <<<dim3(a.splits, Hkv, B), kThreads, bytes, stream>>>(a, ns);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const DecodeArgs& a, int B, int Hkv,
                      cudaStream_t stream) {
  cudaError_t err;
  const int hpw = (a.G + kWarps - 1) / kWarps;   // float32: heads a warp
  if (a.G > kMaxGroup) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) err = launch_partial_mma<HD>(a, B, Hkv, stream);
  else if (hpw <= 1) err = launch_partial<T, HD, 1>(a, B, Hkv, stream);
  else if (hpw <= 2) err = launch_partial<T, HD, 2>(a, B, Hkv, stream);
  else err = launch_partial<T, HD, 4>(a, B, Hkv, stream);
  if (err != cudaSuccess) return err;
  // the merge may start while the partial kernel's last CTAs run; it waits
  // for the partial kernel's results before it reads them
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hq, B, (HD + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, HD>, a);
  if (err != cudaSuccess) return err;
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
    const void* slot_mask, void* out, void* ws, const long long* st, int B,
    int Hq, int Hkv, int C, int hd, int splits, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (splits < 1 || splits > kMaxSplits || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.lens = static_cast<const int*>(lens);
  a.k_new = k_new; a.v_new = v_new;
  a.slot_mask = static_cast<const uint8_t*>(slot_mask);
  a.out = out;
  a.ws_acc = static_cast<float*>(ws);
  a.ws_ml = a.ws_acc + (long long)B * Hq * splits * hd;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sb = st[2]; a.k_sh = st[3]; a.k_sc = st[4];
  a.v_sb = st[5]; a.v_sh = st[6]; a.v_sc = st[7];
  a.kn_sb = st[8]; a.kn_sh = st[9]; a.vn_sb = st[10]; a.vn_sh = st[11];
  a.sm_sb = st[12]; a.o_sb = st[13]; a.o_sh = st[14];
  a.C = C; a.G = Hq / Hkv; a.Hq = Hq; a.splits = splits; a.scale = scale;
  if (B <= 0 || Hq <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, B, Hkv, hd, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, B, Hkv, hd, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* pb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
