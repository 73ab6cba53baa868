// Flash attention forward (prefill) for Hopper: online-softmax attention
// with a causal mask, a sliding window and a query offset, GQA by h / G.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  Semantics are the reference's:
// scores are q . k * scale in float32, masked keys weigh 0, a row with no
// valid key writes zeros.
//
// Bound on the H100: at the prefill shapes of the serving path (Sq = Sk <=
// 1024, hd 64, 128 or 256) the bytes of q, k, v and out and the bf16
// tensor-core time are of one order (a few microseconds), so the products
// must run on the tensor cores and the loads must overlap them.
//
// bf16 (the serving path): one warpgroup (128 threads) owns a 64-row query
// tile.  S = Q K^T is a wgmma with Q and a K tile of 64 keys (32 at hd
// 256, where the float32 output tile alone takes 128 registers a thread)
// both read from shared memory; the softmax runs on S in float32
// registers (the scale is applied to S, exact at hd 64 and 256 where it
// is a power of two), P is rounded to bf16 in registers and O += P V is a
// wgmma with P as the register A operand and V read MN-major from shared
// memory (transpose bit).  K/V tiles sit in a ring of stages (4 at hd 64
// and 256, 3 at 128) in dynamic shared memory, in the 128-byte swizzled
// layout wgmma reads (hopper.cuh), filled by 16-byte cp.async copies
// (zeros past Sk): tiles j+1 .. j+3 (or j+2) load while tile j is
// multiplied.  At hd 256 a CTA holds two such warpgroups, which take
// alternate key tiles of the query tile and merge their states at the end
// (the longest causal tile's walk is halved), a 32 KB Q tile and a 4-stage
// ring of 128 KB.  Query tiles are ordered longest first over the
// grid (the last causal tile is scheduled first), so the last wave is not
// one SM walking every key.  The output tile is staged in the Q tile's
// shared memory and written with 16-byte stores.
//
// float32 (not on the serving path; the tests hold it to 2e-5, which TF32
// cannot give): the products stay on the CUDA cores in full float32.  TPR
// threads share a query row (two at hd 64 and 128, four at hd 256) and
// each keeps hd / TPR dimensions of q * scale and of the accumulator in
// registers; K/V tiles of at least 16 keys are staged in shared memory and
// read as broadcasts.
//
// Both: key tiles that the causal mask or the window hides from every
// query of the tile are never loaded; the ragged edges (Sq, Sk not
// multiples of the tiles) are masked in the kernel, so nothing is padded
// or copied.
//
// Layouts (element strides, innermost dimension contiguous):
//   q (B, Hq, Sq, hd); k/v (B, Hkv, Sk, hd); out (B, Hq, Sq, hd).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace pb;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kChunk = 16;     // keys per online-softmax update (float32)
constexpr int kTcThreads = 128;  // threads of a warpgroup (bf16)

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

cudaError_t launch_f32(const FlashArgs& a, int B, int Hq, int hd,
                       cudaStream_t stream) {
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, Hq, B);
  if (hd == 64)
    flash_attention_kernel<float, 64><<<grid, kBQ * threads_per_row(64), 0,
                                        stream>>>(a);
  else if (hd == 128)
    flash_attention_kernel<float, 128><<<grid, kBQ * threads_per_row(128),
                                         0, stream>>>(a);
  else if (hd == 256)
    flash_attention_kernel<float, 256><<<grid, kBQ * threads_per_row(256),
                                         0, stream>>>(a);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma products over a cp.async ring of K/V tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// keys per K/V tile: 64, or 32 at hd 256, where the 64 x 256 float32
// output tile alone takes 128 registers a thread.  At hd 256 a CTA holds
// two consumer warpgroups that take alternate key tiles of the same query
// tile (each its own online softmax; the two merge at the end), which
// halves the serial walk of the longest causal tile: at recurrentgemma's
// prefill (B 1, 10 heads) there are only 80 query tiles for 132 SMs.
template <int HD>
struct TcTile {
  static constexpr int BK = HD >= 256 ? 32 : 64;
  static constexpr int NWG = HD >= 256 ? 2 : 1;    // consumer warpgroups
  static constexpr int THREADS = NWG * kTcThreads;
  static constexpr int NS = HD == 64 ? 4 : HD == 128 ? 3 : 4;  // stages
  static constexpr uint32_t Q = kBQ * HD * 2;      // bytes of the Q tile
  static constexpr uint32_t KV = BK * HD * 2;      // one K or V tile
  static constexpr uint32_t SMEM = Q + NS * 2 * KV + 1024;  // + alignment
  static_assert(NS > NWG, "a tile in flight beyond those multiplied");
};

// cp.async rows r0 .. r0 + ROWS - 1 of a (n x HD) strided bf16 matrix into
// an SW128 tile at dst; rows at or past n are zeros
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int r0, int n,
                                          int tid) {
  constexpr int CPR = HD / 8;                      // 16-byte chunks a row
  static_assert(ROWS * CPR % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
    const int i = it * THREADS + tid, r = i / CPR, c = i % CPR;
    const int row = r0 + r;
    const bool ok = row < n;
    cp_async16(dst + sw128(r, c, ROWS),
               src + (long long)(ok ? row : 0) * stride + c * 8, ok);
  }
}

// S = A B for one 16-dim slice: N = BK
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64) wgmma_ss_m64n64k16(s, da, db, scale_d);
  else wgmma_ss_m64n32k16(s, da, db, scale_d);
}

// O += P V for one 16-key slice: N = HD
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_m64n64k16(o, p, db, 1);
  else if constexpr (HD == 128) wgmma_rs_m64n128k16(o, p, db, 1);
  else wgmma_rs_m64n256k16(o, p, db, 1);
}

template <int HD>
__global__ void __launch_bounds__(TcTile<HD>::THREADS, 1)
flash_bf16_kernel(const FlashArgs a) {
  using SM = TcTile<HD>;
  constexpr int kBK = SM::BK, NWG = SM::NWG, THREADS = SM::THREADS;
  static_assert(kBQ == 64, "one wgmma M of 64");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;      // swizzle-aligned
  const uint32_t sKV = sQ + SM::Q;                 // stage s: K, then V
  uint8_t* const q_tile = smem_raw + (sQ - raw);   // generic view of sQ

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;       // longest tiles first
  const int kvh = h / a.G;
  const int tid = threadIdx.x, wg = tid / kTcThreads;
  const int wt = tid % kTcThreads, warp = wt >> 5, lane = tid & 31;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb
                   + kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb
                   + kvh * a.v_sh;
  const int q0 = qb * kBQ;

  // keys any query of this tile can see
  const int q_first = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q_first - a.window + 1);
  k_begin = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK
                                      : 0;

  // the ring: tile j in stage j % NS, one commit group a tile (empty past
  // the last); NWG tiles are multiplied at a time (tile t + w by
  // warpgroup w) while the next NS - NWG load
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const uint32_t sK = sKV + (j % SM::NS) * 2 * SM::KV;
      load_tile<kBK, HD, THREADS>(sK, kg, a.k_ss, k_begin + j * kBK, a.Sk,
                                  tid);
      load_tile<kBK, HD, THREADS>(sK + SM::KV, vg, a.v_ss, k_begin + j * kBK,
                                  a.Sk, tid);
    }
    cp_async_commit();
  };
  load_tile<kBQ, HD, THREADS>(sQ, qg, a.q_ss, q0, a.Sq, tid);  // tile 0's group
#pragma unroll
  for (int j = 0; j < SM::NS - NWG; ++j) issue(j);

  // accumulator fragments: thread rows rl (j = 0, 1 of each 4) and rl + 8
  // (j = 2, 3), columns 8 i + cb + (j & 1)
  const int rl = warp * 16 + (lane >> 2), cb = 2 * (lane & 3);
  float o[HD / 2], s[kBK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int qpos[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rok[r] = q0 + rl + 8 * r < a.Sq;
    qpos[r] = a.q_offset + q0 + rl + 8 * r;
  }
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units

  for (int t0 = 0; t0 < n_tiles; t0 += NWG) {
#pragma unroll
    for (int w = 0; w < NWG; ++w) issue(t0 + SM::NS - NWG + w);  // freed
    cp_async_wait<SM::NS - NWG>();                  // tiles t0.. landed
    fence_proxy_async();
    __syncthreads();
    const int t = t0 + wg;                          // this warpgroup's tile
    if (t < n_tiles) {
      const int k0 = k_begin + t * kBK;
      const uint32_t sK = sKV + (t % SM::NS) * 2 * SM::KV, sV = sK + SM::KV;

      // S = Q K^T: K-major A and B, 16 dims a step
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;         // 64-dim blocks: kk / 4
        wgmma_qk<kBK>(s,
                      sw128_desc(sQ + (kk >> 2) * kBQ * 128 + off, 16, 1024),
                      sw128_desc(sK + (kk >> 2) * kBK * 128 + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // mask only a tile that some (row, key) pair of it may not see
      const bool full = k0 + kBK <= a.Sk && q0 + kBQ <= a.Sq
                        && (!a.causal || k0 + kBK - 1 <= q_first)
                        && (a.window <= 0 || k0 > q_last - a.window);
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i * 4 + j] * sl2;
          if (!full) {
            const int kp = k0 + i * 8 + cb + (j & 1), qp = qpos[j >> 1];
            bool ok = rok[j >> 1] && kp < a.Sk;
            if (a.causal) ok = ok && kp <= qp;
            if (a.window > 0) ok = ok && kp > qp - a.window;
            if (!ok) x = minus_inf();
          }
          s[i * 4 + j] = x;
        }
      }
      // online softmax per row; a quad of lanes shares a row
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = minus_inf();
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
          mx = fmaxf(mx, fmaxf(s[i * 4 + 2 * r], s[i * 4 + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        corr[r] = exp2f(m[r] - mn);
        m[r] = mn;
        float ps = 0.f;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[i * 4 + 2 * r + e] - mn);
            s[i * 4 + 2 * r + e] = p;
            ps += p;
          }
        }
        l[r] = l[r] * corr[r] + ps;                 // this lane's share
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        o[i * 4 + 0] *= corr[0];
        o[i * 4 + 1] *= corr[0];
        o[i * 4 + 2] *= corr[1];
        o[i * 4 + 3] *= corr[1];
      }
      // P in bf16 as the A fragments of the 16-key slices
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P V: V MN-major, 16 keys (two 8-row groups of 1 KB) a step;
      // its 64-column blocks lie kBK * 128 bytes apart
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk], sw128_desc(sV + kk * 2048, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();                                // stages t0.. are free
  }
  cp_async_wait<0>();
  __syncthreads();                                  // the ring and Q free

  if constexpr (NWG == 2) {
    // warpgroup 1 hands its state to warpgroup 0 through the ring's shared
    // memory (element i of thread wt at i * 128 + wt: no bank conflicts)
    float* xs = reinterpret_cast<float*>(smem_raw + (sKV - raw));
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) xs[i * kTcThreads + wt] = o[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xs[(HD / 2 + r) * kTcThreads + wt] = m[r];
        xs[(HD / 2 + 2 + r) * kTcThreads + wt] = l[r];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xs[(HD / 2 + r) * kTcThreads + wt];
        const float mn = fmaxf(m[r], m1);
        const float c0 = exp2f(m[r] - mn), c1 = exp2f(m1 - mn);
        l[r] = l[r] * c0 + xs[(HD / 2 + 2 + r) * kTcThreads + wt] * c1;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = i * 4 + 2 * r + e;
            o[k] = o[k] * c0 + xs[k * kTcThreads + wt] * c1;
          }
        }
      }
    }
  }
  if (wg == 0) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float L = l[r];
      L += __shfl_xor_sync(0xffffffffu, L, 1);
      L += __shfl_xor_sync(0xffffffffu, L, 2);
      inv[r] = 1.f / (L == 0.f ? 1.f : L);
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = sw128(rl + 8 * r, i, kBQ) + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(q_tile + off) = pack_bf16x2(
            o[i * 4 + 2 * r] * inv[r], o[i * 4 + 2 * r + 1] * inv[r]);
      }
    }
  }
  __syncthreads();
  bf16* og = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int it = 0; it < kBQ * CPR / THREADS; ++it) {
    const int i = it * THREADS + tid, r = i / CPR, c = i % CPR;
    if (q0 + r < a.Sq)
      *reinterpret_cast<uint4*>(og + (long long)(q0 + r) * a.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(q_tile + sw128(r, c, kBQ));
  }
}

template <int HD>
cudaError_t launch_bf16_hd(const FlashArgs& a, int B, int Hq,
                           cudaStream_t stream) {
  constexpr int bytes = TcTile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (a.Sq + kBQ - 1) / kBQ);
  flash_bf16_kernel<HD><<<grid, TcTile<HD>::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const FlashArgs& a, int B, int Hq, int hd,
                        cudaStream_t stream) {
  if (hd == 64) return launch_bf16_hd<64>(a, B, Hq, stream);
  if (hd == 128) return launch_bf16_hd<128>(a, B, Hq, stream);
  if (hd == 256) return launch_bf16_hd<256>(a, B, Hq, stream);
  return cudaErrorInvalidValue;
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
  if (dtype == kDtypeBF16) return launch_bf16(a, B, Hq, hd, s);
  if (dtype == kDtypeF32) return launch_f32(a, B, Hq, hd, s);
  return cudaErrorInvalidValue;
}
