// Mamba-2 SSD chunked scan (state-space duality) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel).  Semantics are the reference's: per chunk of rows,
//   cum   = cumsum(dt * A)                       (within the chunk)
//   G     = (C B^T) o exp(cum_q - cum_k) o dt_k,  q >= k, else 0
//   y     = G x + exp(cum_q) * C state^T
//   state = exp(cum_last) * state + sum_k exp(cum_last - cum_k) dt_k x_k B_k^T
// with the (P, N) float32 state carried from chunk to chunk, starting from
// an initial state (or zeros); returns y and the final state.  All sums are
// float32.
//
// Bound on the H100: at a serving prefill (B = 1, S = 512, H = 48, P = 64,
// N = 128, bf16) the bytes (x, y, B, C, dt, the final state: about 8 MB)
// bound it, at a few microseconds; the products are about 1 GFLOP.
//
// Design: the chunked decomposition of [arXiv:2405.21060] section 6, run
// parallel over the chunks.  A chunk's work depends on the rest of the
// sequence only through the state entering it, and that state is a short
// linear recurrence over the chunks' own contributions.  Three launches on
// the caller's stream, chained as programmatic dependents (each may start
// while the one before finishes, and waits for its results before reading
// them):
// 1. Chunk states, grid (H * P/PB + 1, chunks, B), 4 warps for each 32
//    columns of the P-block PB.  CTA (h, PB columns of P) of a chunk
//    computes the chunk's contribution from a zero state, s_c = (x o w)^T B
//    with w_k = exp(cum_last - cum_k) dt_k (the exponent summed from the
//    chunk's end), a (PB x 64)(64 x N) product, into a float32 workspace,
//    and exp(cum_last).  The chunk's last CTA forms C B^T (64 x 64 over N,
//    the causal tiles only) once for all heads, since B and C have one
//    group; it goes to the workspace in float32.
// 2. State pass, grid (P N / 1024, H, B), 256 threads, 4 floats a thread.
//    Each thread walks the chunks in order from h0 (or zeros): it writes
//    the state entering chunk c over s_c, then S = exp(cum_last,c) S + s_c
//    (8 chunks' loads in flight at a time), and writes the final state.
// 3. Chunk outputs, grid (H * P/PB, chunks, B), each warp 16 rows of the
//    chunk and 32 columns of P.  Before it waits on launch 2 the CTA stages
//    its x and C tiles (cp.async) and the chunk's cumsum; then G = C B^T o
//    exp(cum_q - cum_k) o dt_k (only where q >= k, and only the key tiles
//    at or left of the warp's diagonal tile), y = G x + exp(cum_q) C S_in^T,
//    staged in shared memory for 16-byte stores.
// PB is 64 for bf16 where P allows it (mamba2-780m: 384 CTAs a launch at a
// 512-token prefill, one wave; each CTA re-reads the chunk's 16 KB B or C
// tile and C B^T, so half the CTAs read half as much), else 32; float32
// uses 32.
//
// Products.  bf16: on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulators; operands read with ldmatrix from shared rows
// padded by 16 bytes, so the 8 rows of an 8 x 8 matrix fall in distinct
// bank groups).  x, B and C are bf16 inputs and enter the products exactly.
// The other operand of three products is float32: x o w (chunk states),
// G (G x) and the entering state S_in (C S_in^T).  Rounding it to bf16
// would put an error of about 2^-9 of each term into y, as large as the
// output's own rounding, which the bf16 limit of the tests cannot absorb
// as well; so it is split into a bf16 high part and a bf16 low part (the
// rounding residue) and both go through the tensor cores: two products
// instead of one, with a relative error near 2^-17.  C B^T has two bf16
// operands and runs once.  float32 (not on the serving path; the tests
// hold it to 2e-5 of max |y|, which TF32 or split bf16 cannot promise):
// the same three launches with the products on the CUDA cores in full
// float32.  The state is float32 throughout.
//
// A short last chunk is staged with zero rows and dt = 0, an exact no-op on
// the recurrence; its rows past S are never stored.  S = 0 runs the state
// pass alone (final state = h0 or zeros).
//
// Layouts (element strides, innermost dimension contiguous):
//   x (B, S, H, P) and y (B, S, H, P) in T; dt (B, S, H) float32;
//   A (H,) float32 (negative); Bm, Cm (B, S, N) in T;
//   state and the optional initial state h0 (B, H, P, N) float32,
//   contiguous; workspace float32: chunk states (B, chunks, H, P, N), then
//   C B^T (B, chunks, 64, 64), then exp(cum_last) (B, chunks, H).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace pb;
using bf16 = __nv_bfloat16;

constexpr int kQ = 64;              // rows per chunk
constexpr int kPBF = 32;            // float32: columns of P per CTA
constexpr int kNMax = 128;          // largest state size N
constexpr int kThreadsF = 128;      // float32 chunk kernels: 4 warps
constexpr int kPassThreads = 256;   // state pass
constexpr int kPassElems = kPassThreads * 4;
constexpr int kPassBatch = 8;       // chunks whose loads are in flight
constexpr int kNPitch = kNMax * 2 + 16;    // bf16 B, C and state rows (bytes)

// The bf16 chunk kernels for PB (32 or 64) columns of P a CTA: 4 warps for
// each 32 columns.  Tile rows are padded by 16 bytes.
template <int PB>
struct Mma {
  static constexpr int kWarps = 4 * PB / 32;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kXPitch = PB * 2 + 16;     // x and y tile rows
  // launch 1 (bytes): the B tile, then the x or the C tile, then w
  static constexpr int kOffXC1 = kQ * kNPitch;
  static constexpr int kOffV1 = kOffXC1 + kQ * kNPitch;
  static constexpr int kSmem1 = kOffV1 + kQ * 4;
  // launch 3 (bytes): x, C, S_in high and low parts, y, then dt, cum and
  // exp(cum)
  static constexpr int kOffC3 = kQ * kXPitch;
  static constexpr int kOffSh3 = kOffC3 + kQ * kNPitch;
  static constexpr int kOffSl3 = kOffSh3 + PB * kNPitch;
  static constexpr int kOffY3 = kOffSl3 + PB * kNPitch;
  static constexpr int kOffV3 = kOffY3 + kQ * kXPitch;
  static constexpr int kSmem3 = kOffV3 + 3 * kQ * 4;
};
// float32 tiles (floats): B, C and state rows padded to an odd length
constexpr int kFPitch = kNMax + 1;
constexpr int kGPitch = kQ + 1;
constexpr int kSmem1F = (2 * kQ * kFPitch + kQ) * 4;
constexpr int kOffC3F = kQ * kPBF;
constexpr int kOffS3F = kOffC3F + kQ * kFPitch;
constexpr int kOffG3F = kOffS3F + kPBF * kFPitch;
constexpr int kOffV3F = kOffG3F + kQ * kGPitch;
constexpr int kSmem3F = (kOffV3F + 3 * kQ) * 4;

struct SsdArgs {
  const void* x; const float* dt; const float* A; const void* Bm;
  const void* Cm; void* y; float* state; const float* h0;
  float* ws_state; float* ws_cb; float* ws_dec;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh;
  int S, H, P, N, Np, nc, n_pb;    // n_pb: P-blocks a head
  bool vec;       // bf16 tiles may be copied 16 bytes at a time
};

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

// One warp's scans of dt * A over a chunk: lane l holds rows 2l, 2l + 1
// (dt = 0 past `rows`): the prefix sums c (cum), the suffix sums after
// each row s (cum_last - cum_k, summed from the chunk's end, so that the
// weight of the last valid row is exp(0) exactly and those of the rows
// before it carry no rounding of the large cum values), and `last`, the
// chunk's total.
struct Cum2 { float dt0, dt1, c0, c1, s0, s1, last; };

__device__ __forceinline__ Cum2 chunk_cumsum(const float* dtb,
                                             long long dt_ss, int rows,
                                             float A_h) {
  const int lane = threadIdx.x & 31;
  Cum2 r;
  r.dt0 = 2 * lane < rows ? dtb[(long long)(2 * lane) * dt_ss] : 0.f;
  r.dt1 = 2 * lane + 1 < rows ? dtb[(long long)(2 * lane + 1) * dt_ss] : 0.f;
  const float d0 = r.dt0 * A_h, d1 = r.dt1 * A_h;
  float s = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  r.c0 = excl + d0;
  r.c1 = s;
  r.last = __shfl_sync(0xffffffffu, s, 31);
  float t = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, t, o);
    if (lane + o < 32) t += v;
  }
  float after = __shfl_down_sync(0xffffffffu, t, 1);
  if (lane == 31) after = 0.f;
  r.s1 = after;
  r.s0 = after + d1;
  return r;
}

// The chunk's 64 rows of a row-strided bf16 matrix into shared memory at
// `pitch` bytes a row: `cols` columns (a multiple of 8), rows >= `valid`
// and columns >= `cols_valid` as zeros.  vec: 16-byte cp.async copies (the
// caller commits and waits; every 16-byte piece is aligned and cols_valid
// % 8 == 0); else element copies.
__device__ __forceinline__ void stage_bf16(uint8_t* dst, int pitch,
                                           const bf16* src, long long rs,
                                           int valid, int cols,
                                           int cols_valid, bool vec) {
  if (vec) {
    const int cpr = cols / 8;
    for (int i = threadIdx.x; i < kQ * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < valid && c * 8 < cols_valid;
      cp_async16(smem_u32(dst + r * pitch + c * 16),
                 ok ? src + r * rs + c * 8 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kQ * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      *reinterpret_cast<bf16*>(dst + r * pitch + c * 2) =
          r < valid && c < cols_valid ? src[r * rs + c]
                                      : __float2bfloat16_rn(0.f);
    }
  }
}

// The same for float32 tiles, element by element, `pitch` floats a row.
__device__ __forceinline__ void stage_f32(float* dst, int pitch,
                                          const float* src, long long rs,
                                          int valid, int cols) {
  for (int i = threadIdx.x; i < kQ * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[r * pitch + c] = r < valid ? src[r * rs + c] : 0.f;
  }
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  return __bfloat1622float2(h);
}

// (v0, v1) as bf16 high parts and bf16 low parts (the rounding residue):
// hi + lo carries about 16 bits of each value
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16x2(v0, v1);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(v0 - h.x, v1 - h.y);
}

// columns n, n + 1 (n even) of a row of N floats
__device__ __forceinline__ void store_pair(float* dst, int n, int N, float v0,
                                           float v1) {
  if (N % 2 == 0 && n < N) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    if (n < N) dst[0] = v0;
    if (n + 1 < N) dst[1] = v1;
  }
}

__device__ __forceinline__ long long ws_state_off(const SsdArgs& a, int b,
                                                  int c, int h, int p0) {
  return ((((long long)b * a.nc + c) * a.H + h) * a.P + p0) * a.N;
}

// ---------------------------------------------------------------------------
// launch 1: chunk states from zero (and C B^T, once a chunk)
// ---------------------------------------------------------------------------

template <int PB>
__global__ void __launch_bounds__(Mma<PB>::kThreads)
ssd_chunk_state_mma_kernel(const SsdArgs a) {
  using G = Mma<PB>;
  grid_dependents_launch();
  extern __shared__ __align__(128) uint8_t sm[];
  const int c = blockIdx.y, b = blockIdx.z, t0 = c * kQ;
  const int rows = min(kQ, a.S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, li = lane & 7, lj = lane >> 3;
  uint8_t* bs = sm;
  uint8_t* xc = sm + G::kOffXC1;
  const bf16* Bb = static_cast<const bf16*>(a.Bm) + b * a.b_sb + t0 * a.b_ss;
  stage_bf16(bs, kNPitch, Bb, a.b_ss, rows, a.Np, a.N, a.vec);

  if (blockIdx.x == a.H * a.n_pb) {
    // ---- C B^T [q][j]: warp w < 4 takes rows 16w.. and the key tiles
    //      j < 16(w + 1) (the causal ones) ----
    const bf16* Cb = static_cast<const bf16*>(a.Cm) + b * a.c_sb
                     + t0 * a.c_ss;
    stage_bf16(xc, kNPitch, Cb, a.c_ss, rows, a.Np, a.N, a.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp >= 4) return;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int ks = 0; ks < a.Np / 16; ++ks) {
      uint32_t ra[4];
      ldmatrix_x4(ra, smem_u32(xc + (warp * 16 + (lj & 1) * 8 + li) * kNPitch
                               + (ks * 16 + (lj >> 1) * 8) * 2));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp > warp) break;
        uint32_t rb[4];
        ldmatrix_x4(rb, smem_u32(bs + (jp * 16 + (lj >> 1) * 8 + li) * kNPitch
                                 + (ks * 16 + (lj & 1) * 8) * 2));
        mma_bf16_16816(acc[2 * jp], ra, rb[0], rb[1]);
        mma_bf16_16816(acc[2 * jp + 1], ra, rb[2], rb[3]);
      }
    }
    float* cb = a.ws_cb + ((long long)b * a.nc + c) * kQ * kQ;
    const int q = warp * 16 + g;
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      if (jt >= 2 * warp + 2) break;
      const int j = jt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(cb + q * kQ + j) =
          make_float2(acc[jt][0], acc[jt][1]);
      *reinterpret_cast<float2*>(cb + (q + 8) * kQ + j) =
          make_float2(acc[jt][2], acc[jt][3]);
    }
    return;
  }

  const int h = blockIdx.x / a.n_pb, p0 = (blockIdx.x % a.n_pb) * PB;
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.x_sb + t0 * a.x_ss
                   + h * a.x_sh + p0;
  stage_bf16(xc, G::kXPitch, xb, a.x_ss, rows, PB, PB, a.vec);
  cp_async_commit();
  float* wv = reinterpret_cast<float*>(sm + G::kOffV1);
  if (warp == 0) {
    const Cum2 r = chunk_cumsum(a.dt + b * a.dt_sb + t0 * a.dt_ss
                                + h * a.dt_sh, a.dt_ss, rows, a.A[h]);
    wv[2 * lane] = expf(r.s0) * r.dt0;
    wv[2 * lane + 1] = expf(r.s1) * r.dt1;
    if (lane == 0 && p0 == 0)
      a.ws_dec[((long long)b * a.nc + c) * a.H + h] = expf(r.last);
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- s_c[p][n] = sum_k (x_k[p] w_k) B_k[n]: warp w takes the 16 rows
  //      of P at 16 (w % (PB / 16)) and the 64 state columns at
  //      64 (w / (PB / 16)) ----
  const int mt = warp % (PB / 16), nh = warp / (PB / 16);
  const int n_tiles = min(8, a.Np / 8 - nh * 8);   // even; may be <= 0
  if (n_tiles <= 0) return;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kQ / 16; ++ks) {
    uint32_t ra[4], ahi[4], alo[4];
    ldmatrix_x4_trans(ra, smem_u32(xc + (ks * 16 + (lj >> 1) * 8 + li)
                                   * G::kXPitch
                                   + (mt * 16 + (lj & 1) * 8) * 2));
    const int k = ks * 16 + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k + (e >> 1) * 8;
      const float2 xv = unpack_bf16x2(ra[e]);
      split_bf16x2(xv.x * wv[kk], xv.y * wv[kk + 1], ahi[e], alo[e]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= n_tiles) break;
      uint32_t rb[4];
      ldmatrix_x4_trans(rb, smem_u32(bs + (ks * 16 + (lj & 1) * 8 + li)
                                     * kNPitch
                                     + (nh * 64 + np * 16 + (lj >> 1) * 8)
                                     * 2));
      mma_bf16_16816(acc[2 * np], ahi, rb[0], rb[1]);
      mma_bf16_16816(acc[2 * np], alo, rb[0], rb[1]);
      mma_bf16_16816(acc[2 * np + 1], ahi, rb[2], rb[3]);
      mma_bf16_16816(acc[2 * np + 1], alo, rb[2], rb[3]);
    }
  }
  float* sc = a.ws_state + ws_state_off(a, b, c, h, p0);
  const int p = mt * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= n_tiles) break;
    const int n = nh * 64 + nt * 8 + 2 * tq;
    store_pair(sc + (long long)p * a.N + n, n, a.N, acc[nt][0], acc[nt][1]);
    store_pair(sc + (long long)(p + 8) * a.N + n, n, a.N, acc[nt][2],
               acc[nt][3]);
  }
}

__global__ void __launch_bounds__(kThreadsF)
ssd_chunk_state_f32_kernel(const SsdArgs a) {
  grid_dependents_launch();
  extern __shared__ float fs[];
  const int c = blockIdx.y, b = blockIdx.z, t0 = c * kQ;
  const int rows = min(kQ, a.S - t0);
  const int tid = threadIdx.x, lane = tid & 31;
  float* Bs = fs;                       // [k][n]
  float* XC = fs + kQ * kFPitch;        // x [k][p] or C [q][n]
  float* wv = XC + kQ * kFPitch;
  stage_f32(Bs, kFPitch, static_cast<const float*>(a.Bm) + b * a.b_sb
            + t0 * a.b_ss, a.b_ss, rows, a.N);

  if (blockIdx.x == a.H * a.n_pb) {
    // ---- C B^T [q][j]: thread j = tid % 64, rows q0.. q0 + 31 ----
    stage_f32(XC, kFPitch, static_cast<const float*>(a.Cm) + b * a.c_sb
              + t0 * a.c_ss, a.c_ss, rows, a.N);
    __syncthreads();
    const int j = tid & 63, q0 = (tid >> 6) * 32;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int n = 0; n < a.N; ++n) {
      const float bj = Bs[j * kFPitch + n];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += XC[(q0 + i) * kFPitch + n] * bj;
    }
    float* cb = a.ws_cb + ((long long)b * a.nc + c) * kQ * kQ;
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[(q0 + i) * kQ + j] = acc[i];
    return;
  }

  const int h = blockIdx.x / a.n_pb, p0 = (blockIdx.x % a.n_pb) * kPBF;
  stage_f32(XC, kPBF, static_cast<const float*>(a.x) + b * a.x_sb
            + t0 * a.x_ss + h * a.x_sh + p0, a.x_ss, rows, kPBF);
  if (tid < 32) {
    const Cum2 r = chunk_cumsum(a.dt + b * a.dt_sb + t0 * a.dt_ss
                                + h * a.dt_sh, a.dt_ss, rows, a.A[h]);
    wv[2 * lane] = expf(r.s0) * r.dt0;
    wv[2 * lane + 1] = expf(r.s1) * r.dt1;
    if (lane == 0 && p0 == 0)
      a.ws_dec[((long long)b * a.nc + c) * a.H + h] = expf(r.last);
  }
  __syncthreads();
  // ---- s_c[p][n]: thread n, every p ----
  const int n = tid;
  if (n >= a.N) return;
  float acc[kPBF];
#pragma unroll
  for (int p = 0; p < kPBF; ++p) acc[p] = 0.f;
  for (int k = 0; k < rows; ++k) {
    const float bv = Bs[k * kFPitch + n], w = wv[k];
#pragma unroll
    for (int p = 0; p < kPBF; ++p) acc[p] += (XC[k * kPBF + p] * w) * bv;
  }
  float* sc = a.ws_state + ws_state_off(a, b, c, h, p0);
#pragma unroll
  for (int p = 0; p < kPBF; ++p) sc[(long long)p * a.N + n] = acc[p];
}

// ---------------------------------------------------------------------------
// launch 2: the state pass over the chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const SsdArgs a) {
  grid_dependents_launch();
  grid_dependency_wait();
  const int h = blockIdx.y, b = blockIdx.z;
  const long long PN = (long long)a.P * a.N;
  const long long i = ((long long)blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (i >= PN) return;                  // P N % 4 == 0
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.h0 != nullptr)
    S = *reinterpret_cast<const float4*>(a.h0 + ((long long)b * a.H + h) * PN
                                         + i);
  float* ws = a.ws_state + ws_state_off(a, b, 0, h, 0) + i;
  const float* dec = a.ws_dec + (long long)b * a.nc * a.H + h;
  const long long step = (long long)a.H * PN;      // chunk to chunk
  for (int c0 = 0; c0 < a.nc; c0 += kPassBatch) {
    float4 s[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < a.nc) {
        s[u] = *reinterpret_cast<const float4*>(ws + (c0 + u) * step);
        d[u] = dec[(long long)(c0 + u) * a.H];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < a.nc) {
        *reinterpret_cast<float4*>(ws + (c0 + u) * step) = S;
        S.x = d[u] * S.x + s[u].x;
        S.y = d[u] * S.y + s[u].y;
        S.z = d[u] * S.z + s[u].z;
        S.w = d[u] * S.w + s[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(a.state + ((long long)b * a.H + h) * PN + i) = S;
}

// ---------------------------------------------------------------------------
// launch 3: chunk outputs from the entering states
// ---------------------------------------------------------------------------

template <int PB>
__global__ void __launch_bounds__(Mma<PB>::kThreads)
ssd_chunk_out_mma_kernel(const SsdArgs a) {
  using G = Mma<PB>;
  extern __shared__ __align__(128) uint8_t sm[];
  const int h = blockIdx.x / a.n_pb, p0 = (blockIdx.x % a.n_pb) * PB;
  const int c = blockIdx.y, b = blockIdx.z, t0 = c * kQ;
  const int rows = min(kQ, a.S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, li = lane & 7, lj = lane >> 3;
  // warp w: the 16 rows at 16 (w % 4), the 32 columns of P at 32 (w / 4)
  const int qt = warp & 3, pc = (warp >> 2) * 32;
  uint8_t* xs = sm;
  uint8_t* cs = sm + G::kOffC3;
  uint8_t* sh = sm + G::kOffSh3;
  uint8_t* sl = sm + G::kOffSl3;
  uint8_t* ys = sm + G::kOffY3;
  float* dtv = reinterpret_cast<float*>(sm + G::kOffV3);
  float* cum = dtv + kQ;
  float* ecum = cum + kQ;

  // ---- the inputs first: they do not depend on launches 1 and 2 ----
  stage_bf16(xs, G::kXPitch, static_cast<const bf16*>(a.x) + b * a.x_sb
             + t0 * a.x_ss + h * a.x_sh + p0, a.x_ss, rows, PB, PB, a.vec);
  stage_bf16(cs, kNPitch, static_cast<const bf16*>(a.Cm) + b * a.c_sb
             + t0 * a.c_ss, a.c_ss, rows, a.Np, a.N, a.vec);
  cp_async_commit();
  if (warp == 0) {
    const Cum2 r = chunk_cumsum(a.dt + b * a.dt_sb + t0 * a.dt_ss
                                + h * a.dt_sh, a.dt_ss, rows, a.A[h]);
    dtv[2 * lane] = r.dt0;
    dtv[2 * lane + 1] = r.dt1;
    cum[2 * lane] = r.c0;
    cum[2 * lane + 1] = r.c1;
    ecum[2 * lane] = expf(r.c0);
    ecum[2 * lane + 1] = expf(r.c1);
  }
  grid_dependency_wait();

  // ---- the entering state as bf16 high and low parts [p][n] ----
  const bool has_state = c > 0 || a.h0 != nullptr;
  if (has_state) {
    const float* sin = a.ws_state + ws_state_off(a, b, c, h, p0);
    const int half = a.Np / 2;
    for (int i = tid; i < PB * half; i += G::kThreads) {
      const int p = i / half, n = (i - p * half) * 2;
      const float* sp = sin + (long long)p * a.N + n;
      float2 v = make_float2(0.f, 0.f);
      if (a.N % 2 == 0) {
        if (n < a.N) v = *reinterpret_cast<const float2*>(sp);
      } else {
        v = make_float2(n < a.N ? sp[0] : 0.f, n + 1 < a.N ? sp[1] : 0.f);
      }
      uint32_t hi, lo;
      split_bf16x2(v.x, v.y, hi, lo);
      *reinterpret_cast<uint32_t*>(sh + p * kNPitch + n * 2) = hi;
      *reinterpret_cast<uint32_t*>(sl + p * kNPitch + n * 2) = lo;
    }
  }
  // C B^T at this thread's fragment positions: rows q0, q1, key columns
  // k, k + 1 and k + 8, k + 9 of each key tile at or left of the diagonal
  const float* cb = a.ws_cb + ((long long)b * a.nc + c) * kQ * kQ;
  const int q0 = qt * 16 + g, q1 = q0 + 8;
  float2 cbv[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks > qt) break;
    const int k = ks * 16 + 2 * tq;
    cbv[ks][0] = *reinterpret_cast<const float2*>(cb + q0 * kQ + k);
    cbv[ks][1] = *reinterpret_cast<const float2*>(cb + q1 * kQ + k);
    cbv[ks][2] = *reinterpret_cast<const float2*>(cb + q0 * kQ + k + 8);
    cbv[ks][3] = *reinterpret_cast<const float2*>(cb + q1 * kQ + k + 8);
  }
  cp_async_wait<0>();
  __syncthreads();

  float yi[4][4], ye[4][4];      // G x and C S_in^T: 4 tiles of 8 columns
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) { yi[i][e] = 0.f; ye[i][e] = 0.f; }

  // ---- G x over the key tiles at or left of the diagonal ----
  const float cq0 = cum[q0], cq1 = cum[q1];
  auto gval = [&](float cb_qk, int q, float cq, int k) {
    return q >= k ? cb_qk * expf(cq - cum[k]) * dtv[k] : 0.f;
  };
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks > qt) break;
    const int k = ks * 16 + 2 * tq;
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = e & 1 ? q1 : q0, kk = k + (e >> 1) * 8;
      const float cq = e & 1 ? cq1 : cq0;
      split_bf16x2(gval(cbv[ks][e].x, q, cq, kk),
                   gval(cbv[ks][e].y, q, cq, kk + 1), ahi[e], alo[e]);
    }
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      uint32_t rb[4];
      ldmatrix_x4_trans(rb, smem_u32(xs + (ks * 16 + (lj & 1) * 8 + li)
                                     * G::kXPitch
                                     + (pc + pp * 16 + (lj >> 1) * 8) * 2));
      mma_bf16_16816(yi[2 * pp], ahi, rb[0], rb[1]);
      mma_bf16_16816(yi[2 * pp], alo, rb[0], rb[1]);
      mma_bf16_16816(yi[2 * pp + 1], ahi, rb[2], rb[3]);
      mma_bf16_16816(yi[2 * pp + 1], alo, rb[2], rb[3]);
    }
  }

  // ---- C S_in^T ----
  if (has_state) {
    for (int ks = 0; ks < a.Np / 16; ++ks) {
      uint32_t ra[4];
      ldmatrix_x4(ra, smem_u32(cs + (qt * 16 + (lj & 1) * 8 + li) * kNPitch
                               + (ks * 16 + (lj >> 1) * 8) * 2));
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int off = (pc + pp * 16 + (lj >> 1) * 8 + li) * kNPitch
                        + (ks * 16 + (lj & 1) * 8) * 2;
        uint32_t rh[4], rl[4];
        ldmatrix_x4(rh, smem_u32(sh + off));
        ldmatrix_x4(rl, smem_u32(sl + off));
        mma_bf16_16816(ye[2 * pp], ra, rh[0], rh[1]);
        mma_bf16_16816(ye[2 * pp], ra, rl[0], rl[1]);
        mma_bf16_16816(ye[2 * pp + 1], ra, rh[2], rh[3]);
        mma_bf16_16816(ye[2 * pp + 1], ra, rl[2], rl[3]);
      }
    }
  }

  // ---- y = G x + exp(cum_q) C S_in^T, through shared memory ----
  const float e0 = ecum[q0], e1 = ecum[q1];
#pragma unroll
  for (int pt = 0; pt < 4; ++pt) {
    const int p = pc + pt * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(ys + q0 * G::kXPitch + p * 2) = pack_bf16x2(
        yi[pt][0] + e0 * ye[pt][0], yi[pt][1] + e0 * ye[pt][1]);
    *reinterpret_cast<uint32_t*>(ys + q1 * G::kXPitch + p * 2) = pack_bf16x2(
        yi[pt][2] + e1 * ye[pt][2], yi[pt][3] + e1 * ye[pt][3]);
  }
  __syncthreads();
  bf16* yb = static_cast<bf16*>(a.y) + b * a.y_sb + t0 * a.y_ss + h * a.y_sh
             + p0;
  for (int i = tid; i < rows * (PB / 8); i += G::kThreads) {
    const int q = i / (PB / 8), ch = i % (PB / 8);
    *reinterpret_cast<uint4*>(yb + q * a.y_ss + ch * 8) =
        *reinterpret_cast<const uint4*>(ys + q * G::kXPitch + ch * 16);
  }
}

__global__ void __launch_bounds__(kThreadsF)
ssd_chunk_out_f32_kernel(const SsdArgs a) {
  extern __shared__ float fs[];
  const int h = blockIdx.x / a.n_pb, p0 = (blockIdx.x % a.n_pb) * kPBF;
  const int c = blockIdx.y, b = blockIdx.z, t0 = c * kQ;
  const int rows = min(kQ, a.S - t0);
  const int tid = threadIdx.x, lane = tid & 31;
  float* xs = fs;                    // [k][p]
  float* Cs = fs + kOffC3F;          // [q][n]
  float* Ss = fs + kOffS3F;          // [p][n]
  float* G = fs + kOffG3F;           // [q][k]
  float* dtv = fs + kOffV3F;
  float* cum = dtv + kQ;
  float* ecum = cum + kQ;

  stage_f32(xs, kPBF, static_cast<const float*>(a.x) + b * a.x_sb
            + t0 * a.x_ss + h * a.x_sh + p0, a.x_ss, rows, kPBF);
  stage_f32(Cs, kFPitch, static_cast<const float*>(a.Cm) + b * a.c_sb
            + t0 * a.c_ss, a.c_ss, rows, a.N);
  if (tid < 32) {
    const Cum2 r = chunk_cumsum(a.dt + b * a.dt_sb + t0 * a.dt_ss
                                + h * a.dt_sh, a.dt_ss, rows, a.A[h]);
    dtv[2 * lane] = r.dt0;
    dtv[2 * lane + 1] = r.dt1;
    cum[2 * lane] = r.c0;
    cum[2 * lane + 1] = r.c1;
    ecum[2 * lane] = expf(r.c0);
    ecum[2 * lane + 1] = expf(r.c1);
  }
  grid_dependency_wait();
  const bool has_state = c > 0 || a.h0 != nullptr;
  if (has_state) {
    const float* sin = a.ws_state + ws_state_off(a, b, c, h, p0);
    for (int i = tid; i < kPBF * a.N; i += kThreadsF) {
      const int p = i / a.N, n = i - p * a.N;
      Ss[p * kFPitch + n] = sin[i];
    }
  }
  __syncthreads();                   // cum and dt are in place
  const float* cb = a.ws_cb + ((long long)b * a.nc + c) * kQ * kQ;
  for (int i = tid; i < kQ * kQ; i += kThreadsF) {
    const int q = i / kQ, k = i % kQ;
    G[q * kGPitch + k] =
        q >= k ? cb[i] * expf(cum[q] - cum[k]) * dtv[k] : 0.f;
  }
  __syncthreads();

  // ---- thread p = tid % 32 takes the rows qg + 4i ----
  const int p = tid & 31, qg = tid >> 5;
  float acc[16], inter[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) { acc[i] = 0.f; inter[i] = 0.f; }
  for (int k = 0; k < rows; ++k) {
    const float xv = xs[k * kPBF + p];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += G[(qg + 4 * i) * kGPitch + k] * xv;
  }
  if (has_state) {
    for (int n = 0; n < a.N; ++n) {
      const float sv = Ss[p * kFPitch + n];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        inter[i] += Cs[(qg + 4 * i) * kFPitch + n] * sv;
    }
  }
  float* yb = static_cast<float*>(a.y) + b * a.y_sb + t0 * a.y_ss
              + h * a.y_sh + p0 + p;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = qg + 4 * i;
    if (q < rows) yb[q * a.y_ss] = acc[i] + ecum[q] * inter[i];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

cudaError_t launch_dependent(void (*kernel)(SsdArgs), dim3 grid, int threads,
                             int smem, bool after_kernel, const SsdArgs& a,
                             cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_kernel ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the chunk kernels of one dtype and P-block
struct Plan {
  void (*states)(SsdArgs);
  void (*outputs)(SsdArgs);
  int threads, smem_states, smem_outputs;
};

template <int PB>
Plan mma_plan() {
  using G = Mma<PB>;
  return {ssd_chunk_state_mma_kernel<PB>, ssd_chunk_out_mma_kernel<PB>,
          G::kThreads, G::kSmem1, G::kSmem3};
}

cudaError_t launch_all(const SsdArgs& a, int B, const Plan& plan,
                       cudaStream_t stream) {
  cudaError_t err;
  const int chunk_ctas = a.H * a.n_pb;
  if (a.nc > 0) {
    err = launch_dependent(plan.states, dim3(chunk_ctas + 1, a.nc, B),
                           plan.threads, plan.smem_states, false, a, stream);
    if (err != cudaSuccess) return err;
  }
  const long long PN = (long long)a.P * a.N;
  err = launch_dependent(
      ssd_state_pass_kernel,
      dim3((unsigned)((PN + kPassElems - 1) / kPassElems), a.H, B),
      kPassThreads, 0, a.nc > 0, a, stream);
  if (err != cudaSuccess || a.nc == 0) return err;
  return launch_dependent(plan.outputs, dim3(chunk_ctas, a.nc, B),
                          plan.threads, plan.smem_outputs, true, a, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int pb_ssd_scan(
    int dtype, int device, const void* x, const void* dt, const void* A,
    const void* Bm, const void* Cm, void* y, void* state, const void* h0,
    void* ws, const long long* st, int B, int S, int H, int P, int N,
    int p_block, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool bf = dtype == kDtypeBF16;
  if ((p_block != kPBF && !(bf && p_block == 64)) || P % p_block != 0
      || N < 1 || N > kNMax || S < 0 || (!bf && dtype != kDtypeF32))
    return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || P <= 0) return cudaSuccess;
  SsdArgs a;
  a.x = x; a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A); a.Bm = Bm; a.Cm = Cm; a.y = y;
  a.state = static_cast<float*>(state);
  a.h0 = static_cast<const float*>(h0);
  a.x_sb = st[0]; a.x_ss = st[1]; a.x_sh = st[2];
  a.dt_sb = st[3]; a.dt_ss = st[4]; a.dt_sh = st[5];
  a.b_sb = st[6]; a.b_ss = st[7];
  a.c_sb = st[8]; a.c_ss = st[9];
  a.y_sb = st[10]; a.y_ss = st[11]; a.y_sh = st[12];
  a.S = S; a.H = H; a.P = P; a.N = N;
  a.Np = (N + 15) / 16 * 16;
  a.nc = (S + kQ - 1) / kQ;
  a.n_pb = P / p_block;
  a.ws_state = static_cast<float*>(ws);
  a.ws_cb = a.ws_state + (long long)B * a.nc * H * P * N;
  a.ws_dec = a.ws_cb + (long long)B * a.nc * kQ * kQ;
  a.vec = bf && N % 8 == 0 && aligned16(x) && aligned16(Bm)
          && aligned16(Cm);
  for (int i = 0; i < 10; ++i)          // x, B and C strides (bf16 elements)
    if (i < 3 || i >= 6) a.vec = a.vec && st[i] % 8 == 0;
  const Plan plan = !bf ? Plan{ssd_chunk_state_f32_kernel,
                               ssd_chunk_out_f32_kernel, kThreadsF, kSmem1F,
                               kSmem3F}
                    : p_block == 64 ? mma_plan<64>() : mma_plan<32>();
  return launch_all(a, B, plan, static_cast<cudaStream_t>(stream));
}
