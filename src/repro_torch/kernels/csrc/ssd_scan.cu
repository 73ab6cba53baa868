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
// bound it, at a few microseconds; the products are about 1 GFLOP.  This
// first version does the products on the CUDA cores in float32 and stages
// each chunk from device memory before computing on it, with no overlap:
// with one CTA of 8 warps per SM, the staging loads' latency and the
// shared-memory loads of the products, not the card's bytes or FLOPs,
// set its time, far above that bound.  Overlapping the next chunk's loads
// (cp.async or TMA into a second buffer), wgmma, and more warps per SM
// are later work.
//
// Design.  On the TPU the grid walks the chunks of one (row, head) in order
// and carries the state in VMEM scratch.  Here a loop over the chunks
// inside one CTA takes the place of that sequential grid axis, and the
// state lives in shared memory across it.  One CTA of 256 threads owns one
// (batch row, head, 32-wide slice of P): at B = 1, H = 48, P = 64 that is
// 96 CTAs, where one CTA per head would leave 84 of the 132 SMs idle.  The
// price is that the two CTAs of a head both form C B^T (a quarter of the
// work).  The chunk is 64 rows (the kernel's own choice: the result does
// not depend on it beyond rounding), which keeps a CTA at about 107 KB of
// shared memory, so two CTAs fit on an SM.  Per chunk: stage B^T and C^T
// (n-major, rows padded to 65 floats so column reads do not collide in a
// bank), the x slice and dt; one warp scans dt * A; then G, y and the
// state update, each a register-tiled product over shared memory.  The
// decay exp(cum_q - cum_k) is evaluated only where q >= k (elsewhere the
// exponent is positive and may overflow, and 0 * inf would give NaN).
// Rows at or past S are staged as zeros with dt = 0, an exact no-op on the
// recurrence, and are never stored: nothing is padded or copied.
//
// Layouts (element strides, innermost dimension contiguous):
//   x (B, S, H, P) and y (B, S, H, P) in T; dt (B, S, H) float32;
//   A (H,) float32 (negative); Bm, Cm (B, S, N) in T;
//   state and the optional initial state h0 (B, H, P, N) float32,
//   contiguous.
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kQ = 64;          // rows per chunk
constexpr int kPS = 32;         // columns of P per CTA
constexpr int kNMax = 128;      // largest state size N
constexpr int kThreads = 256;
constexpr int kQP = kQ + 1;     // padded row of B^T, C^T and G
constexpr int kPSP = kPS + 1;   // padded row of the n-major state

// shared memory, in floats
constexpr int kOffCt = 0;
constexpr int kOffBt = kOffCt + kNMax * kQP;
constexpr int kOffG = kOffBt + kNMax * kQP;
constexpr int kOffX = kOffG + kQ * kQP;
constexpr int kOffSt = kOffX + kQ * kPS;
constexpr int kOffDt = kOffSt + kNMax * kPSP;
constexpr int kOffCum = kOffDt + kQ;
constexpr int kOffECum = kOffCum + kQ;
constexpr int kOffW = kOffECum + kQ;
constexpr int kOffDecay = kOffW + kQ;
constexpr int kSmemFloats = kOffDecay + 4;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct SsdArgs {
  const void* x; const float* dt; const float* A; const void* Bm;
  const void* Cm; void* y; float* state; const float* h0;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh;
  int S, H, P, N;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const SsdArgs a) {
  extern __shared__ float smem[];
  float* Ct = smem + kOffCt;     // [n][q]  C^T of the chunk
  float* Bt = smem + kOffBt;     // [n][k]  B^T of the chunk
  float* G = smem + kOffG;       // [q][k]  masked, decayed C B^T o dt
  float* xs = smem + kOffX;      // [k][p]  the chunk's x slice
  float* St = smem + kOffSt;     // [n][p]  the carried state, transposed
  float* dtv = smem + kOffDt;
  float* cum = smem + kOffCum;
  float* ecum = smem + kOffECum;   // exp(cum_q)
  float* wv = smem + kOffW;        // exp(cum_last - cum_k) * dt_k
  float* decay = smem + kOffDecay; // exp(cum_last)

  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int S = a.S, N = a.N;
  const float A_h = a.A[h];

  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.c_sb;
  T* yb = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + p0;

  for (int i = tid; i < kNMax * kPSP; i += kThreads) St[i] = 0.f;
  if (a.h0 != nullptr) {           // uniform across the CTA
    __syncthreads();
    const float* hb = a.h0 + ((long long)(b * a.H + h) * a.P + p0) * N;
    for (int i = tid; i < kPS * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      St[n * kPSP + p] = hb[(long long)p * N + n];
    }
  }

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int rows = min(kQ, S - t0);

    // ---- stage the chunk (rows >= `rows` as zeros, dt = 0) ----
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int k = i / N, n = i - k * N;
      float bv = 0.f, cv = 0.f;
      if (k < rows) {
        bv = to_float(Bb[(long long)(t0 + k) * a.b_ss + n]);
        cv = to_float(Cb[(long long)(t0 + k) * a.c_ss + n]);
      }
      Bt[n * kQP + k] = bv;
      Ct[n * kQP + k] = cv;
    }
    for (int i = tid; i < kQ * kPS; i += kThreads) {
      const int k = i / kPS, p = i % kPS;
      xs[i] = k < rows ? to_float(xb[(long long)(t0 + k) * a.x_ss + p]) : 0.f;
    }
    if (tid < kQ)
      dtv[tid] = tid < rows ? dtb[(long long)(t0 + tid) * a.dt_ss] : 0.f;
    __syncthreads();

    // ---- one warp: cum = cumsum(dt * A), two rows per lane ----
    if (tid < 32) {
      const float d0 = dtv[2 * lane] * A_h, d1 = dtv[2 * lane + 1] * A_h;
      float s = d0 + d1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + d0, c1 = s;
      const float last = __shfl_sync(0xffffffffu, s, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = expf(c0);
      ecum[2 * lane + 1] = expf(c1);
      wv[2 * lane] = expf(last - c0) * dtv[2 * lane];
      wv[2 * lane + 1] = expf(last - c1) * dtv[2 * lane + 1];
      if (lane == 0) decay[0] = expf(last);
    }
    __syncthreads();

    // ---- G[q][k]: a 4 x 4 tile per thread; tiles wholly above the
    //      diagonal skip the product ----
    {
      const int q0 = (tid >> 4) * 4, k0 = (tid & 15) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (q0 + 3 >= k0) {
        for (int n = 0; n < N; ++n) {
          const float* cr = Ct + n * kQP + q0;
          const float* br = Bt + n * kQP + k0;
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) { cv[i] = cr[i]; bv[i] = br[i]; }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = q0 + i, k = k0 + j;
          G[q * kQP + k] =
              q >= k ? acc[i][j] * expf(cum[q] - cum[k]) * dtv[k] : 0.f;
        }
    }
    __syncthreads();

    // ---- y[q][p] = G x + exp(cum_q) C state^T: rows tq + 16 i,
    //      columns tp + 16 j ----
    {
      const int tq = tid >> 4, tp = tid & 15;
      float acc[4][2], inter[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) { acc[i][j] = 0.f; inter[i][j] = 0.f; }
      const int kend = min(rows, tq + 48 + 1);   // G[q][k] = 0 for k > q
      for (int k = 0; k < kend; ++k) {
        const float x0 = xs[k * kPS + tp], x1 = xs[k * kPS + tp + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = G[(tq + 16 * i) * kQP + k];
          acc[i][0] += g * x0;
          acc[i][1] += g * x1;
        }
      }
      for (int n = 0; n < N; ++n) {
        const float s0 = St[n * kPSP + tp], s1 = St[n * kPSP + tp + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = Ct[n * kQP + tq + 16 * i];
          inter[i][0] += c * s0;
          inter[i][1] += c * s1;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = tq + 16 * i;
        if (q < rows) {
          T* yr = yb + (long long)(t0 + q) * a.y_ss;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            yr[tp + 16 * j] = from_float<T>(acc[i][j] + ecum[q] * inter[i][j]);
        }
      }
    }
    __syncthreads();   // every thread has read the old state

    // ---- state[p][n] = exp(cum_last) state + sum_k w_k x_k B_k:
    //      n = tn + 32 i, p = tp + 8 j ----
    {
      const int tn = lane, tp = tid >> 5;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < rows; ++k) {
        const float w = wv[k];
        float xv[4], bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = w * xs[k * kPS + tp + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bt[(tn + 32 * i) * kQP + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += bv[i] * xv[j];
      }
      const float d = decay[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = tn + 32 * i;
        if (n < N) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* sp = St + n * kPSP + tp + 8 * j;
            *sp = d * *sp + acc[i][j];
          }
        }
      }
    }
    __syncthreads();   // the chunk's buffers are free again
  }

  __syncthreads();
  float* sb = a.state + ((long long)(b * a.H + h) * a.P + p0) * N;
  for (int i = tid; i < kPS * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sb[(long long)p * N + n] = St[n * kPSP + p];
  }
}

template <typename T>
cudaError_t launch_t(const SsdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.P / kPS, a.H, B);
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pb_ssd_scan(
    int dtype, int device, const void* x, const void* dt, const void* A,
    const void* Bm, const void* Cm, void* y, void* state, const void* h0,
    const long long* st, int B, int S, int H, int P, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (P % kPS != 0 || N < 1 || N > kNMax || S < 0) return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, B, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, B, s);
  return cudaErrorInvalidValue;
}
