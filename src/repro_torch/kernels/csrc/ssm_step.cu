// The Mamba-2 recurrent state update and its readout for one decode token,
// in place on the cache's float32 state: for every row b and head h, with
//   dt  = softplus(dt_raw[b, h] + dt_bias[h])      (threshold 20)
//   dA  = exp(dt * -exp(A_log[h]))
//   s'[p, n] = s[p, n] dA + (dt x[p]) B[n]          (written back over s)
//   y[p] = bf16(sum_n C[n] s'[p, n]) + bf16(bf16(D[h]) x[p]).
//
// Replaces no TPU kernel: the JAX package leaves the decode step's
// recurrence to XLA, which fuses it.  It was added because the port's
// decode step ran it as plain PyTorch over the state S (B x H x P x N
// float32; granite-4.0-h-small at 128 slots: 512 MiB a layer): the outer
// product wrote S, the decay read and wrote S, the sum read 2 S and wrote
// S, the readout read S and the cache copy read and wrote S, about nine
// S a layer.  The kernel reads S once and writes it once.
//
// Bound on the H100: the bytes.  Per state element it does 5 operations
// (two products, a sum, the readout's product and sum) for 8 bytes, far
// below the tensor cores' line, so the design is about keeping enough
// loads in flight: one CTA of 8 warps a (b, h) tile of P x N; each lane
// holds 4 consecutive n (one 16-byte access a row, 512 bytes a warp's row
// at N = 128, a second vector past N = 128), and a warp first issues the
// loads of its next 8 rows, then updates them, stores them and sums each
// row's readout by shuffles.  At P = 64 a CTA holds its whole 32 KiB tile
// in flight, and its registers are held to 85 a thread so that 3 CTAs
// share an SM (96 KiB in flight).  The state's loads and stores are
// marked streaming (evict first): each step reads it once, ten times the
// L2 a layer at granite's shape.  Of the designs timed there on the
// H100, this one ran at 89% of the bytes bound, beside a copy of the
// state at 90%; the same at 2 CTAs an SM without the hints at 81%,
// persistent warps prefetching their next rows at 52-73%.  B, C, x, dt
// and the per-head parameters are read as scalars: a few hundred bytes a
// tile, any strides.
//
// Arithmetic: the plain version's (kernels/ssm_step.py), each product and
// sum of the state rounded on its own (no fused multiply-add), precise
// expf and log1pf (the build has no fast-math flag), so the state equals
// the plain version's where its outer product takes (dt x) B; the readout
// sums in another order (float32), then rounds as the plain version does.
//
// Layouts: state (B, H, P, N) float32 contiguous, 16-byte aligned, N a
// multiple of 4 up to 256; x (B, H, P), dt (B, H), Bm and Cm (B, N) any
// strides, one dtype T (bfloat16 or float32); dt_bias, A_log, D_skip (H,)
// float32 contiguous; y (B, H, P) T contiguous.
#include "common.cuh"

namespace {

using namespace pb;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // rows of P a warp holds in flight

// the state's 16-byte accesses, streaming (evict first)
__device__ __forceinline__ void load_state(const float* p, float* o) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void store_state(float* p, const float* o) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}

struct SsmArgs {
  float* state;
  const void* x; const void* dt; const float* dt_bias; const float* a_log;
  const void* bm; const void* cm; const float* d_skip; void* y;
  long long x_sb, x_sh, x_sp, dt_sb, dt_sh, b_sb, b_sn, c_sb, c_sn;
  int H, P, N;
};

// VPL: 16-byte vectors of n a lane holds (1 up to N = 128, 2 up to 256);
// 3 CTAs an SM at one vector, 2 at two
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads, VPL == 1 ? 3 : 2)
    ssm_step_kernel(SsmArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* bm = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cm = static_cast<const T*>(a.cm) + b * a.c_sb;

  float dt = __fadd_rn(
      to_float(static_cast<const T*>(a.dt)[b * a.dt_sb + h * a.dt_sh]),
      a.dt_bias[h]);
  dt = dt > 20.f ? dt : log1pf(expf(dt));
  const float dA = expf(__fmul_rn(dt, -expf(a.a_log[h])));
  const float d_skip = to_float(from_float<T>(a.d_skip[h]));

  float bv[VPL][4], cv[VPL][4];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int n0 = (lane + 32 * v) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool on = n0 + j < a.N;
      bv[v][j] = on ? to_float(bm[(n0 + j) * a.b_sn]) : 0.f;
      cv[v][j] = on ? to_float(cm[(n0 + j) * a.c_sn]) : 0.f;
    }
  }

  float* tile = a.state + (long long)bh * a.P * a.N;
  T* y = static_cast<T*>(a.y) + (long long)bh * a.P;
  for (int p0 = warp * kRows; p0 < a.P; p0 += kWarps * kRows) {
    float s[kRows][VPL][4];
    float xv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r;
      xv[r] = 0.f;
      if (p < a.P) {
        xv[r] = to_float(x[p * a.x_sp]);
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int n0 = (lane + 32 * v) * 4;
          if (n0 < a.N) load_state(tile + (long long)p * a.N + n0, s[r][v]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r;
      if (p < a.P) {                  // the same p across the warp
        const float dtx = __fmul_rn(dt, xv[r]);
        float acc = 0.f;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int n0 = (lane + 32 * v) * 4;
          if (n0 < a.N) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float ns = __fadd_rn(__fmul_rn(s[r][v][j], dA),
                                         __fmul_rn(dtx, bv[v][j]));
              s[r][v][j] = ns;
              acc = __fmaf_rn(cv[v][j], ns, acc);
            }
            store_state(tile + (long long)p * a.N + n0, s[r][v]);
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) {
          const float yr = to_float(from_float<T>(acc));
          const float dx = to_float(from_float<T>(__fmul_rn(d_skip, xv[r])));
          y[p] = from_float<T>(__fadd_rn(yr, dx));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_t(const SsmArgs& a, int BH, cudaStream_t s) {
  if (a.N <= 128)
    ssm_step_kernel<T, 1><<<BH, kThreads, 0, s>>>(a);
  else
    ssm_step_kernel<T, 2><<<BH, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pb_ssm_step(int dtype, int device, void* state, const void* x,
                           const void* dt, const void* dt_bias,
                           const void* a_log, const void* bm, const void* cm,
                           const void* d_skip, void* y, const long long* st,
                           int B, int H, int P, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || H < 0 || P < 0 || N <= 0 || N % 4 != 0 || N > 256)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || P == 0) return cudaSuccess;
  if ((long long)B * H > 2147483647LL) return cudaErrorInvalidValue;
  SsmArgs a;
  a.state = static_cast<float*>(state);
  a.x = x; a.dt = dt; a.dt_bias = static_cast<const float*>(dt_bias);
  a.a_log = static_cast<const float*>(a_log); a.bm = bm; a.cm = cm;
  a.d_skip = static_cast<const float*>(d_skip); a.y = y;
  a.x_sb = st[0]; a.x_sh = st[1]; a.x_sp = st[2];
  a.dt_sb = st[3]; a.dt_sh = st[4];
  a.b_sb = st[5]; a.b_sn = st[6]; a.c_sb = st[7]; a.c_sn = st[8];
  a.H = H; a.P = P; a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, B * H, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, B * H, s);
  return cudaErrorInvalidValue;
}
