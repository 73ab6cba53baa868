// RG-LRU linear recurrence for Hopper: h_t = exp(log_a_t) * h_{t-1} + bx_t
// over (B, S, W), from an optional h0, returning every h_t and h_S.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel), the recurrence of the Griffin /
// RecurrentGemma recurrent block [arXiv:2402.19427].  The TPU kernel builds
// a (Tb, Tb, Wb) log-space decay matrix per time block because its vector
// unit wants whole tiles; on the card the recurrence is one dependent FMA
// per element, so the work is channel-parallel over (b, w) and serial over
// t.  float32 in and out; log_a = 0, bx = 0 is an exact no-op (a = 1).
//
// Bound on the H100: the bytes (log_a and bx read once, y written once),
// a few microseconds at a serving prefill; the arithmetic (one expf and one
// FMA per element) is far below the float32 rate.  Reaching the memory
// rate takes many loads in flight, and one thread per channel is only
// B * W threads (2560 at B = 1: a fifth of the card).  Design: a CTA takes
// 32 channels (one coalesced 128-byte row piece per time step) and splits
// time into kSegs = 32 segments, one warp each.  Pass 1: each warp runs its
// segment from zero and keeps only the segment's decay product P and end
// state E.  The warps exchange (P, E) through shared memory and each
// composes the carry into its segment (h_in = P * h_prev + E over the
// segments before it, from h0).  Pass 2: each warp runs its segment again
// from that carry and stores y (its inputs mostly come from L2 this time).
// Both passes load kAhead time steps before the dependent FMAs, so each
// thread keeps 2 * kAhead loads in flight.  On the H100 at B = 1, S = 512
// (tools/rglru_segments.py, NVIDIA H100 80GB HBM3, 700.00 W) one segment
// took 0.0766 ms, 16 segments 0.0144 ms and 32 segments 0.0130 ms, 2.8x
// the bound: 80 CTAs still leave 52 SMs idle.
//
// Layouts (element strides, the channel dimension contiguous):
//   log_a, bx (B, S, W) float32; h0 (B, W) float32 contiguous or null;
//   y (B, S, W) float32; h_T (B, W) float32 contiguous.
#include "common.cuh"

namespace {

using namespace pb;

// time segments per CTA, one warp each (tools/rglru_segments.py builds
// other counts to measure what the split buys; at 1 there is no pass 1)
#ifndef PB_RGLRU_SEGS
#define PB_RGLRU_SEGS 32
#endif

constexpr int kLanes = 32;   // channels per CTA
constexpr int kSegs = PB_RGLRU_SEGS;
constexpr int kAhead = 8;    // time steps loaded before they are used

struct RglruArgs {
  const float* log_a; const float* bx; const float* h0;
  float* y; float* h_T;
  long long la_sb, la_ss, bx_sb, bx_ss, y_sb, y_ss;
  int S, W;
};

// Load kAhead steps [t, t + kAhead) of the segment ending at t1 (zeros,
// the exact no-op, past it).
__device__ __forceinline__ void load_steps(const float* la, const float* bx,
                                           long long la_ss, long long bx_ss,
                                           int t, int t1, float* ea,
                                           float* bv) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const bool in = t + i < t1;
    ea[i] = in ? la[(t + i) * la_ss] : 0.f;
    bv[i] = in ? bx[(t + i) * bx_ss] : 0.f;
  }
}

__global__ void __launch_bounds__(kLanes * kSegs)
rglru_scan_kernel(const RglruArgs a) {
  __shared__ float s_p[kSegs][kLanes];   // segment decay product
  __shared__ float s_e[kSegs][kLanes];   // segment end state from zero

  const int lane = threadIdx.x % kLanes, seg = threadIdx.x / kLanes;
  const int b = blockIdx.y, w = blockIdx.x * kLanes + lane;
  const bool ok = w < a.W;
  const int len = (a.S + kSegs - 1) / kSegs;
  const int t0 = min(seg * len, a.S), t1 = min(t0 + len, a.S);
  const float* la = a.log_a + b * a.la_sb + w;
  const float* bx = a.bx + b * a.bx_sb + w;

  float h = (ok && a.h0 != nullptr) ? a.h0[(long long)b * a.W + w] : 0.f;
  if (kSegs > 1) {
    // pass 1: decay product and end state of the segment, from zero
    float p = 1.f, e = 0.f;
    if (ok) {
      for (int t = t0; t < t1; t += kAhead) {
        float ea[kAhead], bv[kAhead];
        load_steps(la, bx, a.la_ss, a.bx_ss, t, t1, ea, bv);
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          const float ai = expf(ea[i]);
          e = fmaf(ai, e, bv[i]);
          p *= ai;
        }
      }
    }
    s_p[seg][lane] = p;
    s_e[seg][lane] = e;
    __syncthreads();
    // the carry into this segment: h0 folded through the segments before
    for (int s = 0; s < seg; ++s) h = fmaf(s_p[s][lane], h, s_e[s][lane]);
  }

  // pass 2: the recurrence from the carry, storing every h_t
  if (!ok) return;
  float* y = a.y + b * a.y_sb + w;
  for (int t = t0; t < t1; t += kAhead) {
    float ea[kAhead], bv[kAhead];
    load_steps(la, bx, a.la_ss, a.bx_ss, t, t1, ea, bv);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t + i < t1) {
        h = fmaf(expf(ea[i]), h, bv[i]);
        y[(t + i) * a.y_ss] = h;
      }
    }
  }
  // the warp holding step S - 1 writes h_T, so h_T is y[:, S - 1] exactly
  // (later segments are empty when kSegs does not divide S evenly)
  if (t0 < t1 && t1 == a.S) a.h_T[(long long)b * a.W + w] = h;
}

}  // namespace

extern "C" int pb_rglru_scan(int device, const void* log_a, const void* bx,
                             const void* h0, void* y, void* h_T,
                             const long long* st, int B, int S, int W,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  RglruArgs a;
  a.log_a = static_cast<const float*>(log_a);
  a.bx = static_cast<const float*>(bx);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.h_T = static_cast<float*>(h_T);
  a.la_sb = st[0]; a.la_ss = st[1];
  a.bx_sb = st[2]; a.bx_ss = st[3];
  a.y_sb = st[4]; a.y_ss = st[5];
  a.S = S; a.W = W;
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  rglru_scan_kernel<<<grid, kLanes * kSegs, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
