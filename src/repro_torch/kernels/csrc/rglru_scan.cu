// RG-LRU linear recurrence for Hopper: h_t = exp(log_a_t) * h_{t-1} + bx_t
// over (B, S, W), from an optional h0, returning every h_t and h_S.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel), the recurrence of the Griffin /
// RecurrentGemma recurrent block [arXiv:2402.19427].  The TPU kernel builds
// a (Tb, Tb, Wb) log-space decay matrix per time block because its vector
// unit wants whole tiles; on the card the recurrence is one dependent FMA
// per element, so the work is parallel over channels (b, w) and, through
// carries, over time.  float32 in and out; log_a = 0, bx = 0 is an exact
// no-op (a = 1).
//
// Bound on the H100: the bytes (log_a and bx read once, y written once);
// the arithmetic (one expf and two FMAs per element) is far below the
// float32 rate.  At a serving prefill (B = 1, S = 512, W = 2560) that is
// 15.7 MB, 4.7 us at 3.35 TB/s: the whole card has to have loads in
// flight from its first microsecond, and HBM is crossed once.
//
// Design: a thread-block cluster of kCluster = 8 CTAs splits time.  A
// cluster owns 32 channels of one row b; the grid is (ceil(W / 32) * 8, B),
// 640 CTAs of 4 warps at B = 1, W = 2560, one wave on the card.  Time runs
// in windows of 32 segments of `steps` = min(16, ceil(S / 32)) steps (one
// window up to S = 512): rank k of the cluster owns the k-th eighth of a
// window, each of its warps one segment.
//   1. Every input of the segment is requested at once into shared memory
//      (cp.async, 4 groups of 4 steps; 16-byte pieces of 4 rows x 32
//      channels a warp instruction where the rows are 16-byte aligned,
//      else a channel a lane; zeros, the exact no-op, past the end).
//   2. As each group lands, the segment runs from zero: its decay product
//      P and end state E; a and bx stay in registers.
//   3. The warps' (P, E) meet in shared memory; warp 0 composes the CTA's
//      aggregate and pushes it into every CTA of the cluster with st.async
//      (distributed shared memory), which completes bytes on that CTA's
//      mbarrier: no cluster-wide barrier, no fence at GPU scope.
//   4. Once its mbarrier has every rank's aggregate, each thread folds the
//      window's entering state (h0 for the first) through the ranks before
//      its own, then its CTA's warps before its own, and reruns its segment
//      from that carry out of registers, storing y.  The fold through all
//      ranks enters the next window; a cluster barrier between windows
//      frees the slots.
// So log_a and bx cross HBM once and y once, in one launch: no workspace,
// no global flag, no host state.  A cluster barrier at the start publishes
// the mbarriers, and one at the end keeps every CTA alive until the pushes
// to it have landed.  h_T is written by the thread that computes step
// S - 1, with the value it stores to y, so h_T is y[:, S - 1] bit for bit.
//
// Measured (tools/rglru_designs.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// section 6): 0.0087-0.0091 ms at B = 1, S = 512 and 0.0041-0.0043 ms at
// S = 64, against 0.0128-0.0132 and 0.0058-0.0061 ms for the first design
// (a CTA of 32 warp segments per 32 channels, 80 CTAs, the inputs read
// twice) in the same calls; torch.add of the same bytes takes 0.0081-0.0084
// ms.  What did not pay: a cluster barrier (release/acquire, a GPU-scope
// fence) and DSMEM reads in place of the pushes (+0.9 us at S = 512, +1.1
// us at S = 64), segments loaded into registers (109 registers: two waves
// of clusters), windows of 128 steps pipelined behind the loads (an
// exchange a window), y stored as 16-byte pieces through shared memory (95
// registers: two waves again).  This one: 80 registers, 92 clusters at
// once.
//
// Layouts (element strides, the channel dimension contiguous):
//   log_a, bx (B, S, W) float32; h0 (B, W) float32 contiguous or null;
//   y (B, S, W) float32; h_T (B, W) float32 contiguous.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace pb;

constexpr int kLanes = 32;     // channels per cluster, one per lane
constexpr int kCluster = 8;    // CTAs of a cluster (ranks along time)
constexpr int kWarps = 4;      // segments of a CTA in a window, a warp each
constexpr int kSegSteps = 16;  // most steps of a segment
constexpr int kGroup = 4;      // steps of a cp.async group
constexpr int kGroups = kSegSteps / kGroup;
constexpr int kThreads = kLanes * kWarps;
constexpr int kSegs = kCluster * kWarps;          // segments of a window
constexpr int kPushBytes = kCluster * kLanes * 2 * (int)sizeof(float);
static_assert(kSegSteps % kGroup == 0 && kGroups <= 4,
              "cp_async_wait_upto waits on 4 groups at most");

struct RglruArgs {
  const float* log_a; const float* bx; const float* h0;
  float* y; float* h_T;
  long long la_sb, la_ss, bx_sb, bx_ss, y_sb, y_ss;
  int S, W;
  int steps;     // steps of a segment
  int vec;       // log_a and bx rows load as 16-byte pieces
};

// steps of a segment for S steps: the whole sequence in one window where
// it fits
int segment_steps(int S) {
  const int n = (S + kSegs - 1) / kSegs;
  return n < kSegSteps ? n : kSegSteps;
}

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const RglruArgs a) {
  // each warp's inputs of a window: log_a as (steps, 32 channels), then
  // bx, a region per warp
  extern __shared__ float s_in[];
  // (P, E) of each warp's segment and, pushed by every rank, of each CTA;
  // the mbarrier counts the ranks' pushes
  __shared__ float2 s_seg[kWarps][kLanes];
  __shared__ float2 s_agg[kCluster][kLanes];
  __shared__ __align__(8) uint64_t s_bar;

  const int rank = cluster_ctarank();
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, warp = tid / kLanes;
  const int b = blockIdx.y;
  const int w = (blockIdx.x / kCluster) * kLanes + lane;
  const bool ok = w < a.W;
  const int steps = a.steps;
  const int window = steps * kSegs;
  const int seg = (rank * kWarps + warp) * steps;  // offset in a window
  const float* la = a.log_a + b * a.la_sb + w;
  const float* bx = a.bx + b * a.bx_sb + w;
  float* y = a.y + b * a.y_sb + w;
  float* s_a = s_in + warp * steps * kLanes;
  float* s_b = s_in + (kWarps + warp) * steps * kLanes;
  const int w4 = (blockIdx.x / kCluster) * kLanes + (lane % 8) * 4;
  const int vec_bytes = 4 * max(0, min(4, a.W - w4));
  const uint32_t bar = smem_u32(&s_bar);

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbarrier_init();
  }
  float h = (ok && a.h0 != nullptr) ? a.h0[(long long)b * a.W + w] : 0.f;
  int phase = 0;
  for (int tw = 0; tw < a.S; tw += window, phase ^= 1) {
    const int t0 = tw + seg;
    const int rows = max(0, min(steps, a.S - t0));   // the segment's steps
    const int n = ok ? rows : 0;                      // this lane's
    // 1. every input of the segment in flight at once, kGroup steps a
    // cp.async group (zeros, the exact no-op, past the end): 16-byte
    // pieces, 4 rows of 32 channels a warp instruction, where the rows are
    // 16-byte aligned, else a channel a lane
    if (a.vec) {
      const int r = lane / 8;
      const long long off = (long long)b * a.la_sb + w4;
      const long long offb = (long long)b * a.bx_sb + w4;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int i = g * kGroup + r;
        static_assert(kGroup == 4, "a 16-byte piece group is 4 rows");
        if (i < steps) {
          const int nb = i < rows ? vec_bytes : 0;
          const int t = nb ? t0 + i : 0;
          cp_async16_n(smem_u32(s_a + i * kLanes + (lane % 8) * 4),
                       a.log_a + (nb ? off + t * a.la_ss : 0), nb);
          cp_async16_n(smem_u32(s_b + i * kLanes + (lane % 8) * 4),
                       a.bx + (nb ? offb + t * a.bx_ss : 0), nb);
        }
        cp_async_commit();
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSegSteps; ++i) {
        if (i < steps) {
          const bool in = i < n;
          cp_async4(smem_u32(s_a + i * kLanes + lane),
                    in ? la + (t0 + i) * a.la_ss : a.log_a, in);
          cp_async4(smem_u32(s_b + i * kLanes + lane),
                    in ? bx + (t0 + i) * a.bx_ss : a.bx, in);
        }
        if (i % kGroup == kGroup - 1) cp_async_commit();
      }
    }
    if (tid == 0) mbar_arrive_expect_tx(bar, kPushBytes);
    if (tw == 0) {   // the mbarriers are ready before any rank pushes
      cluster_arrive_relaxed();
      cluster_wait();
    }
    // 2. the segment from zero as its groups land: decay product P and
    // end state E; a and bx stay in registers
    float av[kSegSteps], bv[kSegSteps];
    float p = 1.f, e = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      cp_async_wait_upto(kGroups - 1 - g);
      __syncwarp();   // the group's pieces of every lane of the warp
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = g * kGroup + j;
        av[i] = 1.f;
        bv[i] = 0.f;
        if (i < steps) {
          av[i] = expf(s_a[i * kLanes + lane]);
          bv[i] = s_b[i * kLanes + lane];
          e = fmaf(av[i], e, bv[i]);
          p *= av[i];
        }
      }
    }
    // 3. warp 0 composes the CTA's aggregate and pushes it to every rank
    s_seg[warp][lane] = make_float2(p, e);
    __syncthreads();
    if (warp == 0) {
      float P = 1.f, E = 0.f;
#pragma unroll
      for (int s = 0; s < kWarps; ++s) {
        const float2 g = s_seg[s][lane];
        E = fmaf(g.x, E, g.y);
        P *= g.x;
      }
      const uint32_t slot = smem_u32(&s_agg[rank][lane]);
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        st_async_f32x2(mapa(slot, r), P, E, mapa(bar, r));
    }
    // 4. every rank's aggregate: the carry into this segment (the ranks
    // before this one, then the warps before this one) and the state
    // entering the next window (all ranks)
    mbar_wait(bar, phase);
    float c = h;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r == rank) c = h;
      const float2 g = s_agg[r][lane];
      h = fmaf(g.x, h, g.y);
    }
    for (int s = 0; s < warp; ++s) {
      const float2 g = s_seg[s][lane];
      c = fmaf(g.x, c, g.y);
    }
    // 5. the segment again from its carry, storing y
#pragma unroll
    for (int i = 0; i < kSegSteps; ++i) {
      if (i < n) {
        c = fmaf(av[i], c, bv[i]);
        y[(t0 + i) * a.y_ss] = c;
      }
    }
    if (n > 0 && t0 + n == a.S) a.h_T[(long long)b * a.W + w] = c;
    if (tw + window < a.S) {   // every rank is done with this window's slots
      cluster_arrive();
      cluster_wait();
    }
  }
  // no CTA leaves while a push to it may still be in flight
  cluster_arrive_relaxed();
  cluster_wait();
}

cudaLaunchConfig_t launch_config(int B, int S, int W, cudaStream_t stream,
                                 cudaLaunchAttribute* attr, RglruArgs* a) {
  a->steps = segment_steps(S);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((W + kLanes - 1) / kLanes * kCluster), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 2 * a->steps * kThreads * sizeof(float);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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
  const auto aligned = [](const void* p, long long sb, long long ss) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0
           && ss % 4 == 0;
  };
  a.vec = aligned(log_a, a.la_sb, a.la_ss) && aligned(bx, a.bx_sb, a.bx_ss);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      B, S, W, static_cast<cudaStream_t>(stream), attr, &a);
  err = cudaLaunchKernelEx(&cfg, rglru_scan_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many of the kernel's clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) at a (B, S, W) launch.
extern "C" int pb_rglru_max_active_clusters(int device, int B, int S, int W,
                                            int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  RglruArgs a;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, S, W, nullptr, attr, &a);
  return cudaOccupancyMaxActiveClusters(clusters, rglru_scan_kernel, &cfg);
}
