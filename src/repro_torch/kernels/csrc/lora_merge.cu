// Fused merged-LoRA weight update for Hopper: W' = W + scale * (A @ B)
// over stacked layers, float32 accumulation, stored in W's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lora_merge.py
// (lora_merge / _lora_kernel), the adapter switch of paper section 4.3.2.
//
// Bound on the H100: the bytes of W (read once) and W' (written once).
// The rank-r product costs 2r + 1 FLOPs per element of W, against 4 bytes
// moved per bf16 element: at r = 16 that is 8 FLOPs per byte, under the
// ridge of the float32 CUDA cores (67 TFLOP/s over 3.35 TB/s, 20 FLOPs per
// byte), so the products stay on the CUDA cores, in full float32 (no
// TF32) for either dtype of W.
//
// Design: a persistent grid streams W.
// - Tiles of 64 rows x 128 columns of one layer are numbered down each
//   column strip of W ((layer, column block), then row block); each CTA
//   of 128 threads takes a contiguous run of them, sized so that a few
//   CTAs per SM cover the whole of W in one wave.  A run walks down one
//   or two strips, so the CTA stages B's column block (r x 128 float32)
//   in shared memory once per strip.
// - W first, a tile ahead: each thread copies its own 8 x 8 block of W (8
//   rows of 16 bytes in bf16, 32 bytes in float32) with cp.async into a
//   two-stage shared-memory ring, the next tile's before this tile's
//   delta is computed, so the HBM stream runs under the rank-r product.
//   A thread reads back only what it copied itself, so the ring needs no
//   barrier, and W holds no registers.  In bf16 the kernel takes 149
//   registers, so 3 CTAs share an SM (4 CTAs at 128 registers were
//   slower).
// - A's row block (64 x r float32, contiguous in A) is double-buffered:
//   the next tile's block is loaded into registers while this tile's
//   delta is computed, and written (transposed, k-major) to the other
//   shared buffer at the start of the next tile.
// - Register tiles: each thread owns 8 rows x 8 consecutive columns and
//   reads a[8] and b[8] from shared memory once per rank step (two
//   16-byte loads each) for 64 FMAs, about 16 bytes of shared memory per
//   element of W at r = 16.  B's shared rows put 4 spare floats after
//   every 32 columns, so the 8 threads of a quarter warp read 8 distinct
//   16-byte bank groups; A's shared rows are 68 floats, so the transposed
//   writes of a warp spread over the banks.
//
// Layouts (contiguous): W, out (L, Din, Dout); A (L, Din, r) float32;
// B (L, r, Dout) float32, 16-byte aligned.  Dout % 8 == 0, 1 <= r <= 32;
// Din and Dout need not be multiples of the tile.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace pb;

constexpr int kBI = 64, kBJ = 128, kMaxRank = 32;
constexpr int kThreads = 128;
constexpr int kTR = 8, kTC = 8;                    // a thread's rows, columns
constexpr int kColGroups = kBJ / kTC;              // 16
constexpr int kBPitch = kBJ + kBJ / 32 * 4;        // 144 floats a B row
constexpr int kAPitch = kBI + 4;                   // 68 floats an A row
constexpr int kAPerThread = kBI * kMaxRank / kThreads;   // 16

struct LoraArgs {
  const void* W; const float* A; const float* B; void* out;
  int Din, Dout, r, tiles_i, tiles_j;
  long long n_tiles;
  float scale;
};

// shared column of B's column j: 4 spare floats after every 32
__device__ __forceinline__ int bcol(int j) { return j + (j >> 5) * 4; }

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* out) {
  constexpr int M = 16 / (int)sizeof(T);
  T e[M];
  memcpy(e, &v, 16);
#pragma unroll
  for (int i = 0; i < M; ++i) out[i] = to_float(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in) {
  constexpr int M = 16 / (int)sizeof(T);
  T e[M];
#pragma unroll
  for (int i = 0; i < M; ++i) e[i] = from_float<T>(in[i]);
  uint4 v;
  memcpy(&v, e, 16);
  return v;
}

// shared memory (bytes): A's two k-major buffers, B's column block, then
// the two stages of W's tile
constexpr int kOffB = 2 * kMaxRank * kAPitch * 4;
constexpr int kOffW = kOffB + kMaxRank * kBPitch * 4;
template <typename T>
constexpr int smem_bytes() { return kOffW + 2 * kBI * kBJ * (int)sizeof(T); }

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
lora_merge_kernel(const LoraArgs a) {
  constexpr int kLoad = 16 / sizeof(T);      // elements per 16-byte access
  constexpr int kVecs = kTC / kLoad;         // 16-byte accesses a row
  constexpr int kRowBytes = kBJ * (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  auto as = reinterpret_cast<float (*)[kMaxRank][kAPitch]>(smem);
  auto bs = reinterpret_cast<float (*)[kBPitch]>(smem + kOffB);
  uint8_t* wring = smem + kOffW;
  const int t = threadIdx.x, r = a.r;
  const int cj = (t % kColGroups) * kTC, ri = (t / kColGroups) * kTR;
  const long long per = a.n_tiles / gridDim.x, extra = a.n_tiles % gridDim.x;
  const long long first = blockIdx.x * per + min((long long)blockIdx.x, extra);
  const long long last = first + per + (blockIdx.x < extra ? 1 : 0);
  const int a_elems = kBI * r;

  // A's row block of `tile` into registers (rows past Din as zeros)
  float areg[kAPerThread];
  auto load_a = [&](long long tile) {
    const long long strip = tile / a.tiles_i;
    const int i0 = (int)(tile - strip * a.tiles_i) * kBI;
    const int l = (int)(strip / a.tiles_j);
    const int valid = min(kBI, a.Din - i0) * r;
    const float* src = a.A + ((long long)l * a.Din + i0) * r;
#pragma unroll
    for (int m = 0; m < kAPerThread; ++m) {
      const int e = t + m * kThreads;
      areg[m] = e < valid ? __ldg(src + e) : 0.f;
    }
  };

  // this thread's 8 x 8 block of `tile`: its first element, and whether
  // its rows and columns lie inside W
  struct Block { long long off; int rows; bool cols; };
  auto block_of = [&](long long tile) {
    const long long strip = tile / a.tiles_i;
    const int i0 = (int)(tile - strip * a.tiles_i) * kBI;
    const int l = (int)(strip / a.tiles_j);
    const int j = (int)(strip - (long long)l * a.tiles_j) * kBJ + cj;
    return Block{((long long)l * a.Din + i0 + ri) * a.Dout + j,
                 min(kTR, a.Din - i0 - ri), j < a.Dout};
  };
  // this thread's 8 x 8 block of W into ring stage `stage`, as one
  // cp.async group
  auto request_w = [&](long long tile, int stage) {
    const Block blk = block_of(tile);
    const T* src = static_cast<const T*>(a.W) + blk.off;
    uint8_t* dst = wring + stage * kBI * kRowBytes + ri * kRowBytes
                   + cj * (int)sizeof(T);
#pragma unroll
    for (int e = 0; e < kTR; ++e) {
      const bool ok = blk.cols && e < blk.rows;
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
        cp_async16(smem_u32(dst + e * kRowBytes + v * 16),
                   ok ? src + (long long)e * a.Dout + v * kLoad : a.W, ok);
    }
    cp_async_commit();
  };

  if (first < last) {
    request_w(first, 0);
    load_a(first);
  }
  long long cur_strip = -1;
  int buf = 0;
  for (long long tile = first; tile < last; ++tile) {
    const long long strip = tile / a.tiles_i;
    const int l = (int)(strip / a.tiles_j);
    const int j0 = (int)(strip - (long long)l * a.tiles_j) * kBJ;
    const Block blk = block_of(tile);

    // ---- W first: the next tile's block, a tile ahead ----
    if (tile + 1 < last) request_w(tile + 1, buf ^ 1);
    else cp_async_commit();

    // ---- B's column block, once per strip ----
    if (strip != cur_strip) {
      __syncthreads();              // every thread is done with the old one
      const float* src = a.B + (long long)l * r * a.Dout;
      for (int idx = t; idx < r * (kBJ / 4); idx += kThreads) {
        const int k = idx / (kBJ / 4), c = (idx % (kBJ / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + c < a.Dout)
          v = __ldg(reinterpret_cast<const float4*>(
              src + (long long)k * a.Dout + j0 + c));
        *reinterpret_cast<float4*>(&bs[k][bcol(c)]) = v;
      }
      cur_strip = strip;
    }

    // ---- this tile's A block into its buffer, k-major; then prefetch
    //      the next tile's into registers ----
#pragma unroll
    for (int m = 0; m < kAPerThread; ++m) {
      const int e = t + m * kThreads;
      if (e < a_elems) as[buf][e % r][e / r] = areg[m];
    }
    __syncthreads();
    if (tile + 1 < last) load_a(tile + 1);

    // ---- the rank-r delta of the 8 x 8 block, float32 ----
    float d[kTR][kTC];
#pragma unroll
    for (int e = 0; e < kTR; ++e)
#pragma unroll
      for (int c = 0; c < kTC; ++c) d[e][c] = 0.f;
    const float* arow = &as[buf][0][ri];
    const float* brow = &bs[0][bcol(cj)];
    for (int k = 0; k < r; ++k) {
      const float4* ap = reinterpret_cast<const float4*>(arow + k * kAPitch);
      const float4* bp = reinterpret_cast<const float4*>(brow + k * kBPitch);
      const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
      const float av[kTR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < kTR; ++e)
#pragma unroll
        for (int c = 0; c < kTC; ++c) d[e][c] += av[e] * bv[c];
    }

    // ---- W' = W + scale * delta, W from this thread's own copies ----
    cp_async_wait<1>();
    const uint8_t* wsrc = wring + buf * kBI * kRowBytes + ri * kRowBytes
                          + cj * (int)sizeof(T);
#pragma unroll
    for (int e = 0; e < kTR; ++e) {
      if (!(blk.cols && e < blk.rows)) continue;
      uint4* op = reinterpret_cast<uint4*>(
          static_cast<T*>(a.out) + blk.off + (long long)e * a.Dout);
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        float f[kLoad];
        unpack16<T>(*reinterpret_cast<const uint4*>(
            wsrc + e * kRowBytes + v * 16), f);
#pragma unroll
        for (int c = 0; c < kLoad; ++c) f[c] += a.scale * d[e][v * kLoad + c];
        __stcs(op + v, pack16<T>(f));
      }
    }
    buf ^= 1;
  }
}

template <typename T>
cudaError_t launch_t(LoraArgs a, int L, int device, cudaStream_t stream) {
  a.tiles_i = (a.Din + kBI - 1) / kBI;
  a.tiles_j = (a.Dout + kBJ - 1) / kBJ;
  a.n_tiles = (long long)L * a.tiles_j * a.tiles_i;
  constexpr int bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      lora_merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lora_merge_kernel<T>, kThreads, bytes);
  if (err != cudaSuccess) return err;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = a.n_tiles < fill ? a.n_tiles : fill;
  lora_merge_kernel<T><<<(unsigned)grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pb_lora_merge(int dtype, int device, const void* W,
                             const void* A, const void* B, void* out, int L,
                             int Din, int Dout, int r, float scale,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (r < 1 || r > kMaxRank || Dout % kTC != 0) return cudaErrorInvalidValue;
  if (L <= 0 || Din <= 0 || Dout <= 0) return cudaSuccess;
  LoraArgs a;
  a.W = W; a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B); a.out = out;
  a.Din = Din; a.Dout = Dout; a.r = r; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) return launch_t<__nv_bfloat16>(a, L, device, s);
  if (dtype == kDtypeF32) return launch_t<float>(a, L, device, s);
  return cudaErrorInvalidValue;
}
