// Sweep 2 of the whole-block kernels (flat_block.cu, flat_s2.cu,
// mega_block.cu): the SE gate, the gated 1x1 projection, its bias and the
// residual.
//
//   gate = clip(relu((sums / HW) @ D0 + b0) @ D1 + b1, 0, 1)       (f32)
//   y    = round((hidden * round(gate)) @ Wp [f32 acc] + pb) (+ x)
//
// with the rounding points of flatblock._flat_kernel's second sweep: the gate
// multiplies the hidden in the I/O dtype, the projection accumulates in f32,
// the bias is added in f32, the sum is cast, and the residual is added in the
// I/O dtype.
//
// The SE gate needs the sums over every pixel of an image, which come from
// all CTAs of the first sweep: on the TPU one grid step owns the whole image,
// on Hopper the barrier is the boundary between launches.  A small kernel
// (se_gate_kernel, one CTA per image) takes each image's gate once into an
// (N, E) f32 scratch; the projection kernels read it.
//
// What bounds it on an H100: one read of the hidden (d10 at 512px batch 8:
// 1.0 GB of bf16, 0.30 ms at 3.35 TB/s) against E x C_out MACs per pixel,
// 24-128 MACs per byte read at the model's bf16 shapes, far below the ~295
// at which the tensor cores would bound it (f32: half as many per byte, at
// a third of the TF32 rate with 3xTF32, still below).  So the design is a
// stream of the hidden, not a product.
//
// Design:
//   * bf16 with E % 8 == 0 and an even C_out <= 128 (every block of the
//     model, at every size), gate_project_mma: persistent CTAs (as many as
//     fit on the card), each taking one contiguous run of (image, 128-pixel
//     tile) items.  A producer warp streams the run's hidden as TMA boxes
//     of 128 pixels x 64 channels (16 KB, 128-byte swizzle, zeros past E
//     and past the image) through a ring of SLOTS slots; a slot is refilled
//     only after the consumer warps have released it.  The consumers hold
//     the projection matrix (transposed, zero-padded to a multiple of 64 in
//     E, rows 4 banks apart, staged with 16-byte loads) and their image's
//     gate (bf16) in shared memory.  Up to C_out 96 four consumer warps
//     each own 32 pixels x all of C_out: each reads its A fragments from
//     the swizzled box with ldmatrix (conflict-free), multiplies them by
//     the gate as packed bf16 products (round(h * round(g)) of two bf16
//     values is one rounding of an exact product: the bits of the TPU
//     kernel's bf16 multiply), and runs mma.sync m16n8k16 with f32
//     accumulation across the boxes of a tile, its accumulators sized for
//     C_out <= 32, <= 48 or <= 96 (32, 48 or 96 per thread; the largest
//     asks for one CTA per SM, so they never spill).  C_out <= 128 (1024px
//     and up, the 128px stage) runs eight consumer warps, two warpgroups
//     of 64 pixels, whose products are wgmma m64n128k16 with A, the same
//     gated fragments, in registers and B, the matrix, in shared memory
//     (K-major, 128-byte swizzle): mma.sync's tensor rate held this
//     bucket to ~35% of its bound, the sweep's bytes no longer hide under
//     its products.  The box is released once its fragments are in
//     registers.  The tile's residual, one contiguous run, is prefetched
//     into L2 while its boxes stream, and loaded before any store.
//   * The gate comes from se_gate_staged (D0, D1 bulk-copied into shared
//     memory; se_gate_kernel waited ~40 us on a chain of L2 reads) wherever
//     D0 and D1 fit in shared memory and are 16-byte aligned, whatever the
//     design; se_gate_kernel takes the rest and the earlier sweep 2 that
//     the A/B forces (designed false).  The consumers of the C_out-128
//     bucket and of the f32 design stage the matrix while the producer
//     already streams.
//   * f32 with E % 4 == 0 and an even C_out <= 128 (every block of the
//     model), gate_project_tf32: the same persistent stream, eight consumer
//     warps of 16 pixels, boxes of 128 pixels x 32 f32 channels (128-byte
//     rows, the same swizzle and ldmatrix addresses: an 8 x 8 b16 matrix is
//     8 pixels x 4 f32 channels), the projection matrix resident in f32
//     (rows unpadded, their 16-byte groups XOR-swizzled by row:
//     conflict-free ldmatrix, and C_out 128 x E 384 fits beside two slots)
//     and the gate in f32.  Each gated value is rounded to f32 once
//     (h * g), split into TF32 hi + lo, and multiplied by the split weights
//     on the tensor cores as 3xTF32 (lo hi + hi lo + hi hi, mma.sync
//     m16n8k8: ~f32 accuracy; hi truncated, so lo * lo, the term left out,
//     stays below 2^-20 of a product), four output tiles at a time in three
//     passes (a tile's three products share an accumulator), every two k8
//     steps' products into partials from zero that an f32 add to nearest
//     takes into the accumulators (accumulating every product in the
//     tensor cores' f32, which truncates, put the 512px f32 "flat-all"
//     image at 1.16e-5 mean abs from the twins', past the routes' 1e-5
//     gate; the parent's f32 kernel 6.5e-6).  The ring has as many slots (2-4) as let two CTAs share
//     an SM up to C_out 48, else as many as fit one (tf32_slots).  (The
//     other design, a register-tiled CUDA-core product, would do the same
//     FMAs at the 67 TFLOP/s f32 peak, above the f32 bytes' time at C_out
//     80-96; the tensor cores take 3x the work at 495.)
//   * otherwise (odd C_out, E not a multiple of the vector width, unaligned
//     tensors, or past a CTA's shared memory): gate_project_generic, a
//     CUDA-core path, one CTA per run of 32-pixel tiles, 32 pixels x 32
//     channels per step in f32, up to 16 outputs per thread.
//   * YT (the mega route): y and the residual are (N, H, C_out, W) with W
//     contiguous; the hidden stays pixel-major (NHWC).  Where a 128-pixel
//     tile lies in one image row (W % 128 == 0, every mega block; y and the
//     residual 16-byte aligned), each bf16 consumer warp stages each
//     8-channel column of its 32 (16) pixels as [channel][pixel] in shared
//     memory (2.5 KB per CTA, 5 KB with eight warps) and each lane writes
//     8 pixels of one channel with one 16-byte store: 64 (32) contiguous
//     bytes per channel and warp, whole sectors.  The tile's residual,
//     C_out runs of 256 bytes, is prefetched into L2 while the hidden
//     streams and read the same way, added in bf16 after the rounded
//     projection (the bits of the one-value path).  Other W: one value at
//     a time.  In f32 the fragment's 8 pixels of one channel are 32
//     contiguous bytes already: one value at a time, whole sectors.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace ast_kernels {
namespace gp {
// Internal linkage: every source that includes this header gets its own
// copy of the kernels, so no two objects of the library share a symbol.
namespace {

constexpr int NTHREADS = 256;   // CUDA-core path
constexpr int GTP = 32;         // pixels per tile (CUDA-core path)
constexpr int GKC = 32;         // channels per step (CUDA-core path)
constexpr int MAX_OPT = 16;     // outputs per thread: C_out <= 128
constexpr int TARGET_CTAS = 132 * 8;
constexpr int TP = 128;         // pixels per tile (MMA path)
constexpr int KB = 64;          // channels per box: 128-byte rows
constexpr int BOX_BYTES = TP * KB * 2;
constexpr int SLOTS = 4;        // ring slots
constexpr int CONSUMERS = 4;    // consumer warps, 32 pixels each
constexpr int MAX_NT = 16;      // 8-wide output tiles: C_out <= 128
constexpr int YS_LD = 40;       // YT staging row: 32 pixels + 16 bytes
// The accumulators' 8-wide output tiles by C_out: <= 32 (most blocks),
// <= 48 (C_out 40), <= 96, <= 128 (1024px's 128px stage).
constexpr int MID_NT = 12;
constexpr int NT_BUCKETS[4] = {4, 6, MID_NT, MAX_NT};
constexpr int KB32 = 32;        // f32 channels per box (tf32 path): 128 B
static_assert(TP * KB32 * 4 == BOX_BYTES, "f32 boxes are the bf16 size");
constexpr int WIDE_WARPS = 8;   // consumer warps of 16 pixels
static_assert(WIDE_WARPS * 16 == TP, "16 pixels per wide consumer warp");
constexpr int TF_THREADS = (WIDE_WARPS + 1) * 32;  // gate_project_tf32
constexpr int TF_GROUP = 4;     // its output tiles per pass of products
constexpr int WK_BLOCK = 128 * 128;  // wgmma B: 64 channels x 128 outputs

// Consumer warps of gate_project_mma at this C_out: past C_out 96 eight,
// two warpgroups of 64 pixels for wgmma (16 pixels per warp); four of 32
// pixels in the others.
__host__ __device__ constexpr int mma_warps(int cout) {
  return cout > MID_NT * 8 ? WIDE_WARPS : CONSUMERS;
}
static_assert(CONSUMERS * 32 == TP, "32 pixels per consumer warp");

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The design of this source's last sweep-2 launch: 0 gate_project_generic,
// 1 gate_project_mma, 2 gate_project_tf32; -1 before any.
inline int& last_design() {
  static int v = -1;
  return v;
}

// The SE gate of image blockIdx.x into gate (n, e), rounded to T.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    se_gate_kernel(const float* __restrict__ sums,
                   const float* __restrict__ d0t,
                   const float* __restrict__ d0b,
                   const float* __restrict__ d1k,
                   const float* __restrict__ d1b, float* __restrict__ gate,
                   int E, int S, float inv_hw) {
  extern __shared__ float4 smem4[];
  float* mean_s = reinterpret_cast<float*>(smem4);
  float* h1_s = mean_s + round_up(E, 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* sums_n = sums + (size_t)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += NTHREADS)
    mean_s[e] = sums_n[e] * inv_hw;
  __syncthreads();
  // h1 = relu(mean @ D0 + b0): one warp per hidden unit, lanes over E.
  for (int s = warp; s < S; s += NTHREADS / 32) {
    float a = 0.f;
    for (int e = lane; e < E; e += 32)
      a = fmaf(mean_s[e], d0t[(size_t)s * E + e], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) h1_s[s] = fmaxf(a + d0b[s], 0.f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += NTHREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) a = fmaf(h1_s[s], d1k[(size_t)s * E + e], a);
    gate[(size_t)blockIdx.x * E + e] =
        round_to<T>(fminf(fmaxf(a + d1b[e], 0.f), 1.f));
  }
}

// se_gate_kernel with D0 and D1 (S x E f32 each, S * E % 4 == 0) brought
// into shared memory by one bulk copy each, so the products read shared
// memory where se_gate_kernel waits on a chain of L2
// reads (~40 us per launch at E 384 before the projection can start).  The
// same sums in the same order: the same bits.  Shared memory: D [S][E],
// the mean [E4], h1 [S4] (f32) and the copy's barrier (gate_smem).
__host__ __device__ inline int gate_smem(int e, int s) {
  return (s * e + round_up(e, 4) + round_up(s, 4)) * 4 + 8;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    se_gate_staged(const float* __restrict__ sums,
                   const float* __restrict__ d0t,
                   const float* __restrict__ d0b,
                   const float* __restrict__ d1k,
                   const float* __restrict__ d1b, float* __restrict__ gate,
                   int E, int S, float inv_hw) {
  extern __shared__ float4 smem4[];
  float* dbuf = reinterpret_cast<float*>(smem4);
  float* mean_s = dbuf + S * E;
  float* h1_s = mean_s + round_up(E, 4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(h1_s + round_up(S, 4));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t bytes = (uint32_t)S * E * 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, bytes);
    bulk_load(dbuf, d0t, bytes, bar);
  }
  const float* sums_n = sums + (size_t)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += NTHREADS)
    mean_s[e] = sums_n[e] * inv_hw;
  __syncthreads();
  mbar_wait(bar, 0);
  // h1 = relu(mean @ D0 + b0): one warp per hidden unit, lanes over E.
  for (int s = warp; s < S; s += NTHREADS / 32) {
    float a = 0.f;
    for (int e = lane; e < E; e += 32)
      a = fmaf(mean_s[e], dbuf[s * E + e], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) h1_s[s] = fmaxf(a + d0b[s], 0.f);
  }
  __syncthreads();  // h1 is whole and D0's readers are done
  if (threadIdx.x == 0) {
    fence_proxy_async();
    mbar_expect_tx(bar, bytes);
    bulk_load(dbuf, d1k, bytes, bar);
  }
  mbar_wait(bar, 1);
  for (int e = threadIdx.x; e < E; e += NTHREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) a = fmaf(h1_s[s], dbuf[s * E + e], a);
    gate[(size_t)blockIdx.x * E + e] =
        round_to<T>(fminf(fmaxf(a + d1b[e], 0.f), 1.f));
  }
}

// Offset of output (pixel p, channel c) within an image: NHWC, or
// (H, C, W) with YT.
template <bool YT>
__device__ __forceinline__ size_t out_at(int p, int c, int cout, int W) {
  if constexpr (YT) {
    const int gy = p / W;
    return ((size_t)gy * cout + c) * W + (p - gy * W);
  }
  return (size_t)p * cout + c;
}

// Shared memory of gate_project_mma (byte offsets from a 1024-byte aligned
// base): the ring, the projection matrix (up to C_out 96 [nt * 8][ldw]
// bf16; past it wgmma's K-major B, ep / 64 blocks of 128 outputs x 64
// channels, 128-byte rows, 16-byte chunk q of row n at q ^ (n % 8)), the
// gate [ep] bf16, (YT) each consumer warp's staging of 8 channels x its 32
// (or 16) pixels, bf16 [8][YS_LD], and the ring's barriers.
struct MmaSmem {
  int ep, ldw, wt, gate, ys, bars, total;
  __host__ __device__ MmaSmem(int E, int cout, bool yt = false) {
    ep = round_up(E, KB);
    ldw = ep + 8;  // rows 4 banks apart: conflict-free B fragments
    wt = SLOTS * BOX_BYTES;
    gate = wt + (mma_warps(cout) == WIDE_WARPS
                     ? ep / KB * WK_BLOCK
                     : (cout + 7) / 8 * 8 * ldw * 2);
    ys = gate + ep * 2;
    bars = ys + (yt ? mma_warps(cout) * 8 * YS_LD * 2 : 0);
    total = 1024 + bars + 2 * SLOTS * 8;  // + the alignment slack
  }
};

// hmap: the hidden as a 3-d map (E, HW, N), boxes of 64 x TP x 1; gate
// (N, E) from the gate kernel.  The CTA takes items [begin, end) of the
// N * tiles_per_image (image, tile) items.  NT: the accumulators' 8-wide
// output tiles, one of NT_BUCKETS (8 * NT accumulators per thread).  The
// two largest instances ask for one CTA per SM, so their accumulators
// never spill: at the model's C_out > 48 (E >= 288) the ring and the
// matrix take over half of the shared memory anyway.  The C_out-128 bucket
// runs 8 consumer warps of 16 pixels (mma_warps) and reads its B fragments
// two output tiles at a time with ldmatrix.  yt_rows (YT only): every tile
// lies in one image row (W % TP == 0) and y and the residual are 16-byte
// aligned, so the epilogue writes whole channel runs (see below).
template <bool RES, bool YT, int NT>
__global__ void __launch_bounds__((mma_warps(NT * 8) + 1) * 32,
                                  NT >= 12 ? 1 : 2)
    gate_project_mma(const __grid_constant__ CUtensorMap hmap,
                     const float* __restrict__ gate,
                     const __nv_bfloat16* __restrict__ wpt,
                     const float* __restrict__ pb,
                     const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ y, int HW, int W, int E,
                     int cout, int tiles_per_image, int total, int yt_rows) {
  constexpr int CW = mma_warps(NT * 8);  // consumer warps
  constexpr int MI = TP / (CW * 16);     // 16-pixel row tiles per warp
  constexpr int THREADS = (CW + 1) * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const MmaSmem L(E, cout, YT);
  unsigned char* ring = smem;
  __nv_bfloat16* wT = reinterpret_cast<__nv_bfloat16*>(smem + L.wt);
  __nv_bfloat16* gate_s = reinterpret_cast<__nv_bfloat16*>(smem + L.gate);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + SLOTS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt_count = (cout + 7) / 8;
  const int nk = L.ep / KB;  // boxes per tile
  const int begin = (int)((long long)blockIdx.x * total / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * total / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CW);
    }
    mbar_fence_init();
  }
  // The projection matrix, 8 channels per 16-byte copy (E % 8 == 0), by
  // `threads` threads from thread `tid`.
  auto stage_w = [&](int tid, int threads) {
    const int nv = L.ep / 8;
    if constexpr (CW == WIDE_WARPS) {
      // wgmma's B: row n of block e / 64, its chunk q at q ^ (n % 8).
      for (int idx = tid; idx < 128 * nv; idx += threads) {
        const int kb = idx / (128 * 8), n = idx / 8 % 128, q = idx % 8;
        const int e = kb * KB + q * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n < cout && e < E)
          v = *reinterpret_cast<const uint4*>(wpt + (size_t)n * E + e);
        *reinterpret_cast<uint4*>(smem + L.wt + kb * WK_BLOCK + n * 128 +
                                  ((q ^ (n & 7)) << 4)) = v;
      }
    } else {
      for (int idx = tid; idx < nt_count * 8 * nv; idx += threads) {
        const int c = idx / nv, e = idx % nv * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < cout && e < E)
          v = *reinterpret_cast<const uint4*>(wpt + (size_t)c * E + e);
        *reinterpret_cast<uint4*>(wT + c * L.ldw + e) = v;
      }
    }
    for (int e = E + tid; e < L.ep; e += threads)
      gate_s[e] = __float2bfloat16_rn(0.f);
  };
  if constexpr (CW == WIDE_WARPS) {
    // The producer streams from the start; the consumers stage the matrix
    // meanwhile, published by their first gate barrier.  wgmma reads the
    // matrix through the async proxy: each staging thread fences its
    // generic stores before that barrier.
    __syncthreads();
    if (begin >= end) return;
    if (warp < CW) {
      stage_w(threadIdx.x, CW * 32);
      fence_proxy_async();
    }
  } else {
    stage_w(threadIdx.x, THREADS);
    __syncthreads();
    if (begin >= end) return;
  }
  const int nbox = (end - begin) * nk;

  if (warp == CW) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int j = 0; j < nbox; ++j) {
        const int s = j % SLOTS;
        if (j >= SLOTS) mbar_wait(&empty[s], (j / SLOTS - 1) & 1);
        const int it = begin + j / nk, kc = j % nk;
        const int n = it / tiles_per_image, t = it % tiles_per_image;
        mbar_expect_tx(&full[s], BOX_BYTES);
        tma_load_3d(ring + s * BOX_BYTES, &hmap, kc * KB, t * TP, n,
                    &full[s]);
      }
    }
    return;
  }

  // Consumers.
  const int g = lane >> 2, tig = lane & 3;
  int gate_n = -1;
  int j = 0;  // boxes consumed
  for (int it = begin; it < end; ++it) {
    const int n = it / tiles_per_image, t = it % tiles_per_image;
    if (n != gate_n) {  // this image's gate, rounded, as bf16
      named_barrier(CW * 32);  // the previous gate's readers are done
      for (int e = threadIdx.x; e < E; e += CW * 32)
        gate_s[e] = __float2bfloat16_rn(gate[(size_t)n * E + e]);
      named_barrier(CW * 32);
      gate_n = n;
    }
    const __nv_bfloat16* rn = RES ? res + (size_t)n * HW * cout : nullptr;
    __nv_bfloat16* yn = y + (size_t)n * HW * cout;
    // The tile's image row and first column (yt_rows).
    const int gy = t * TP / W, gx0 = t * TP - gy * W;
    if constexpr (RES && !YT) {
      // The tile's residual is one contiguous run: bring it into L2 while
      // the hidden streams, so the epilogue does not wait on HBM.
      const char* run =
          reinterpret_cast<const char*>(rn + (size_t)t * TP * cout);
      const int bytes = min(TP, HW - t * TP) * cout * 2;
      for (int o = threadIdx.x * 128; o < bytes; o += CW * 32 * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(run + o));
    } else if constexpr (RES) {
      // (N, H, C, W): the tile's residual is C_out runs of TP values, one
      // per channel, two 128-byte lines each.
      if (yt_rows)
        for (int o = threadIdx.x; o < cout * 2; o += CW * 32)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              rn + ((size_t)gy * cout + o / 2) * W + gx0 + (o % 2) * 64));
    }
    float acc[MI][NT][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++j) {
      const int s = j % SLOTS;
      mbar_wait(&full[s], (j / SLOTS) & 1);
      const unsigned char* box = ring + s * BOX_BYTES;
      if constexpr (CW == WIDE_WARPS) {
        // The box's gated A fragments into registers, the slot released,
        // then each warpgroup's (64 pixels) four k16 products, all 128
        // outputs at once, on the tensor cores (wgmma, B = the matrix).
        float (&accw)[NT * 4] = reinterpret_cast<float (&)[NT * 4]>(acc);
        uint32_t a[KB / 16][4];
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks) {
          const int k = kc * KB + ks * 16 + tig * 2;
          const uint32_t g0 = lds32(gate_s + k), g8 = lds32(gate_s + k + 8);
          const int r = warp * 16 + (lane & 15);
          const int q = ks * 2 + (lane >> 4);
          ldmatrix_x4(a[ks], box + r * 128 + ((q ^ (r & 7)) << 4));
          a[ks][0] = bf16x2_mul(a[ks][0], g0);
          a[ks][1] = bf16x2_mul(a[ks][1], g0);
          a[ks][2] = bf16x2_mul(a[ks][2], g8);
          a[ks][3] = bf16x2_mul(a[ks][3], g8);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        reg_fence(accw);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks)
          wgmma_rs_n128<0, NT * 4, 0>(
              accw, a[ks],
              smem_desc(smem + L.wt + kc * WK_BLOCK + ks * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(accw);
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks)  // read by the products
          asm volatile("" ::"r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]),
                       "r"(a[ks][3]));
      } else {
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks) {
          const int k = kc * KB + ks * 16 + tig * 2;
          const uint32_t g0 = lds32(gate_s + k), g8 = lds32(gate_s + k + 8);
          uint32_t a[MI][4];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            // Row r of the box, 16-byte chunk q at chunk q ^ (r % 8).
            const int r = warp * MI * 16 + i * 16 + (lane & 15);
            const int q = ks * 2 + (lane >> 4);
            ldmatrix_x4(a[i], box + r * 128 + ((q ^ (r & 7)) << 4));
            a[i][0] = bf16x2_mul(a[i][0], g0);
            a[i][1] = bf16x2_mul(a[i][1], g0);
            a[i][2] = bf16x2_mul(a[i][2], g8);
            a[i][3] = bf16x2_mul(a[i][3], g8);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt < nt_count) {
              const __nv_bfloat16* bp =
                  wT + (nt * 8 + g) * L.ldw + kc * KB + ks * 16 + tig * 2;
              const uint32_t b[2] = {lds32(bp), lds32(bp + 8)};
              mma_bf16(acc[0][nt], a[0], b);
              mma_bf16(acc[1][nt], a[1], b);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    if constexpr (YT) {
      if (yt_rows) {
        // Whole rows: each 8-channel column of the warp's 32 (16) pixels is
        // staged as [channel][pixel] (rows YS_LD * 2 = 80 bytes apart: the
        // 2-byte stores and the 16-byte reads are conflict-free), then
        // each lane writes 8 pixels of one channel with one 16-byte store,
        // its residual read the same way and added in bf16.  A channel's
        // 32 pixels are 64 contiguous bytes of y: whole sectors.
        __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + L.ys) +
                            warp * 8 * YS_LD;
        const int c8 = lane & 7, chunk = lane >> 3;
        // Eight warps: the lane's residual runs of TF_GROUP tiles are
        // loaded before any of them is stored, so their loads wait on
        // memory together.
        [[maybe_unused]] uint4 rres[TF_GROUP];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (RES && CW == WIDE_WARPS) {
            if (nt % TF_GROUP == 0) {
#pragma unroll
              for (int u = 0; u < TF_GROUP && nt + u < NT; ++u) {
                const int c = (nt + u) * 8 + c8;
                if (nt + u < nt_count && c < cout && chunk < MI * 2)
                  rres[u] = *reinterpret_cast<const uint4*>(
                      rn + ((size_t)gy * cout + c) * W + gx0 +
                      warp * MI * 16 + chunk * 8);
              }
            }
          }
          if (nt >= nt_count) continue;
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int col = nt * 8 + tig * 2 + jj;
                float v = acc[i][nt][2 * half + jj];
                if (pb != nullptr && col < cout) v += pb[col];
                st[(tig * 2 + jj) * YS_LD + i * 16 + g + half * 8] =
                    __float2bfloat16_rn(v);
              }
          __syncwarp();
          const int c = nt * 8 + c8;
          if (c < cout && chunk < MI * 2) {
            const size_t o = ((size_t)gy * cout + c) * W + gx0 +
                             warp * MI * 16 + chunk * 8;
            uint4 v = *reinterpret_cast<const uint4*>(st + c8 * YS_LD +
                                                      chunk * 8);
            if constexpr (RES) {
              uint4 r;
              if constexpr (CW == WIDE_WARPS)
                r = rres[nt % TF_GROUP];
              else
                r = *reinterpret_cast<const uint4*>(rn + o);
              __nv_bfloat162* vv = reinterpret_cast<__nv_bfloat162*>(&v);
              const __nv_bfloat162* rr =
                  reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
              for (int q = 0; q < 4; ++q)
                vv[q] = __floats2bfloat162_rn(
                    __bfloat162float(vv[q].x) + __bfloat162float(rr[q].x),
                    __bfloat162float(vv[q].y) + __bfloat162float(rr[q].y));
            }
            *reinterpret_cast<uint4*>(yn + o) = v;
          }
          __syncwarp();
        }
        continue;
      }
    }
    // Eight warps (NHWC): the residual of every tile first, as above.
    [[maybe_unused]] uint32_t rres[CW == WIDE_WARPS ? NT : 1][2];
    if constexpr (RES && !YT && CW == WIDE_WARPS) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = nt * 8 + tig * 2;
          const int p = t * TP + warp * 16 + g + half * 8;
          if (nt < nt_count && col < cout && p < HW)
            rres[nt][half] = *reinterpret_cast<const uint32_t*>(
                rn + (size_t)p * cout + col);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nt_count) continue;
        const int col = nt * 8 + tig * 2;
        if (col >= cout) continue;  // cout is even: col + 1 < cout too
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = t * TP + warp * MI * 16 + i * 16 + g + half * 8;
          if (p >= HW) continue;
          float v0 = acc[i][nt][2 * half], v1 = acc[i][nt][2 * half + 1];
          if (pb != nullptr) {
            v0 += pb[col];
            v1 += pb[col + 1];
          }
          if constexpr (YT) {
            const size_t o = out_at<true>(p, col, cout, W);
            const float vs[2] = {v0, v1};
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              __nv_bfloat16 out = __float2bfloat16_rn(vs[jj]);
              if (RES)
                out = __float2bfloat16_rn(__bfloat162float(out) +
                                          __bfloat162float(rn[o + jj * W]));
              yn[o + jj * W] = out;
            }
            continue;
          }
          __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
          if (RES) {
            __nv_bfloat162 r;
            if constexpr (CW == WIDE_WARPS)
              r = *reinterpret_cast<const __nv_bfloat162*>(&rres[nt][half]);
            else
              r = *reinterpret_cast<const __nv_bfloat162*>(
                  rn + (size_t)p * cout + col);
            out = __floats2bfloat162_rn(
                __bfloat162float(out.x) + __bfloat162float(r.x),
                __bfloat162float(out.y) + __bfloat162float(r.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(yn + (size_t)p * cout + col) =
              out;
        }
      }
  }
}

// Shared memory of gate_project_tf32 with `slots` ring slots (byte offsets
// from a 1024-byte aligned base): the ring, the projection matrix
// [nt * 8][ep] f32 (each row's 16-byte group q at q ^ (row % 8)), the gate
// [ep] f32 and the ring's barriers (SLOTS of each kind).
struct TfSmem {
  int ep, wt, gate, bars, total;
  __host__ __device__ TfSmem(int E, int cout, int slots) {
    ep = round_up(E, KB32);
    wt = slots * BOX_BYTES;
    gate = wt + (cout + 7) / 8 * 8 * ep * 4;
    bars = gate + ep * 4;
    total = 1024 + bars + 2 * SLOTS * 8;  // + the alignment slack
  }
};

// The ring slots of gate_project_tf32 at this shape: up to C_out 48 (its
// instances that two CTAs per SM can hold) the most of SLOTS..2 with which
// two CTAs share an SM (`sm_smem` bytes, `reserved` of them per CTA), else
// the most with which one CTA fits (`max_smem`), else 0 (the shape takes
// the generic kernel).  ops/kernels/limits.py mirrors it.
inline int tf32_slots(int e, int cout, int max_smem, int sm_smem,
                      int reserved) {
  for (int s = SLOTS; s >= 2 && cout <= NT_BUCKETS[1] * 8; --s) {
    const int t = TfSmem(e, cout, s).total;
    if (t <= max_smem && 2 * (t + reserved) <= sm_smem) return s;
  }
  for (int s = SLOTS; s >= 2; --s)
    if (TfSmem(e, cout, s).total <= max_smem) return s;
  return 0;
}

// An m16n8k8 A fragment (common.cuh's mma_tf32) split into its TF32 parts
// (split_tf32).
struct TfFrag {
  uint32_t hi[4], lo[4];
};

// gate_project_mma's stream for f32: hmap is the hidden as (E, HW, N) f32,
// boxes of 32 x TP x 1; `slots` ring slots (tf32_slots).  Eight consumer
// warps each own 16 pixels x all of C_out (two per SM sub-partition: the
// loads' latency passes under the other warp's products): ldmatrix reads
// the A fragments (an 8 x 8 b16 matrix is 8 pixels x 4 f32 channels: a0-a3
// as in TfFrag) and two output tiles' B fragments at a time, each value is
// gated (one f32 rounding of h * g, the twin's), split, and multiplied by
// the split weights as 3xTF32 (lo hi, hi lo, hi hi: the small terms
// first) into partials of two k8 steps, added in f32 across the boxes of a
// tile.  Up to C_out 48 two
// CTAs per SM where the shared memory lets them (<= 112 registers); past
// it the matrix leaves room for one (every such block of the model), and
// the accumulators take what they need.
template <bool RES, bool YT, int NT>
__global__ void __launch_bounds__(TF_THREADS, NT >= MID_NT ? 1 : 2)
    gate_project_tf32(const __grid_constant__ CUtensorMap hmap,
                      const float* __restrict__ gate,
                      const float* __restrict__ wpt,
                      const float* __restrict__ pb,
                      const float* __restrict__ res, float* __restrict__ y,
                      int HW, int W, int E, int cout, int tiles_per_image,
                      int total, int slots) {
  constexpr int CW = WIDE_WARPS;  // consumer warps of 16 pixels
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const TfSmem L(E, cout, slots);
  unsigned char* ring = smem;
  float* wT = reinterpret_cast<float*>(smem + L.wt);
  float* gate_s = reinterpret_cast<float*>(smem + L.gate);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + SLOTS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt_count = (cout + 7) / 8;
  const int nk = L.ep / KB32;  // boxes per tile
  const int begin = (int)((long long)blockIdx.x * total / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * total / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CW);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (begin >= end) return;
  const int nbox = (end - begin) * nk;
  if (warp < CW) {
    // The consumers stage the projection matrix while the producer
    // streams, published by their first gate barrier: 4 channels per
    // 16-byte copy (E % 4 == 0), group q of row c at q ^ (c % 8):
    // ldmatrix's eight rows of one group fall in eight distinct groups of
    // banks.
    const int nv = L.ep / 4;
    for (int idx = threadIdx.x; idx < nt_count * 8 * nv; idx += CW * 32) {
      const int c = idx / nv, q = idx % nv;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < cout && q * 4 < E)
        v = *reinterpret_cast<const float4*>(wpt + (size_t)c * E + q * 4);
      *reinterpret_cast<float4*>(wT + c * L.ep + ((q ^ (c & 7)) << 2)) = v;
    }
    for (int e = E + threadIdx.x; e < L.ep; e += CW * 32) gate_s[e] = 0.f;
  }

  if (warp == CW) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int j = 0; j < nbox; ++j) {
        const int s = j % slots;
        if (j >= slots) mbar_wait(&empty[s], (j / slots - 1) & 1);
        const int it = begin + j / nk, kc = j % nk;
        const int n = it / tiles_per_image, t = it % tiles_per_image;
        mbar_expect_tx(&full[s], BOX_BYTES);
        tma_load_3d(ring + s * BOX_BYTES, &hmap, kc * KB32, t * TP, n,
                    &full[s]);
      }
    }
    return;
  }

  // Consumers.
  const int g = lane >> 2, tig = lane & 3;
  int gate_n = -1;
  int j = 0;  // boxes consumed
  for (int it = begin; it < end; ++it) {
    const int n = it / tiles_per_image, t = it % tiles_per_image;
    if (n != gate_n) {  // this image's gate
      named_barrier(CW * 32);  // the previous gate's readers are done
      for (int e = threadIdx.x; e < E; e += CW * 32)
        gate_s[e] = gate[(size_t)n * E + e];
      named_barrier(CW * 32);
      gate_n = n;
    }
    const float* rn = RES ? res + (size_t)n * HW * cout : nullptr;
    float* yn = y + (size_t)n * HW * cout;
    if constexpr (RES) {
      if constexpr (!YT) {
        // The tile's residual is one contiguous run: into L2 while the
        // hidden streams.
        const char* run =
            reinterpret_cast<const char*>(rn + (size_t)t * TP * cout);
        const int bytes = min(TP, HW - t * TP) * cout * 4;
        for (int o = threadIdx.x * 128; o < bytes; o += CW * 32 * 128)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(run + o));
      } else if (W % TP == 0) {
        // (N, H, C, W): C_out runs of TP values, four 128-byte lines each.
        const int gy = t * TP / W, gx0 = t * TP - gy * W;
        for (int o = threadIdx.x; o < cout * 4; o += CW * 32)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              rn + ((size_t)gy * cout + o / 4) * W + gx0 + (o % 4) * 32));
      }
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++j) {
      const int s = j % slots;
      mbar_wait(&full[s], (j / slots) & 1);
      const unsigned char* box = ring + s * BOX_BYTES;
      // Two k8 steps' products into partials from zero, each partial then
      // added to the accumulator in f32 to nearest: accumulating every
      // product in the tensor cores' f32, which rounds toward zero, ~3 E /
      // 8 times per output, put the 512px f32 "flat-all" image at 1.16e-5
      // mean abs from the twins', past the routes' 1e-5 gate (the parent's
      // f32 kernel: 6.5e-6).
      float part[NT][4];
#pragma unroll
      for (int ks = 0; ks < KB32 / 8; ++ks) {
        if (ks % 2 == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
        }
        const int k = kc * KB32 + ks * 8 + tig;
        const float g0 = gate_s[k], g4 = gate_s[k + 4];
        TfFrag a;
        {
          // Row r of the box, 16-byte chunk q at chunk q ^ (r % 8).
          const int r = warp * 16 + (lane & 15);
          const int q = ks * 2 + (lane >> 4);
          uint32_t v[4];
          ldmatrix_x4(v, box + r * 128 + ((q ^ (r & 7)) << 4));
#pragma unroll
          for (int m = 0; m < 4; ++m)
            split_tf32_trunc(__uint_as_float(v[m]) * (m < 2 ? g0 : g4),
                             a.hi[m], a.lo[m]);
        }
        // Two output tiles' B fragments per ldmatrix: lanes 0-7 give tile
        // nt's rows at k 0-3 (b0 = (t, g)), 8-15 at k 4-7 (b1), 16-31 the
        // same of tile nt + 1 (tile nt's again past nt_count).  Four tiles
        // at a time, their three products in three passes, so that no
        // product waits on the one before it (a tile's three share an
        // accumulator).
        const int q0 = kc * (KB32 / 4) + ks * 2 + ((lane >> 3) & 1);
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += TF_GROUP) {
          if (n0 < nt_count) {
            uint32_t bh[TF_GROUP][2], bl[TF_GROUP][2];
#pragma unroll
            for (int u = 0; u < TF_GROUP && n0 + u < NT; u += 2) {
              const int nt = n0 + u;
              if (nt < nt_count) {
                const int c = (nt + ((lane >> 4) != 0 && nt + 1 < nt_count)) *
                                  8 + (lane & 7);
                uint32_t b[4];
                ldmatrix_x4(b, wT + c * L.ep + ((q0 ^ (c & 7)) << 2));
#pragma unroll
                for (int m = 0; m < 4; ++m)
                  split_tf32_trunc(__uint_as_float(b[m]), bh[u + m / 2][m % 2],
                                   bl[u + m / 2][m % 2]);
              }
            }
#pragma unroll
            for (int u = 0; u < TF_GROUP && n0 + u < NT; ++u)
              if (n0 + u < nt_count)
                mma_tf32(part[n0 + u], a.lo, bh[u][0], bh[u][1]);
#pragma unroll
            for (int u = 0; u < TF_GROUP && n0 + u < NT; ++u)
              if (n0 + u < nt_count)
                mma_tf32(part[n0 + u], a.hi, bl[u][0], bl[u][1]);
#pragma unroll
            for (int u = 0; u < TF_GROUP && n0 + u < NT; ++u)
              if (n0 + u < nt_count)
                mma_tf32(part[n0 + u], a.hi, bh[u][0], bh[u][1]);
          }
        }
        if (ks % 2 == 1) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[nt][r] += part[nt][r];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // The residual of a group of tiles is loaded before any of their
    // values is stored, so its loads wait on memory together.
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += TF_GROUP) {
      if (n0 >= nt_count) continue;
      float2 rv[TF_GROUP][2];
#pragma unroll
      for (int u = 0; u < TF_GROUP && n0 + u < NT; ++u)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = (n0 + u) * 8 + tig * 2;
          const int p = t * TP + warp * 16 + g + half * 8;
          rv[u][half] = make_float2(0.f, 0.f);
          if (RES && n0 + u < nt_count && col < cout && p < HW) {
            if constexpr (YT) {
              const size_t o = out_at<true>(p, col, cout, W);
              rv[u][half] = make_float2(rn[o], rn[o + W]);
            } else {
              rv[u][half] = *reinterpret_cast<const float2*>(
                  rn + (size_t)p * cout + col);
            }
          }
        }
#pragma unroll
      for (int u = 0; u < TF_GROUP && n0 + u < NT; ++u) {
        const int nt = n0 + u;
        const int col = nt * 8 + tig * 2;
        if (nt >= nt_count || col >= cout) continue;  // cout even: col + 1 too
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = t * TP + warp * 16 + g + half * 8;
          if (p >= HW) continue;
          float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
          if (pb != nullptr) {
            v0 += pb[col];
            v1 += pb[col + 1];
          }
          v0 += rv[u][half].x;  // 0 without a residual: exact
          v1 += rv[u][half].y;
          if constexpr (YT) {
            // The 8 lanes of one tig write 8 pixels of a channel: 32 bytes.
            const size_t o = out_at<true>(p, col, cout, W);
            yn[o] = v0;
            yn[o + W] = v1;
          } else {
            *reinterpret_cast<float2*>(yn + (size_t)p * cout + col) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

template <typename T, bool RES, bool YT>
__global__ void __launch_bounds__(NTHREADS)
    gate_project_generic(const T* __restrict__ hidden,
                         const float* __restrict__ gate,
                         const T* __restrict__ wpt,
                         const float* __restrict__ pb,
                         const T* __restrict__ res, T* __restrict__ y, int HW,
                         int W, int E, int cout, int tiles_per_cta) {
  extern __shared__ float4 smem4[];
  float* gate_s = reinterpret_cast<float*>(smem4);
  float* hs = gate_s + round_up(E, 4);  // [GTP][GKC + 1]
  float* ws = hs + GTP * (GKC + 1);     // [GKC][cout]

  const int n = blockIdx.y;
  for (int e = threadIdx.x; e < E; e += NTHREADS)
    gate_s[e] = gate[(size_t)n * E + e];
  const T* hn = hidden + (size_t)n * HW * E;
  const T* rn = RES ? res + (size_t)n * HW * cout : nullptr;
  T* yn = y + (size_t)n * HW * cout;
  const int nout = GTP * cout;
  for (int t = 0; t < tiles_per_cta; ++t) {
    const int p0 = (blockIdx.x * tiles_per_cta + t) * GTP;
    if (p0 >= HW) break;
    float acc[MAX_OPT];
#pragma unroll
    for (int i = 0; i < MAX_OPT; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < E; k0 += GKC) {
      const int kc = min(GKC, E - k0);
      __syncthreads();  // the previous step's readers are done
      for (int idx = threadIdx.x; idx < GTP * GKC; idx += NTHREADS) {
        const int p = idx / GKC, kk = idx % GKC;
        float v = 0.f;
        if (p0 + p < HW && kk < kc)
          v = round_to<T>(to_f32(hn[(size_t)(p0 + p) * E + k0 + kk]) *
                          gate_s[k0 + kk]);
        hs[p * (GKC + 1) + kk] = v;
      }
      for (int idx = threadIdx.x; idx < GKC * cout; idx += NTHREADS) {
        const int kk = idx / cout, c = idx % cout;
        ws[idx] = kk < kc ? to_f32(wpt[(size_t)c * E + k0 + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MAX_OPT; ++i) {
        const int o = threadIdx.x + i * NTHREADS;
        if (o < nout) {
          const float* hp = hs + (o / cout) * (GKC + 1);
          const float* wp = ws + o % cout;
          float a = acc[i];
          for (int kk = 0; kk < kc; ++kk) a = fmaf(hp[kk], wp[kk * cout], a);
          acc[i] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_OPT; ++i) {
      const int o = threadIdx.x + i * NTHREADS;
      const int p = p0 + o / cout, c = o % cout;
      if (o < nout && p < HW) {
        float v = acc[i];
        if (pb != nullptr) v += pb[c];
        const size_t oi = out_at<YT>(p, c, cout, W);
        T out = from_f32<T>(v);
        if (RES) out = from_f32<T>(to_f32(out) + to_f32(rn[oi]));
        yn[oi] = out;
      }
    }
  }
}

// The gate_project_mma instance for a residual or not and this C_out.
template <bool YT>
auto mma_kernel(bool res, int cout) {
  const int nt = (cout + 7) / 8;
  if (res)
    return nt <= NT_BUCKETS[0]   ? gate_project_mma<true, YT, NT_BUCKETS[0]>
           : nt <= NT_BUCKETS[1] ? gate_project_mma<true, YT, NT_BUCKETS[1]>
           : nt <= NT_BUCKETS[2] ? gate_project_mma<true, YT, NT_BUCKETS[2]>
                                 : gate_project_mma<true, YT, NT_BUCKETS[3]>;
  return nt <= NT_BUCKETS[0]   ? gate_project_mma<false, YT, NT_BUCKETS[0]>
         : nt <= NT_BUCKETS[1] ? gate_project_mma<false, YT, NT_BUCKETS[1]>
         : nt <= NT_BUCKETS[2] ? gate_project_mma<false, YT, NT_BUCKETS[2]>
                               : gate_project_mma<false, YT, NT_BUCKETS[3]>;
}

// The gate_project_tf32 instance for a residual or not and this C_out.
template <bool YT>
auto tf32_kernel(bool res, int cout) {
  const int nt = (cout + 7) / 8;
  if (res)
    return nt <= NT_BUCKETS[0]   ? gate_project_tf32<true, YT, NT_BUCKETS[0]>
           : nt <= NT_BUCKETS[1] ? gate_project_tf32<true, YT, NT_BUCKETS[1]>
           : nt <= NT_BUCKETS[2] ? gate_project_tf32<true, YT, NT_BUCKETS[2]>
                                 : gate_project_tf32<true, YT, NT_BUCKETS[3]>;
  return nt <= NT_BUCKETS[0]   ? gate_project_tf32<false, YT, NT_BUCKETS[0]>
         : nt <= NT_BUCKETS[1] ? gate_project_tf32<false, YT, NT_BUCKETS[1]>
         : nt <= NT_BUCKETS[2] ? gate_project_tf32<false, YT, NT_BUCKETS[2]>
                               : gate_project_tf32<false, YT, NT_BUCKETS[3]>;
}

// Registers, dynamic shared memory (bytes), resident CTAs per SM of `kernel`
// with `threads` threads and `smem` bytes, into out[0..2].
template <typename Kernel>
cudaError_t query(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        threads, smem);
  out[0] = a.numRegs;
  out[1] = smem;
  return err;
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of
// gate_project_mma for these E, C_out, into out[0..2].  Launches nothing.
template <bool YT = false>
cudaError_t occupancy(int e, int cout, bool res, int* out) {
  return query(mma_kernel<YT>(res, cout), (mma_warps(cout) + 1) * 32,
               MmaSmem(e, cout, YT).total, out);
}

// The same of a sweep-2 kernel chosen by `design` (0 gate_project_generic,
// 1 the designed kernel of the dtype: gate_project_mma for bf16,
// gate_project_tf32 for f32), and its ring slots into out[3] (0 generic).
// A shape that the design does not take returns cudaErrorInvalidValue.
template <bool YT>
cudaError_t occupancy(int design, bool bf16, int e, int cout, bool res,
                      int* out) {
  out[3] = 0;
  if (design == 0) {
    if (cout > NTHREADS * MAX_OPT / GTP) return cudaErrorInvalidValue;
    const int smem =
        (round_up(e, 4) + GTP * (GKC + 1) + GKC * cout) * (int)sizeof(float);
    if (bf16)
      return res ? query(gate_project_generic<__nv_bfloat16, true, YT>,
                         NTHREADS, smem, out)
                 : query(gate_project_generic<__nv_bfloat16, false, YT>,
                         NTHREADS, smem, out);
    return res ? query(gate_project_generic<float, true, YT>, NTHREADS, smem,
                       out)
               : query(gate_project_generic<float, false, YT>, NTHREADS,
                       smem, out);
  }
  if (cout % 2 != 0 || cout > MAX_NT * 8) return cudaErrorInvalidValue;
  int max_smem = 0, sm_smem = 0, reserved = 0;
  cudaError_t err = smem_limits(max_smem, sm_smem, reserved);
  if (err != cudaSuccess) return err;
  if (bf16) {
    out[3] = SLOTS;
    if (e % 8 != 0 || MmaSmem(e, cout, YT).total > max_smem)
      return cudaErrorInvalidValue;
    return occupancy<YT>(e, cout, res, out);
  }
  out[3] = tf32_slots(e, cout, max_smem, sm_smem, reserved);
  if (e % 4 != 0 || out[3] == 0) return cudaErrorInvalidValue;
  return query(tf32_kernel<YT>(res, cout), TF_THREADS,
               TfSmem(e, cout, out[3]).total, out);
}

// The hidden (n, hw, e) of `esize`-byte elements as a 3-d map (E, HW, N),
// boxes of `ch` channels (128 bytes) x TP pixels, 128-byte swizzle, zeros
// past the edges.
inline bool hidden_map(CUtensorMap* map, const void* hidden, int n, int hw,
                       int e, int esize, int ch) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)e, (cuuint64_t)hw, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)e * esize,
                                 (cuuint64_t)hw * e * esize};
  const cuuint32_t box[3] = {(cuuint32_t)ch, TP, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(hidden), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The grid of a persistent sweep-2 kernel of `threads` threads and `smem`
// bytes: as many CTAs as fit on the card, at most one per item.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, int items,
                            int& grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = std::min(items, per_sm * sms);
  return cudaSuccess;
}

// y (n, hw, cout) from hidden (n, hw, e) and its exact sums (n, e); d0t is
// the SE's first dense kernel transposed, (s, e); d1k (s, e); wpt the
// projection transposed, (cout, e); pb and res may be null; gate is an
// (n, e) f32 scratch.  With YT, y and res are (n, hw / w, cout, w).
// `designed` false sends every shape to gate_project_generic (the A/B
// against the designs); a designed kernel that fails to launch returns its
// error, it never falls back.
template <typename T, bool YT = false>
cudaError_t launch(const void* hidden, const void* sums, const void* d0t,
                   const void* d0b, const void* d1k, const void* d1b,
                   const void* wpt, const void* pb, const void* res,
                   void* gate, void* y, int n, int hw, int e, int s, int cout,
                   cudaStream_t stream, int w = 1, bool designed = true) {
  const int tiles_per_image = (hw + TP - 1) / TP;
  const int total = n * tiles_per_image;
  int max_smem = 0, sm_smem = 0, reserved = 0;
  cudaError_t err = smem_limits(max_smem, sm_smem, reserved);
  if (err != cudaSuccess) return err;
  const bool even = designed && cout % 2 == 0 && cout <= MAX_NT * 8 &&
                    aligned(hidden, 16) && aligned(wpt, 16);
  const bool mma = even && sizeof(T) == 2 && e % 8 == 0 &&
                   MmaSmem(e, cout, YT).total <= max_smem && aligned(y, 4) &&
                   (res == nullptr || aligned(res, 4));
  const int slots = even && sizeof(T) == 4 && e % 4 == 0 && aligned(y, 8) &&
                            (res == nullptr || aligned(res, 8))
                        ? tf32_slots(e, cout, max_smem, sm_smem, reserved)
                        : 0;
  // The gate: se_gate_staged where D0 and D1 fit in shared memory, else
  // (and in the earlier sweep 2 the A/B forces) se_gate_kernel.
  const int gsmem = gate_smem(e, s);
  if (designed && s * e % 4 == 0 && gsmem <= max_smem &&
      aligned(d0t, 16) && aligned(d1k, 16)) {
    err = cudaFuncSetAttribute(se_gate_staged<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gsmem);
    if (err != cudaSuccess) return err;
    se_gate_staged<T><<<n, NTHREADS, gsmem, stream>>>(
        static_cast<const float*>(sums), static_cast<const float*>(d0t),
        static_cast<const float*>(d0b), static_cast<const float*>(d1k),
        static_cast<const float*>(d1b), static_cast<float*>(gate), e, s,
        (float)(1.0 / hw));
  } else {
    se_gate_kernel<T><<<n, NTHREADS, (round_up(e, 4) + round_up(s, 4)) * 4,
                        stream>>>(
        static_cast<const float*>(sums), static_cast<const float*>(d0t),
        static_cast<const float*>(d0b), static_cast<const float*>(d1k),
        static_cast<const float*>(d1b), static_cast<float*>(gate), e, s,
        (float)(1.0 / hw));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (mma) {
    CUtensorMap hmap;
    if (!hidden_map(&hmap, hidden, n, hw, e, 2, KB))
      return cudaErrorInvalidValue;
    const int smem = MmaSmem(e, cout, YT).total;
    auto kernel = mma_kernel<YT>(res != nullptr, cout);
    const int yt_rows = YT && w % TP == 0 && aligned(y, 16) &&
                        (res == nullptr || aligned(res, 16));
    const int threads = (mma_warps(cout) + 1) * 32;
    int grid = 0;
    err = persistent_grid(kernel, threads, smem, total, grid);
    if (err != cudaSuccess) return err;
    last_design() = 1;
    using B = __nv_bfloat16;
    kernel<<<grid, threads, smem, stream>>>(
        hmap, static_cast<const float*>(gate), static_cast<const B*>(wpt),
        static_cast<const float*>(pb), static_cast<const B*>(res),
        static_cast<B*>(y), hw, w, e, cout, tiles_per_image, total, yt_rows);
    return cudaGetLastError();
  }
  if (slots > 0) {
    CUtensorMap hmap;
    if (!hidden_map(&hmap, hidden, n, hw, e, 4, KB32))
      return cudaErrorInvalidValue;
    const int smem = TfSmem(e, cout, slots).total;
    auto kernel = tf32_kernel<YT>(res != nullptr, cout);
    int grid = 0;
    err = persistent_grid(kernel, TF_THREADS, smem, total, grid);
    if (err != cudaSuccess) return err;
    last_design() = 2;
    kernel<<<grid, TF_THREADS, smem, stream>>>(
        hmap, static_cast<const float*>(gate), static_cast<const float*>(wpt),
        static_cast<const float*>(pb), static_cast<const float*>(res),
        static_cast<float*>(y), hw, w, e, cout, tiles_per_image, total,
        slots);
    return cudaGetLastError();
  }
  if (cout > NTHREADS * MAX_OPT / GTP) return cudaErrorInvalidValue;
  const int tiles = (hw + GTP - 1) / GTP;
  const int tpc = std::max(1, (int)((long long)tiles * n / TARGET_CTAS));
  dim3 grid((tiles + tpc - 1) / tpc, n);
  const int smem =
      (round_up(e, 4) + GTP * (GKC + 1) + GKC * cout) * (int)sizeof(float);
  auto kernel = res != nullptr ? gate_project_generic<T, true, YT>
                               : gate_project_generic<T, false, YT>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  last_design() = 0;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(hidden), static_cast<const float*>(gate),
      static_cast<const T*>(wpt), static_cast<const float*>(pb),
      static_cast<const T*>(res), static_cast<T*>(y), hw, w, e, cout, tpc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gp
}  // namespace ast_kernels
