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
// 24-96 MACs per byte read at the model's shapes, far below the ~295 at
// which the tensor cores would bound it.  So the design is a stream of the
// hidden, not a product.
//
// Design:
//   * bf16 with E % 8 == 0 and C_out <= 96 (every block of the model),
//     gate_project_mma: persistent CTAs (as many as fit on the card), each
//     taking one contiguous run of (image, 128-pixel tile) items.  A producer
//     warp streams the run's hidden as TMA boxes of 128 pixels x 64 channels
//     (16 KB, 128-byte swizzle, zeros past E and past the image) through a
//     ring of SLOTS slots; a slot is refilled only after the four consumer
//     warps have released it.  The consumers hold the projection matrix
//     (transposed, zero-padded to a multiple of 64 in E, rows 4 banks apart,
//     staged with 16-byte loads) and their image's gate (bf16) in shared
//     memory.  Each consumer warp owns 32 pixels x all of C_out: it reads
//     its A fragments from the swizzled box with ldmatrix (conflict-free),
//     multiplies them by the gate as packed bf16 products (round(h *
//     round(g)) of two bf16 values is one rounding of an exact product: the
//     bits of the TPU kernel's bf16 multiply), and runs mma.sync m16n8k16
//     with f32 accumulation across the boxes of a tile, its accumulators
//     sized for C_out <= 32, <= 48 or <= 96 (three instances: 64, 96 or 192
//     registers).  The tile's residual, one contiguous run, is prefetched
//     into L2 while its boxes stream.
//   * otherwise (f32, or other shapes): a CUDA-core path, one CTA per run of
//     32-pixel tiles, 32 pixels x 32 channels per step in f32, up to 16
//     outputs per thread.
//   * YT (the mega route): y and the residual are (N, H, C_out, W) with W
//     contiguous, written and read one value at a time; the hidden stays
//     pixel-major (NHWC).
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
constexpr int MMA_THREADS = (CONSUMERS + 1) * 32;
constexpr int MAX_NT = 12;      // 8-wide output tiles: C_out <= 96
// The accumulators' 8-wide output tiles by C_out: <= 32 (most blocks),
// <= 48 (C_out 40), <= 96.
constexpr int NT_BUCKETS[3] = {4, 6, MAX_NT};
static_assert(CONSUMERS * 32 == TP, "32 pixels per consumer warp");

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
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
// base): the ring, the projection matrix [nt * 8][ldw] bf16, the gate
// [ep] bf16 and the ring's barriers.
struct MmaSmem {
  int ep, ldw, wt, gate, bars, total;
  __host__ __device__ MmaSmem(int E, int cout) {
    ep = round_up(E, KB);
    ldw = ep + 8;  // rows 4 banks apart: conflict-free B fragments
    wt = SLOTS * BOX_BYTES;
    gate = wt + (cout + 7) / 8 * 8 * ldw * 2;
    bars = gate + ep * 2;
    total = 1024 + bars + 2 * SLOTS * 8;  // + the alignment slack
  }
};

// hmap: the hidden as a 3-d map (E, HW, N), boxes of 64 x TP x 1; gate
// (N, E) from se_gate_kernel.  The CTA takes items [begin, end) of the
// N * tiles_per_image (image, tile) items.  NT: the accumulators' 8-wide
// output tiles, one of NT_BUCKETS (16 * NT registers per thread).  The
// largest instance asks for one CTA per SM, so its accumulators never
// spill: at the model's C_out > 48 (E >= 288) the ring and the matrix take
// over half of the shared memory anyway.
template <bool RES, bool YT, int NT>
__global__ void __launch_bounds__(MMA_THREADS, NT == MAX_NT ? 1 : 2)
    gate_project_mma(const __grid_constant__ CUtensorMap hmap,
                     const float* __restrict__ gate,
                     const __nv_bfloat16* __restrict__ wpt,
                     const float* __restrict__ pb,
                     const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ y, int HW, int W, int E,
                     int cout, int tiles_per_image, int total) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const MmaSmem L(E, cout);
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
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  // The projection matrix, 8 channels per 16-byte copy (E % 8 == 0).
  const int nv = L.ep / 8;
  for (int idx = threadIdx.x; idx < nt_count * 8 * nv; idx += MMA_THREADS) {
    const int c = idx / nv, e = idx % nv * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < cout && e < E)
      v = *reinterpret_cast<const uint4*>(wpt + (size_t)c * E + e);
    *reinterpret_cast<uint4*>(wT + c * L.ldw + e) = v;
  }
  for (int e = E + threadIdx.x; e < L.ep; e += MMA_THREADS)
    gate_s[e] = __float2bfloat16_rn(0.f);
  __syncthreads();
  if (begin >= end) return;
  const int nbox = (end - begin) * nk;

  if (warp == CONSUMERS) {
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
      named_barrier(CONSUMERS * 32);  // the previous gate's readers are done
      for (int e = threadIdx.x; e < E; e += CONSUMERS * 32)
        gate_s[e] = __float2bfloat16_rn(gate[(size_t)n * E + e]);
      named_barrier(CONSUMERS * 32);
      gate_n = n;
    }
    const __nv_bfloat16* rn = RES ? res + (size_t)n * HW * cout : nullptr;
    __nv_bfloat16* yn = y + (size_t)n * HW * cout;
    if constexpr (RES && !YT) {
      // The tile's residual is one contiguous run: bring it into L2 while
      // the hidden streams, so the epilogue does not wait on HBM.
      const char* run =
          reinterpret_cast<const char*>(rn + (size_t)t * TP * cout);
      const int bytes = min(TP, HW - t * TP) * cout * 2;
      for (int o = threadIdx.x * 128; o < bytes; o += CONSUMERS * 32 * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(run + o));
    }
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++j) {
      const int s = j % SLOTS;
      mbar_wait(&full[s], (j / SLOTS) & 1);
      const unsigned char* box = ring + s * BOX_BYTES;
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks) {
        const int k = kc * KB + ks * 16 + tig * 2;
        const uint32_t g0 = lds32(gate_s + k), g8 = lds32(gate_s + k + 8);
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // Row r of the box, 16-byte chunk q at chunk q ^ (r % 8).
          const int r = warp * 32 + i * 16 + (lane & 15);
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

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nt_count) continue;
        const int col = nt * 8 + tig * 2;
        if (col >= cout) continue;  // cout is even: col + 1 < cout too
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = t * TP + warp * 32 + i * 16 + g + half * 8;
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
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
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
                                 : gate_project_mma<true, YT, NT_BUCKETS[2]>;
  return nt <= NT_BUCKETS[0]   ? gate_project_mma<false, YT, NT_BUCKETS[0]>
         : nt <= NT_BUCKETS[1] ? gate_project_mma<false, YT, NT_BUCKETS[1]>
                               : gate_project_mma<false, YT, NT_BUCKETS[2]>;
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of
// gate_project_mma for these E, C_out, into out[0..2].  Launches nothing.
cudaError_t occupancy(int e, int cout, bool res, int* out) {
  auto kernel = mma_kernel<false>(res, cout);
  const int smem = MmaSmem(e, cout).total;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        MMA_THREADS, smem);
  out[0] = a.numRegs;
  out[1] = smem;
  return err;
}

// y (n, hw, cout) from hidden (n, hw, e) and its exact sums (n, e); d0t is
// the SE's first dense kernel transposed, (s, e); d1k (s, e); wpt the
// projection transposed, (cout, e); pb and res may be null; gate is an
// (n, e) f32 scratch.  With YT, y and res are (n, hw / w, cout, w).
template <typename T, bool YT = false>
cudaError_t launch(const void* hidden, const void* sums, const void* d0t,
                   const void* d0b, const void* d1k, const void* d1b,
                   const void* wpt, const void* pb, const void* res,
                   void* gate, void* y, int n, int hw, int e, int s, int cout,
                   cudaStream_t stream, int w = 1) {
  se_gate_kernel<T><<<n, NTHREADS, (round_up(e, 4) + round_up(s, 4)) * 4,
                      stream>>>(
      static_cast<const float*>(sums), static_cast<const float*>(d0t),
      static_cast<const float*>(d0b), static_cast<const float*>(d1k),
      static_cast<const float*>(d1b), static_cast<float*>(gate), e, s,
      (float)(1.0 / hw));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool mma = sizeof(T) == 2 && e % 8 == 0 && cout % 2 == 0 &&
                   cout <= MAX_NT * 8 && aligned(hidden, 16) &&
                   aligned(wpt, 16) && aligned(y, 4) &&
                   (res == nullptr || aligned(res, 4));
  if (mma) {
    // The hidden as (E, HW, N), boxes of 64 channels x TP pixels.
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorInvalidValue;
    CUtensorMap hmap;
    const cuuint64_t dims[3] = {(cuuint64_t)e, (cuuint64_t)hw, (cuuint64_t)n};
    const cuuint64_t strides[2] = {(cuuint64_t)e * 2,
                                   (cuuint64_t)hw * e * 2};
    const cuuint32_t box[3] = {KB, TP, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<void*>(hidden), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    const int smem = MmaSmem(e, cout).total;
    auto kernel = mma_kernel<YT>(res != nullptr, cout);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, MMA_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles_per_image = (hw + TP - 1) / TP;
    const int total = n * tiles_per_image;
    using B = __nv_bfloat16;
    kernel<<<std::min(total, per_sm * sms), MMA_THREADS, smem, stream>>>(
        hmap, static_cast<const float*>(gate), static_cast<const B*>(wpt),
        static_cast<const float*>(pb), static_cast<const B*>(res),
        static_cast<B*>(y), hw, w, e, cout, tiles_per_image, total);
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
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(hidden), static_cast<const float*>(gate),
      static_cast<const T*>(wpt), static_cast<const float*>(pb),
      static_cast<const T*>(res), static_cast<T*>(y), hw, w, e, cout, tpc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gp
}  // namespace ast_kernels
