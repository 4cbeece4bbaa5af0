// Sweep 2 of the whole-block kernels (flat_block.cu, flat_s2.cu,
// mega_block.cu): the in-kernel SE gate, the gated 1x1 projection, its bias
// and the residual.
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
// on Hopper the barrier is the boundary between the two launches.  Each CTA
// recomputes its image's gate (E x S + S x E FMAs, at most 384 x 96) into
// shared memory, then walks pixel tiles.
//
// What bounds it on an H100: one read of the hidden (d10 at 512px batch 8:
// 1.0 GB of bf16) against E x C_out MACs per pixel, 24-96 MACs per byte read
// at the model's shapes; on the tensor cores that is HBM-bound.
//
// Design (simple; wgmma/TMA and a pipelined hidden stream are later work):
//   * bf16 with E % 8 == 0 and C_out <= 96 (every block of the model): the
//     whole projection matrix, transposed and zero-padded to E % 16, stays in
//     shared memory.  Each step stages 128 pixels x 64 hidden channels with
//     16-byte loads, gated on the way in, into rows padded to 144 B
//     (conflict-free fragment loads); each warp runs mma.sync m16n8k16 over
//     16 pixels x all of C_out.
//   * otherwise (f32, or other shapes): a CUDA-core path, 32 pixels x 32
//     channels per step in f32, up to 16 outputs per thread.
//   * YT (the mega route): y and the residual are (N, H, C_out, W) with W
//     contiguous, written and read one value at a time; the hidden stays
//     pixel-major (NHWC).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace ast_kernels {
namespace gp {
// Internal linkage: every source that includes this header gets its own
// copy of the kernels, so no two objects of the library share a symbol.
namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TP = 128;         // pixels per tile (MMA path): 8 warps x 16
constexpr int KC = 64;          // hidden channels staged per step
constexpr int HS_LD = KC + 8;   // bf16 staged row: 144 B
constexpr int MAX_NT = 12;      // 8-wide output tiles: C_out <= 96
constexpr int GTP = 32;         // pixels per tile (CUDA-core path)
constexpr int GKC = 32;         // channels per step (CUDA-core path)
constexpr int MAX_OPT = 16;     // outputs per thread: C_out <= 128
constexpr int TARGET_CTAS = 132 * 8;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The SE gate of one image into gate_s, rounded to T; uses mean_s and h1_s
// as scratch.  Ends with a barrier.
template <typename T>
__device__ void se_gate(const float* __restrict__ sums_n,
                        const float* __restrict__ d0t,
                        const float* __restrict__ d0b,
                        const float* __restrict__ d1k,
                        const float* __restrict__ d1b, float* mean_s,
                        float* h1_s, float* gate_s, int E, int S,
                        float inv_hw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < E; e += NTHREADS)
    mean_s[e] = sums_n[e] * inv_hw;
  __syncthreads();
  // h1 = relu(mean @ D0 + b0): one warp per hidden unit, lanes over E.
  for (int s = warp; s < S; s += NWARPS) {
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
    for (int s = 0; s < S; ++s) a = fmaf(h1_s[s], d1k[(size_t)s * E + e], a);
    gate_s[e] = round_to<T>(fminf(fmaxf(a + d1b[e], 0.f), 1.f));
  }
  __syncthreads();
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

template <bool RES, bool YT>
__global__ void __launch_bounds__(NTHREADS)
    gate_project_mma(const __nv_bfloat16* __restrict__ hidden,
                     const float* __restrict__ sums,
                     const float* __restrict__ d0t,
                     const float* __restrict__ d0b,
                     const float* __restrict__ d1k,
                     const float* __restrict__ d1b,
                     const __nv_bfloat16* __restrict__ wpt,
                     const float* __restrict__ pb,
                     const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ y, int HW, int W, int E,
                     int S, int cout, float inv_hw, int tiles_per_cta) {
  const int e_al = round_up(E, 4), s_al = round_up(S, 4);
  const int ep = round_up(E, 16), ldw = ep + 8;
  const int nt_count = (cout + 7) / 8;
  extern __shared__ float4 smem4[];
  float* gate_s = reinterpret_cast<float*>(smem4);
  float* mean_s = gate_s + e_al;
  float* h1_s = mean_s + e_al;
  __nv_bfloat16* wT = reinterpret_cast<__nv_bfloat16*>(h1_s + s_al);
  __nv_bfloat16* hs = wT + nt_count * 8 * ldw;  // [TP][HS_LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n = blockIdx.y;
  se_gate<__nv_bfloat16>(sums + (size_t)n * E, d0t, d0b, d1k, d1b, mean_s,
                         h1_s, gate_s, E, S, inv_hw);
  for (int idx = threadIdx.x; idx < nt_count * 8 * ep; idx += NTHREADS) {
    const int c = idx / ep, e = idx % ep;
    wT[c * ldw + e] = (c < cout && e < E) ? wpt[(size_t)c * E + e]
                                          : __float2bfloat16_rn(0.f);
  }

  const __nv_bfloat16* hn = hidden + (size_t)n * HW * E;
  const __nv_bfloat16* rn = RES ? res + (size_t)n * HW * cout : nullptr;
  __nv_bfloat16* yn = y + (size_t)n * HW * cout;
  for (int t = 0; t < tiles_per_cta; ++t) {
    const int p0 = (blockIdx.x * tiles_per_cta + t) * TP;
    if (p0 >= HW) break;
    float acc[MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
    for (int k0 = 0; k0 < ep; k0 += KC) {
      const int kc = min(KC, ep - k0);  // a multiple of 16
      __syncthreads();  // wT is staged; the previous step's readers are done
      for (int idx = threadIdx.x; idx < TP * (kc / 8); idx += NTHREADS) {
        const int p = idx / (kc / 8), q = idx % (kc / 8);
        const int e = k0 + q * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + p < HW && e < E) {
          v = *reinterpret_cast<const uint4*>(hn + (size_t)(p0 + p) * E + e);
          __nv_bfloat16* hv = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            hv[j] = __float2bfloat16_rn(__bfloat162float(hv[j]) *
                                        gate_s[e + j]);
        }
        *reinterpret_cast<uint4*>(&hs[p * HS_LD + q * 8]) = v;
      }
      __syncthreads();
      for (int ks = 0; ks < kc; ks += 16) {
        const __nv_bfloat16* ap = hs + (warp * 16 + g) * HS_LD + ks + tig * 2;
        const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * HS_LD), lds32(ap + 8),
                               lds32(ap + 8 * HS_LD + 8)};
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) {
          if (nt < nt_count) {
            const __nv_bfloat16* bp = wT + (nt * 8 + g) * ldw + k0 + ks + tig * 2;
            const uint32_t b[2] = {lds32(bp), lds32(bp + 8)};
            mma_bf16(acc[nt], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt >= nt_count) continue;
      const int col = nt * 8 + tig * 2;
      if (col >= cout) continue;  // cout is even: col + 1 < cout too
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + warp * 16 + g + half * 8;
        if (p >= HW) continue;
        float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        if (pb != nullptr) {
          v0 += pb[col];
          v1 += pb[col + 1];
        }
        if constexpr (YT) {
          const size_t o = out_at<true>(p, col, cout, W);
          const float vs[2] = {v0, v1};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            __nv_bfloat16 out = __float2bfloat16_rn(vs[j]);
            if (RES)
              out = __float2bfloat16_rn(__bfloat162float(out) +
                                        __bfloat162float(rn[o + j * W]));
            yn[o + j * W] = out;
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
        *reinterpret_cast<__nv_bfloat162*>(yn + (size_t)p * cout + col) = out;
      }
    }
  }
}

template <typename T, bool RES, bool YT>
__global__ void __launch_bounds__(NTHREADS)
    gate_project_generic(const T* __restrict__ hidden,
                         const float* __restrict__ sums,
                         const float* __restrict__ d0t,
                         const float* __restrict__ d0b,
                         const float* __restrict__ d1k,
                         const float* __restrict__ d1b,
                         const T* __restrict__ wpt,
                         const float* __restrict__ pb,
                         const T* __restrict__ res, T* __restrict__ y, int HW,
                         int W, int E, int S, int cout, float inv_hw,
                         int tiles_per_cta) {
  const int e_al = round_up(E, 4), s_al = round_up(S, 4);
  extern __shared__ float4 smem4[];
  float* gate_s = reinterpret_cast<float*>(smem4);
  float* mean_s = gate_s + e_al;
  float* h1_s = mean_s + e_al;
  float* hs = h1_s + s_al;              // [GTP][GKC + 1]
  float* ws = hs + GTP * (GKC + 1);     // [GKC][cout]

  const int n = blockIdx.y;
  se_gate<T>(sums + (size_t)n * E, d0t, d0b, d1k, d1b, mean_s, h1_s, gate_s,
             E, S, inv_hw);
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

// y (n, hw, cout) from hidden (n, hw, e) and its exact sums (n, e); d0t is
// the SE's first dense kernel transposed, (s, e); d1k (s, e); wpt the
// projection transposed, (cout, e); pb and res may be null.  With YT, y and
// res are (n, hw / w, cout, w).
template <typename T, bool YT = false>
cudaError_t launch(const void* hidden, const void* sums, const void* d0t,
                   const void* d0b, const void* d1k, const void* d1b,
                   const void* wpt, const void* pb, const void* res, void* y,
                   int n, int hw, int e, int s, int cout, cudaStream_t stream,
                   int w = 1) {
  const int e_al = round_up(e, 4), s_al = round_up(s, 4);
  const float inv_hw = (float)(1.0 / hw);
  const bool mma = sizeof(T) == 2 && e % 8 == 0 && cout % 2 == 0 &&
                   cout <= MAX_NT * 8 && aligned(hidden, 16) && aligned(y, 4) &&
                   (res == nullptr || aligned(res, 4));
  const int tp = mma ? TP : GTP;
  const int tiles = (hw + tp - 1) / tp;
  const int tpc = std::max(1, (int)((long long)tiles * n / TARGET_CTAS));
  dim3 grid((tiles + tpc - 1) / tpc, n);
  if (mma) {
    const int nt = (cout + 7) / 8, ldw = round_up(e, 16) + 8;
    const int smem = (2 * e_al + s_al) * 4 + nt * 8 * ldw * 2 + TP * HS_LD * 2;
    auto kernel = res != nullptr ? gate_project_mma<true, YT>
                                 : gate_project_mma<false, YT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    using B = __nv_bfloat16;
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const B*>(hidden), static_cast<const float*>(sums),
        static_cast<const float*>(d0t), static_cast<const float*>(d0b),
        static_cast<const float*>(d1k), static_cast<const float*>(d1b),
        static_cast<const B*>(wpt), static_cast<const float*>(pb),
        static_cast<const B*>(res), static_cast<B*>(y), hw, w, e, s, cout,
        inv_hw, tpc);
    return cudaGetLastError();
  }
  if (cout > NTHREADS * MAX_OPT / GTP) return cudaErrorInvalidValue;
  const int smem =
      (2 * e_al + s_al + GTP * (GKC + 1) + GKC * cout) * (int)sizeof(float);
  auto kernel = res != nullptr ? gate_project_generic<T, true, YT>
                               : gate_project_generic<T, false, YT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(hidden), static_cast<const float*>(sums),
      static_cast<const float*>(d0t), static_cast<const float*>(d0b),
      static_cast<const float*>(d1k), static_cast<const float*>(d1b),
      static_cast<const T*>(wpt), static_cast<const float*>(pb),
      static_cast<const T*>(res), static_cast<T*>(y), hw, w, e, s, cout,
      inv_hw, tpc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gp
}  // namespace ast_kernels
