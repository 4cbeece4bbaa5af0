// Fused 1x1 expand + k x k depthwise of one stride-1 inverted-residual block:
// the device code behind expand_dw.cu (the fused route) and the first sweep
// of flat_block.cu (the flat route).
//
//   h      = hswish(x @ We + be)              (pre_act; f32 accumulation)
//   out    = hswish(dw_kxk(reflect_pad(h)) + bd)
//   hidden = out rounded to x's dtype,  sums[n, c] = sum over H, W
//
// ROUND selects where the values are rounded to the I/O dtype, after the
// TPU kernel each route ports:
//   * false (fused_block._fused_kernel): the depthwise runs in f32 on the
//     unrounded expanded values, and the SE sums are taken of `out` before
//     it is rounded;
//   * true (flatblock._flat_kernel): the expanded values are rounded before
//     the depthwise, and the SE sums are taken of the rounded hidden.
// At f32 the two are the same.
//
// What bounds it on an H100: at the 512px decoder tail (d8-d10: k5, C_in 40,
// E 160-240, 8 x 512 x 512 pixels) the arithmetic is the 1x1 expand, about
// 1.5x the block's C_in*E MACs per pixel once the depthwise halo is
// recomputed, plus k*k f32 MACs per hidden value for the depthwise; the only
// large memory traffic is the one write of the hidden.  On the f32 CUDA cores
// the expand alone took over half of the kernel's time, so for bf16 inputs it
// runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate: the
// products are exact in f32, as in the TPU's bf16 matmul with f32
// accumulation).  What is left is bound by the f32 depthwise and the
// shared-memory traffic around it, not by HBM.
//
// Design (simple; wgmma/TMA and a wider channel chunk are later work):
//   * One CTA per (image, 16x16 output tile, 32-channel chunk of E), 256
//     threads.  In the depthwise, lane = hidden channel, so every
//     shared-memory access there is 32 consecutive words.
//   * Expand: the reflect-indexed input halo (16+2p)^2 pixels is staged in
//     shared memory 32 input channels at a time (no padded copy of x in HBM:
//     the reflection is an index map, valid because expand and hswish are
//     per pixel).
//     - bf16 with C_in % 8 == 0 and 16-byte aligned x (every block of the
//       model): staged as bf16 with 16-byte loads; each warp runs mma.sync
//       on up to 4 row tiles of 16 halo pixels x all 32 channels.
//     - otherwise (f32, or other channel counts): staged as f32; each thread
//       keeps its halo pixels' expanded values in registers, reading x as
//       float4 broadcasts (~4 FMAs per load).
//   * The expanded halo (f32) then replaces the staging buffer; the
//     depthwise walks column strips so each loaded value feeds k FMAs.
//   * SE sums: per-thread partials, reduced across warps in shared memory,
//     then one atomicAdd per (CTA, channel) into a zeroed (N, E) buffer.  The
//     order of those adds varies from run to run (a few f32 ulps of the sum).
//   * Shared memory: (16+2p)^2 * 32 * 4 + 4 KiB = 55,296 B at k5, above the
//     48 KiB default, so the launcher raises the CTA's dynamic limit.
#pragma once

#include "common.cuh"

namespace ast_kernels {
namespace edw {
// Internal linkage: every source that includes this header gets its own
// copy of the kernels, so no two objects of the library share a symbol.
namespace {

constexpr int TH = 16;        // output tile rows
constexpr int TW = 16;        // output tile columns
constexpr int CE = 32;        // hidden channels per CTA: one per lane
constexpr int CK = 32;        // input channels staged per expand step
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int XS_LD = CK + 8;  // bf16 staging row: 80 B, conflict-free frags

// The expanded value as the depthwise reads it.
template <typename T, bool ROUND>
__device__ __forceinline__ float expanded(float v) {
  return ROUND ? round_to<T>(v) : v;
}

// EXPAND: a 1x1 expand precedes the depthwise; MMA: it runs on the tensor
// cores (bf16 only, C_in % 8 == 0, 16-byte aligned x).
template <typename T, int K, bool EXPAND, bool MMA, bool ROUND>
__global__ void __launch_bounds__(NTHREADS)
    expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ we,
                     const float* __restrict__ wd,
                     const float* __restrict__ be,
                     const float* __restrict__ bd, T* __restrict__ hidden,
                     float* __restrict__ sums, int H, int W, int cin, int E,
                     int pre_act, int tiles_x) {
  constexpr int P = (K - 1) / 2;
  constexpr int HH = TH + 2 * P;  // halo rows
  constexpr int HW = TW + 2 * P;  // halo columns
  constexpr int HP = HH * HW;     // halo pixels
  constexpr int NPX = (HP + NWARPS - 1) / NWARPS;  // halo pixels per warp

  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // [HP][32]: x, then h
  float* ws = buf + HP * 32;                     // expand weights

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * CE;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int c = c0 + lane;
  const bool c_ok = c < E;
  const T* xn = x + (size_t)n * H * W * cin;

  if constexpr (MMA) {
    constexpr int MT = (HP + 15) / 16;                // 16-row tiles
    constexpr int MTW = (MT + NWARPS - 1) / NWARPS;   // tiles per warp
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [MT*16][XS_LD]
    __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(ws);    // [CE][XS_LD]
    const int g = lane >> 2, tig = lane & 3;
    float acc[MTW][CE / 8][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int nt = 0; nt < CE / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += CK) {
      __syncthreads();  // the previous step's readers are done
      for (int idx = threadIdx.x; idx < MT * 16 * (CK / 8); idx += NTHREADS) {
        const int p = idx / (CK / 8), q = idx % (CK / 8);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        const int ci = k0 + q * 8;
        if (p < HP && ci < cin) {
          const int gy = reflect_idx(ty0 - P + p / HW, H);
          const int gx = reflect_idx(tx0 - P + p % HW, W);
          v = *reinterpret_cast<const uint4*>(
              xn + ((size_t)gy * W + gx) * cin + ci);
        }
        *reinterpret_cast<uint4*>(&xs[p * XS_LD + q * 8]) = v;
      }
      for (int idx = threadIdx.x; idx < CE * CK; idx += NTHREADS) {
        const int cc = idx / CK, ci = idx % CK;
        T v = from_f32<T>(0.f);
        if (k0 + ci < cin && c0 + cc < E) v = we[(size_t)(k0 + ci) * E + c0 + cc];
        wsT[cc * XS_LD + ci] = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < CK; ks += 16) {
        if (k0 + ks >= cin) break;  // the rest of the chunk is zero
        uint32_t b[CE / 8][2];
#pragma unroll
        for (int nt = 0; nt < CE / 8; ++nt) {
          const __nv_bfloat16* bp = wsT + (nt * 8 + g) * XS_LD + ks + tig * 2;
          b[nt][0] = lds32(bp);
          b[nt][1] = lds32(bp + 8);
        }
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const int mt = warp + i * NWARPS;
          if (mt < MT) {
            const __nv_bfloat16* ap = xs + (mt * 16 + g) * XS_LD + ks + tig * 2;
            const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * XS_LD),
                                   lds32(ap + 8), lds32(ap + 8 * XS_LD + 8)};
#pragma unroll
            for (int nt = 0; nt < CE / 8; ++nt) mma_bf16(acc[i][nt], a, b[nt]);
          }
        }
      }
    }
    __syncthreads();  // every read of the staged x is done
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = warp + i * NWARPS;
#pragma unroll
      for (int nt = 0; nt < CE / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = mt * 16 + g + (r >= 2 ? 8 : 0);
          const int col = nt * 8 + tig * 2 + (r & 1);
          if (mt < MT && row < HP) {
            float v = acc[i][nt][r];
            if (be != nullptr && c0 + col < E) v += be[c0 + col];
            if (pre_act) v = hswish(v);
            buf[row * CE + col] = expanded<T, ROUND>(v);
          }
        }
    }
  } else if constexpr (EXPAND) {
    float acc[NPX];
#pragma unroll
    for (int i = 0; i < NPX; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += CK) {
      const int kc = min(CK, cin - k0);
      __syncthreads();  // the previous step's readers are done
      for (int idx = threadIdx.x; idx < HP * CK; idx += NTHREADS) {
        const int p = idx / CK, ci = idx % CK;
        float v = 0.f;
        if (ci < kc) {
          const int gy = reflect_idx(ty0 - P + p / HW, H);
          const int gx = reflect_idx(tx0 - P + p % HW, W);
          v = to_f32(xn[((size_t)gy * W + gx) * cin + k0 + ci]);
        }
        buf[idx] = v;
      }
      for (int idx = threadIdx.x; idx < CK * CE; idx += NTHREADS) {
        const int ci = idx / CE, cc = idx % CE;
        float v = 0.f;
        if (ci < kc && c0 + cc < E) {
          v = to_f32(we[(size_t)(k0 + ci) * E + c0 + cc]);
        }
        ws[idx] = v;
      }
      __syncthreads();
      const int kc4 = (kc + 3) & ~3;  // staged tail channels are zero
      for (int ci = 0; ci < kc4; ci += 4) {
        const float w0 = ws[(ci + 0) * CE + lane];
        const float w1 = ws[(ci + 1) * CE + lane];
        const float w2 = ws[(ci + 2) * CE + lane];
        const float w3 = ws[(ci + 3) * CE + lane];
#pragma unroll
        for (int i = 0; i < NPX; ++i) {
          const int p = warp + i * NWARPS;
          if (p < HP) {
            const float4 xv =
                *reinterpret_cast<const float4*>(&buf[p * CK + ci]);
            acc[i] = fmaf(xv.x, w0, acc[i]);
            acc[i] = fmaf(xv.y, w1, acc[i]);
            acc[i] = fmaf(xv.z, w2, acc[i]);
            acc[i] = fmaf(xv.w, w3, acc[i]);
          }
        }
      }
    }
    __syncthreads();  // every read of the staged x is done
    const float bev = (be != nullptr && c_ok) ? be[c] : 0.f;
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int p = warp + i * NWARPS;
      if (p < HP) {
        float v = acc[i] + bev;
        if (pre_act) v = hswish(v);
        buf[p * CE + lane] = expanded<T, ROUND>(v);
      }
    }
  } else {
    // expand==1: the depthwise input is x itself (E == cin).
    for (int idx = threadIdx.x; idx < HP * CE; idx += NTHREADS) {
      const int p = idx / CE, cc = idx % CE;
      float v = 0.f;
      if (c0 + cc < E) {
        const int gy = reflect_idx(ty0 - P + p / HW, H);
        const int gx = reflect_idx(tx0 - P + p % HW, W);
        v = to_f32(xn[((size_t)gy * W + gx) * cin + c0 + cc]);
        if (be != nullptr) v += be[c0 + cc];
        if (pre_act) v = hswish(v);
      }
      buf[idx] = expanded<T, ROUND>(v);
    }
  }
  __syncthreads();

  // Depthwise over the expanded halo: each thread walks full-height column
  // strips (ox, lane), so each loaded value feeds up to K accumulators.
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = c_ok ? wd[(size_t)t * E + c] : 0.f;
  const float bdv = (bd != nullptr && c_ok) ? bd[c] : 0.f;
  float csum = 0.f;
  T* hn = hidden + (size_t)n * H * W * E;
  for (int ox = warp; ox < TW; ox += NWARPS) {
    float o[TH];
#pragma unroll
    for (int r = 0; r < TH; ++r) o[r] = 0.f;
#pragma unroll
    for (int r = 0; r < HH; ++r) {
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        const float v = buf[(r * HW + ox + dj) * CE + lane];
#pragma unroll
        for (int di = 0; di < K; ++di) {
          const int oy = r - di;
          if (oy >= 0 && oy < TH) o[oy] = fmaf(v, wk[di * K + dj], o[oy]);
        }
      }
    }
    const int gx = tx0 + ox;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const int gy = ty0 + r;
      const float v = hswish(o[r] + bdv);
      if (c_ok && gy < H && gx < W) {
        const T hv = from_f32<T>(v);
        hn[((size_t)gy * W + gx) * E + c] = hv;
        csum += ROUND ? to_f32(hv) : v;
      }
    }
  }

  // SE sums: reduce the 8 warps' partials per channel, one atomic each.
  __syncthreads();  // every read of buf is done
  buf[warp * 32 + lane] = csum;
  __syncthreads();
  if (warp == 0 && c_ok) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < NWARPS; ++w8) s += buf[w8 * 32 + lane];
    atomicAdd(&sums[(size_t)n * E + c], s);
  }
}

template <typename T, int K, bool EXPAND, bool MMA, bool ROUND>
cudaError_t launch(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, void* hidden, void* sums,
                   int n, int h, int w, int cin, int e, int pre_act,
                   cudaStream_t stream) {
  constexpr int P = (K - 1) / 2;
  constexpr int HP = (TH + 2 * P) * (TW + 2 * P);
  const int smem = (HP * 32 + CK * CE) * (int)sizeof(float);
  auto kernel = expand_dw_kernel<T, K, EXPAND, MMA, ROUND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, (e + CE - 1) / CE, n);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<T*>(hidden),
      static_cast<float*>(sums), h, w, cin, e, pre_act, tiles_x);
  return cudaGetLastError();
}

template <typename T, int K, bool ROUND>
cudaError_t dispatch_k(const void* x, const void* we, const void* wd,
                       const void* be, const void* bd, void* hidden,
                       void* sums, int n, int h, int w, int cin, int e,
                       int pre_act, cudaStream_t s) {
  if (we == nullptr)
    return launch<T, K, false, false, ROUND>(x, we, wd, be, bd, hidden, sums,
                                             n, h, w, cin, e, pre_act, s);
  const bool mma = sizeof(T) == 2 && cin % 8 == 0 && aligned(x, 16);
  if (mma)
    return launch<T, K, true, sizeof(T) == 2, ROUND>(
        x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s);
  return launch<T, K, true, false, ROUND>(x, we, wd, be, bd, hidden, sums, n,
                                          h, w, cin, e, pre_act, s);
}

// hidden (n, h, w, e) and sums (n, e) must be allocated by the caller, sums
// zeroed; we == nullptr is the expand==1 form (e == cin).
template <typename T, bool ROUND>
cudaError_t dispatch(const void* x, const void* we, const void* wd,
                     const void* be, const void* bd, void* hidden, void* sums,
                     int n, int h, int w, int cin, int e, int k, int pre_act,
                     cudaStream_t s) {
  if (we == nullptr && e != cin) return cudaErrorInvalidValue;
  if (k == 3)
    return dispatch_k<T, 3, ROUND>(x, we, wd, be, bd, hidden, sums, n, h, w,
                                   cin, e, pre_act, s);
  if (k == 5)
    return dispatch_k<T, 5, ROUND>(x, we, wd, be, bd, hidden, sums, n, h, w,
                                   cin, e, pre_act, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace edw
}  // namespace ast_kernels
