// Fused 1x1 expand + k x k depthwise of one stride-1 inverted-residual block:
// the device code behind expand_dw.cu (the fused route), the first sweep of
// flat_block.cu (the flat route) and mega_block.cu (the mega route), and the
// two passes of fused_2pass.cu.
//
//   h      = hswish(x @ We + be)              (pre_act; f32 accumulation)
//   out    = hswish(dw_kxk(reflect_pad(h)) + bd)
//   hidden = out rounded to x's dtype,  sums[n, c] = sum over H, W
//
// MODE says where the values are rounded to the I/O dtype, after the TPU
// kernel each route ports, which layout x has and what is written:
//   * kRoundEx: the expanded values are rounded before the depthwise
//     (flatblock._flat_kernel); otherwise the depthwise runs in f32 on the
//     unrounded expanded values (fused_block._fused_kernel,
//     megablock._mega_kernel_t);
//   * kSumRounded: the SE sums are taken of the rounded hidden (_flat_kernel,
//     _mega_kernel_t); otherwise of `out` before it is rounded
//     (_fused_kernel);
//   * kXT: x is (N, H, C, W) with W contiguous (_mega_kernel_t); otherwise
//     NHWC.  The hidden is NHWC either way;
//   * kNoHidden: only the sums are written (_fused_kernel "sums").
// At f32 the rounding bits change nothing.
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
//   * Expand (expand_halo): the reflect-indexed input halo (16+2p)^2 pixels
//     is staged in shared memory 32 input channels at a time (no padded copy
//     of x in HBM: the reflection is an index map, valid because expand and
//     hswish are per pixel).  Channels past C_in are staged as zeros, so K is
//     padded to 16 in shared memory, never in HBM.
//     - bf16 with NHWC x, C_in % 8 == 0 and 16-byte aligned x (every NHWC
//       block of the model): staged as bf16 with 16-byte loads; each warp
//       runs mma.sync on up to 4 row tiles of 16 halo pixels x all 32
//       channels.
//     - bf16 with (N, H, C, W) x, any C_in: the same products, staged with
//       a thread per (channel, halo row): 16-byte loads of the interior.
//     - otherwise (f32, or other channel counts): staged as f32; each thread
//       keeps its halo pixels' expanded values in registers, reading x as
//       float4 broadcasts (~4 FMAs per load).
//   * The expanded halo (f32) then replaces the staging buffer; the
//     depthwise (depthwise_tile) walks column strips so each loaded value
//     feeds k FMAs.
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

// MODE bits (see the top of this file).
constexpr int kRoundEx = 1;
constexpr int kSumRounded = 2;
constexpr int kXT = 4;
constexpr int kNoHidden = 8;
constexpr int kFused = 0;                      // _fused_kernel "hidden"
constexpr int kFlat = kRoundEx | kSumRounded;  // _flat_kernel
constexpr int kMega = kSumRounded | kXT;       // _mega_kernel_t
constexpr int kSums = kNoHidden;               // _fused_kernel "sums"

// Shared memory of expand_halo: the halo buffer and the staged weights.
template <int K>
__host__ __device__ constexpr int halo_smem_bytes() {
  return ((TH + K - 1) * (TW + K - 1) * 32 + CK * CE) * (int)sizeof(float);
}

// x[n] at row gy, column gx, channel ci; xn is image n's base.
template <typename T, bool XT>
__device__ __forceinline__ T x_at(const T* __restrict__ xn, int gy, int gx,
                                  int ci, int W, int cin) {
  return XT ? xn[((size_t)gy * cin + ci) * W + gx]
            : xn[((size_t)gy * W + gx) * cin + ci];
}

// The expanded halo of output tile (ty0, tx0), hidden channels [c0, c0 + 32),
// into buf[HP][32] (f32; rounded to T with kRoundEx).  buf is followed by
// CK * CE floats of staging for the weights.  Starts and ends with a barrier.
// EXPAND: a 1x1 expand precedes the depthwise; MMA: it runs on the tensor
// cores (bf16 only).
template <typename T, int K, bool EXPAND, bool MMA, int MODE>
__device__ __forceinline__ void expand_halo(
    const T* __restrict__ xn, const T* __restrict__ we,
    const float* __restrict__ be, float* buf, int H, int W, int cin, int E,
    int pre_act, int ty0, int tx0, int c0) {
  constexpr int P = (K - 1) / 2;
  constexpr int HW = TW + 2 * P;                   // halo columns
  constexpr int HP = (TH + 2 * P) * HW;            // halo pixels
  constexpr int NPX = (HP + NWARPS - 1) / NWARPS;  // halo pixels per warp
  constexpr bool XT = (MODE & kXT) != 0;
  constexpr bool ROUND_EX = (MODE & kRoundEx) != 0;
  float* ws = buf + HP * 32;  // expand weights

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool c_ok = c < E;

  __syncthreads();  // the previous readers of buf are done
  if constexpr (MMA) {
    constexpr int MT = (HP + 15) / 16;                // 16-row tiles
    constexpr int MTW = (MT + NWARPS - 1) / NWARPS;   // tiles per warp
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(buf);  // [MT*16][XS_LD]
    __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(ws);  // [CE][XS_LD]
    const int g = lane >> 2, tig = lane & 3;
    float acc[MTW][CE / 8][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int nt = 0; nt < CE / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += CK) {
      if (k0 > 0) __syncthreads();  // the previous step's readers are done
      if constexpr (XT) {
        // One thread per (channel, halo row), lanes on consecutive
        // channels, so the transposing stores are conflict-free.  The 16
        // interior columns come as two 16-byte loads where the tile lies
        // inside the image and W % 8 == 0 (every block of the model), the
        // 2p reflected edge columns one by one; all loads are issued
        // before the stores.
        constexpr int HH = TH + 2 * P;
        const bool vec = W % 8 == 0 && tx0 + TW <= W &&
                         (reinterpret_cast<uintptr_t>(xn) & 15) == 0;
        for (int pr = threadIdx.x; pr < CK * HH; pr += NTHREADS) {
          const int q = pr % CK, hr = pr / CK;
          __nv_bfloat16* dst = xs + hr * HW * XS_LD + q;  // column c: c * XS_LD
          if (k0 + q >= cin) {
#pragma unroll
            for (int col = 0; col < HW; ++col)
              dst[col * XS_LD] = from_f32<T>(0.f);
            continue;
          }
          const T* row =
              xn + ((size_t)reflect_idx(ty0 - P + hr, H) * cin + k0 + q) * W;
          if (vec) {
            const uint4 a = *reinterpret_cast<const uint4*>(row + tx0);
            const uint4 b = *reinterpret_cast<const uint4*>(row + tx0 + 8);
            T edge[2 * P];
#pragma unroll
            for (int j = 0; j < P; ++j) {
              edge[j] = row[reflect_idx(tx0 - P + j, W)];
              edge[P + j] = row[reflect_idx(tx0 + TW + j, W)];
            }
            const T* av = reinterpret_cast<const T*>(&a);
            const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
            for (int j = 0; j < P; ++j) {
              dst[j * XS_LD] = edge[j];
              dst[(P + TW + j) * XS_LD] = edge[P + j];
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              dst[(P + j) * XS_LD] = av[j];
              dst[(P + 8 + j) * XS_LD] = bv[j];
            }
          } else {
#pragma unroll
            for (int col = 0; col < HW; ++col)
              dst[col * XS_LD] = row[reflect_idx(tx0 - P + col, W)];
          }
        }
        // The rows of the last MMA tile past the halo feed only outputs
        // that are dropped; zero them all the same.
        for (int idx = threadIdx.x; idx < (MT * 16 - HP) * CK;
             idx += NTHREADS)
          xs[(HP + idx / CK) * XS_LD + idx % CK] = from_f32<T>(0.f);
      } else {
        for (int idx = threadIdx.x; idx < MT * 16 * (CK / 8);
             idx += NTHREADS) {
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
            buf[row * CE + col] = ROUND_EX ? round_to<T>(v) : v;
          }
        }
    }
  } else if constexpr (EXPAND) {
    float acc[NPX];
#pragma unroll
    for (int i = 0; i < NPX; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += CK) {
      const int kc = min(CK, cin - k0);
      if (k0 > 0) __syncthreads();  // the previous step's readers are done
      for (int idx = threadIdx.x; idx < HP * CK; idx += NTHREADS) {
        const int p = idx / CK, ci = idx % CK;
        float v = 0.f;
        if (ci < kc) {
          const int gy = reflect_idx(ty0 - P + p / HW, H);
          const int gx = reflect_idx(tx0 - P + p % HW, W);
          v = to_f32(x_at<T, XT>(xn, gy, gx, k0 + ci, W, cin));
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
        buf[p * CE + lane] = ROUND_EX ? round_to<T>(v) : v;
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
        v = to_f32(x_at<T, XT>(xn, gy, gx, c0 + cc, W, cin));
        if (be != nullptr) v += be[c0 + cc];
        if (pre_act) v = hswish(v);
      }
      buf[idx] = ROUND_EX ? round_to<T>(v) : v;
    }
  }
  __syncthreads();
}

// Depthwise over the expanded halo in buf for channel c = c0 + lane: each
// thread walks full-height column strips (ox, lane), so each loaded value
// feeds up to K accumulators.  Calls emit(r, ox, v) with
// v = hswish(dw + bd) in f32 for every output (r, ox) of the 16x16 tile; the
// caller masks the ragged edge and channels past E.
template <int K, class Emit>
__device__ __forceinline__ void depthwise_tile(const float* buf,
                                               const float* __restrict__ wd,
                                               const float* __restrict__ bd,
                                               int E, int c, Emit emit) {
  constexpr int P = (K - 1) / 2;
  constexpr int HH = TH + 2 * P;  // halo rows
  constexpr int HW = TW + 2 * P;  // halo columns
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool c_ok = c < E;
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = c_ok ? wd[(size_t)t * E + c] : 0.f;
  const float bdv = (bd != nullptr && c_ok) ? bd[c] : 0.f;
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
#pragma unroll
    for (int r = 0; r < TH; ++r) emit(r, ox, hswish(o[r] + bdv));
  }
}

template <typename T, int K, bool EXPAND, bool MMA, int MODE>
__global__ void __launch_bounds__(NTHREADS)
    expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ we,
                     const float* __restrict__ wd,
                     const float* __restrict__ be,
                     const float* __restrict__ bd, T* __restrict__ hidden,
                     float* __restrict__ sums, int H, int W, int cin, int E,
                     int pre_act, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // [HP][32]: x, then h

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * CE;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int c = c0 + lane;
  const bool c_ok = c < E;

  expand_halo<T, K, EXPAND, MMA, MODE>(x + (size_t)n * H * W * cin, we, be,
                                       buf, H, W, cin, E, pre_act, ty0, tx0,
                                       c0);
  float csum = 0.f;
  const size_t hn = (size_t)n * H * W * E;
  depthwise_tile<K>(buf, wd, bd, E, c, [&](int r, int ox, float v) {
    const int gy = ty0 + r, gx = tx0 + ox;
    if (c_ok && gy < H && gx < W) {
      const T hv = from_f32<T>(v);
      if constexpr ((MODE & kNoHidden) == 0)
        hidden[hn + ((size_t)gy * W + gx) * E + c] = hv;
      csum += (MODE & kSumRounded) ? to_f32(hv) : v;
    }
  });

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

template <typename T, int K, bool EXPAND, bool MMA, int MODE>
cudaError_t launch(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, void* hidden, void* sums,
                   int n, int h, int w, int cin, int e, int pre_act,
                   cudaStream_t stream) {
  const int smem = halo_smem_bytes<K>();
  auto kernel = expand_dw_kernel<T, K, EXPAND, MMA, MODE>;
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

// Whether the expand runs on the tensor cores: bf16, and for NHWC x the
// 16-byte staging loads need C_in % 8 == 0 and an aligned x.
template <typename T, int MODE>
bool use_mma(const void* x, int cin) {
  return sizeof(T) == 2 &&
         ((MODE & kXT) != 0 || (cin % 8 == 0 && aligned(x, 16)));
}

template <typename T, int K, int MODE>
cudaError_t dispatch_k(const void* x, const void* we, const void* wd,
                       const void* be, const void* bd, void* hidden,
                       void* sums, int n, int h, int w, int cin, int e,
                       int pre_act, cudaStream_t s) {
  if (we == nullptr)
    return launch<T, K, false, false, MODE>(x, we, wd, be, bd, hidden, sums,
                                            n, h, w, cin, e, pre_act, s);
  if (use_mma<T, MODE>(x, cin))
    return launch<T, K, true, sizeof(T) == 2, MODE>(
        x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s);
  return launch<T, K, true, false, MODE>(x, we, wd, be, bd, hidden, sums, n,
                                         h, w, cin, e, pre_act, s);
}

// hidden (n, h, w, e) (unused with kNoHidden) and sums (n, e) must be
// allocated by the caller, sums zeroed; we == nullptr is the expand==1 form
// (e == cin).
template <typename T, int MODE>
cudaError_t dispatch(const void* x, const void* we, const void* wd,
                     const void* be, const void* bd, void* hidden, void* sums,
                     int n, int h, int w, int cin, int e, int k, int pre_act,
                     cudaStream_t s) {
  if (we == nullptr && e != cin) return cudaErrorInvalidValue;
  if (k == 3)
    return dispatch_k<T, 3, MODE>(x, we, wd, be, bd, hidden, sums, n, h, w,
                                  cin, e, pre_act, s);
  if (k == 5)
    return dispatch_k<T, 5, MODE>(x, we, wd, be, bd, hidden, sums, n, h, w,
                                  cin, e, pre_act, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace edw
}  // namespace ast_kernels
