// The whole stride-2 inverted-residual block in two launches.
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/flatblock_s2.py
// `_flat_s2_kernel` (host wrappers `flat_s2_expand_dw_project`,
// `flat_s2_block_apply_f`): flat_block.cu's math with a stride-2 depthwise and
// no residual.  For x (N, H, W, C_in), H and W even:
//
//   ex     = round(hswish(x @ We + be))                       (input res.)
//   hidden = round(hswish(dw_kxk_stride2(reflect_pad(ex), Wd) + bd))
//   sums   = sum over H/2, W/2 of hidden
//   y      = round((hidden * round(gate(sums))) @ Wp [f32 acc] + pb)
//
// What the TPU kernel keeps out of HBM is the expanded hidden at INPUT
// resolution (e2 at 512px batch 16: 16 x 96 x 512^2 x 2 B = 805 MB); its
// output-resolution hidden is 4x smaller.  The TPU lowers the stride-2
// depthwise through four space-to-depth parity planes built on the host,
// because its lanes want stride-1 shifts.  Here the stride is indexed
// directly and no plane is built:
//   * sweep 1 (this file): one CTA per (image, output tile, 32-channel chunk
//     of E), 256 threads.  The output tile is 16x16 (bf16) or 8x8 (f32); its
//     input halo, (2*16 - 1 + 2p)^2 pixels (33^2 at k3, 35^2 at k5), is
//     expanded from reflect-indexed x into shared memory, already rounded to
//     the I/O dtype, which is where the math rounds anyway: 33^2 x 32 x 2 B =
//     70 KB at k3 and 78 KB at k5.  The expand runs in passes of 256 halo
//     pixels, on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate) for bf16 with C_in % 8 == 0, otherwise on the CUDA cores
//     (passes of 128 pixels).  The stride-2 taps then read the rounded halo
//     (lane = channel, each loaded value feeding up to k accumulators of a
//     column strip), and the output-resolution hidden and its exact sums are
//     written as in expand_dw.cuh.  The input-resolution hidden never leaves
//     shared memory.
//   * sweep 2: gate_project.cuh without residual.
// What bounds sweep 1 on an H100: the expand at input resolution, 4x the
// output pixels' C_in x E MACs plus the halo (1.2x at k3), on the tensor
// cores, then k*k f32 FMAs per output hidden value; HBM traffic is one read
// of x and one write of the output-resolution hidden.

#include "common.cuh"
#include "gate_project.cuh"

namespace ast_kernels {
namespace s2 {
namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int CE = 32;                       // hidden channels per CTA
constexpr int CK = 32;                       // input channels per expand step
constexpr int XS_LD = CK + 8;                // bf16 staging row: 80 B
constexpr int MT_PASS = 2;                   // 16-pixel tiles per warp (MMA)
constexpr int PASS_MMA = NWARPS * MT_PASS * 16;  // halo pixels per pass
constexpr int NPW = 16;                      // pixels per warp (CUDA cores)
constexpr int PASS_CC = NWARPS * NPW;

template <typename T, int K>
struct Geo {
  static constexpr int P = (K - 1) / 2;
  static constexpr int TO = sizeof(T) == 2 ? 16 : 8;  // output tile side
  static constexpr int HS = 2 * TO - 1 + 2 * P;        // input halo side
  static constexpr int HP = HS * HS;
  static constexpr int EX_BYTES =
      (HP * CE * (int)sizeof(T) + 15) / 16 * 16;       // rounded halo
  static constexpr int STAGE_MMA = (PASS_MMA + CE) * XS_LD * 2;
  static constexpr int STAGE_CC = (PASS_CC * CK + CK * CE) * 4;
};

// MMA: the expand runs on the tensor cores (bf16 only, C_in % 8 == 0,
// 16-byte aligned x).
template <typename T, int K, bool MMA>
__global__ void __launch_bounds__(NTHREADS)
    s2_expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ we,
                        const float* __restrict__ wd,
                        const float* __restrict__ be,
                        const float* __restrict__ bd, T* __restrict__ hidden,
                        float* __restrict__ sums, int H, int W, int cin,
                        int E, int tiles_x) {
  using G = Geo<T, K>;
  constexpr int P = G::P, TO = G::TO, HS = G::HS, HP = G::HP;
  extern __shared__ float4 smem4[];
  T* exs = reinterpret_cast<T*>(smem4);  // [HP][CE], the rounded halo
  char* stage = reinterpret_cast<char*>(smem4) + G::EX_BYTES;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * CE;
  const int c = c0 + lane;
  const bool c_ok = c < E;
  const int Ho = H / 2, Wo = W / 2;
  const int oy0 = (blockIdx.x / tiles_x) * TO;
  const int ox0 = (blockIdx.x % tiles_x) * TO;
  const int iy0 = 2 * oy0 - P, ix0 = 2 * ox0 - P;  // halo origin, input res.
  const T* xn = x + (size_t)n * H * W * cin;

  if constexpr (MMA) {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);
    __nv_bfloat16* wsT = xs + PASS_MMA * XS_LD;  // [CE][XS_LD]
    const int g = lane >> 2, tig = lane & 3;
    for (int pb = 0; pb < HP; pb += PASS_MMA) {
      float acc[MT_PASS][CE / 8][4];
#pragma unroll
      for (int i = 0; i < MT_PASS; ++i)
#pragma unroll
        for (int nt = 0; nt < CE / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
      for (int k0 = 0; k0 < cin; k0 += CK) {
        __syncthreads();  // the previous step's readers are done
        for (int idx = threadIdx.x; idx < PASS_MMA * (CK / 8);
             idx += NTHREADS) {
          const int p = idx / (CK / 8), q = idx % (CK / 8);
          const int hp = pb + p, ci = k0 + q * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (hp < HP && ci < cin) {
            const int gy = reflect_idx(iy0 + hp / HS, H);
            const int gx = reflect_idx(ix0 + hp % HS, W);
            v = *reinterpret_cast<const uint4*>(
                xn + ((size_t)gy * W + gx) * cin + ci);
          }
          *reinterpret_cast<uint4*>(&xs[p * XS_LD + q * 8]) = v;
        }
        for (int idx = threadIdx.x; idx < CE * CK; idx += NTHREADS) {
          const int cc = idx / CK, ci = idx % CK;
          T v = from_f32<T>(0.f);
          if (k0 + ci < cin && c0 + cc < E)
            v = we[(size_t)(k0 + ci) * E + c0 + cc];
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
          for (int i = 0; i < MT_PASS; ++i) {
            const int mt = warp + i * NWARPS;
            const __nv_bfloat16* ap = xs + (mt * 16 + g) * XS_LD + ks + tig * 2;
            const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * XS_LD),
                                   lds32(ap + 8), lds32(ap + 8 * XS_LD + 8)};
#pragma unroll
            for (int nt = 0; nt < CE / 8; ++nt) mma_bf16(acc[i][nt], a, b[nt]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT_PASS; ++i) {
        const int mt = warp + i * NWARPS;
#pragma unroll
        for (int nt = 0; nt < CE / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int hp = pb + mt * 16 + g + (r >= 2 ? 8 : 0);
            const int col = nt * 8 + tig * 2 + (r & 1);
            if (hp < HP) {
              float v = acc[i][nt][r];
              if (be != nullptr && c0 + col < E) v += be[c0 + col];
              exs[hp * CE + col] = from_f32<T>(hswish(v));
            }
          }
      }
    }
  } else {
    float* xsf = reinterpret_cast<float*>(stage);  // [PASS_CC][CK]
    float* wsf = xsf + PASS_CC * CK;               // [CK][CE]
    const float bev = (be != nullptr && c_ok) ? be[c] : 0.f;
    for (int pb = 0; pb < HP; pb += PASS_CC) {
      float acc[NPW];
#pragma unroll
      for (int i = 0; i < NPW; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < cin; k0 += CK) {
        const int kc = min(CK, cin - k0);
        __syncthreads();  // the previous step's readers are done
        for (int idx = threadIdx.x; idx < PASS_CC * CK; idx += NTHREADS) {
          const int p = idx / CK, ci = idx % CK;
          const int hp = pb + p;
          float v = 0.f;
          if (hp < HP && ci < kc) {
            const int gy = reflect_idx(iy0 + hp / HS, H);
            const int gx = reflect_idx(ix0 + hp % HS, W);
            v = to_f32(xn[((size_t)gy * W + gx) * cin + k0 + ci]);
          }
          xsf[idx] = v;
        }
        for (int idx = threadIdx.x; idx < CK * CE; idx += NTHREADS) {
          const int ci = idx / CE, cc = idx % CE;
          float v = 0.f;
          if (ci < kc && c0 + cc < E)
            v = to_f32(we[(size_t)(k0 + ci) * E + c0 + cc]);
          wsf[idx] = v;
        }
        __syncthreads();
        const int kc4 = (kc + 3) & ~3;  // staged tail channels are zero
        for (int ci = 0; ci < kc4; ci += 4) {
          const float w0 = wsf[(ci + 0) * CE + lane];
          const float w1 = wsf[(ci + 1) * CE + lane];
          const float w2 = wsf[(ci + 2) * CE + lane];
          const float w3 = wsf[(ci + 3) * CE + lane];
#pragma unroll
          for (int i = 0; i < NPW; ++i) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &xsf[(warp + i * NWARPS) * CK + ci]);
            acc[i] = fmaf(xv.x, w0, acc[i]);
            acc[i] = fmaf(xv.y, w1, acc[i]);
            acc[i] = fmaf(xv.z, w2, acc[i]);
            acc[i] = fmaf(xv.w, w3, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int hp = pb + warp + i * NWARPS;
        if (hp < HP) exs[hp * CE + lane] = from_f32<T>(hswish(acc[i] + bev));
      }
    }
  }
  __syncthreads();

  // Stride-2 depthwise over the rounded halo: output (oy, ox) tap (di, dj)
  // reads halo (2 oy + di, 2 ox + dj).  Each thread walks column strips
  // (ox, lane), so each loaded value feeds up to ceil(K / 2) accumulators.
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = c_ok ? wd[(size_t)t * E + c] : 0.f;
  const float bdv = (bd != nullptr && c_ok) ? bd[c] : 0.f;
  float csum = 0.f;
  T* hn = hidden + (size_t)n * Ho * Wo * E;
  for (int ox = warp; ox < TO; ox += NWARPS) {
    float o[TO];
#pragma unroll
    for (int r = 0; r < TO; ++r) o[r] = 0.f;
#pragma unroll
    for (int r = 0; r < HS; ++r) {
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        const float v = to_f32(exs[(r * HS + 2 * ox + dj) * CE + lane]);
#pragma unroll
        for (int di = 0; di < K; ++di) {
          const int d = r - di;
          if (d >= 0 && (d & 1) == 0 && (d >> 1) < TO)
            o[d >> 1] = fmaf(v, wk[di * K + dj], o[d >> 1]);
        }
      }
    }
    const int gx = ox0 + ox;
#pragma unroll
    for (int r = 0; r < TO; ++r) {
      const int gy = oy0 + r;
      if (c_ok && gy < Ho && gx < Wo) {
        const T hv = from_f32<T>(hswish(o[r] + bdv));
        hn[((size_t)gy * Wo + gx) * E + c] = hv;
        csum += to_f32(hv);
      }
    }
  }

  // SE sums: reduce the 8 warps' partials per channel, one atomic each.
  __syncthreads();  // every read of the halo is done
  float* red = reinterpret_cast<float*>(smem4);
  red[warp * 32 + lane] = csum;
  __syncthreads();
  if (warp == 0 && c_ok) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < NWARPS; ++w8) s += red[w8 * 32 + lane];
    atomicAdd(&sums[(size_t)n * E + c], s);
  }
}

template <typename T, int K, bool MMA>
cudaError_t launch(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, void* hidden, void* sums,
                   int n, int h, int w, int cin, int e, cudaStream_t stream) {
  using G = Geo<T, K>;
  const int smem = G::EX_BYTES + (MMA ? G::STAGE_MMA : G::STAGE_CC);
  auto kernel = s2_expand_dw_kernel<T, K, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w / 2 + G::TO - 1) / G::TO;
  const int tiles_y = (h / 2 + G::TO - 1) / G::TO;
  dim3 grid(tiles_x * tiles_y, (e + CE - 1) / CE, n);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<T*>(hidden),
      static_cast<float*>(sums), h, w, cin, e, tiles_x);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_k(const void* x, const void* we, const void* wd,
                       const void* be, const void* bd, void* hidden,
                       void* sums, int n, int h, int w, int cin, int e,
                       cudaStream_t s) {
  if (sizeof(T) == 2 && cin % 8 == 0 && aligned(x, 16))
    return launch<T, K, sizeof(T) == 2>(x, we, wd, be, bd, hidden, sums, n,
                                        h, w, cin, e, s);
  return launch<T, K, false>(x, we, wd, be, bd, hidden, sums, n, h, w, cin,
                             e, s);
}

template <typename T>
cudaError_t run(const void* x, const void* we, const void* wd, const void* be,
                const void* bd, const void* d0t, const void* d0b,
                const void* d1k, const void* d1b, const void* wpt,
                const void* pb, void* hidden, void* sums, void* gate, void* y,
                int n, int h, int w, int cin, int e, int s, int cout, int k,
                cudaStream_t st) {
  cudaError_t err;
  if (k == 3)
    err = dispatch_k<T, 3>(x, we, wd, be, bd, hidden, sums, n, h, w, cin, e,
                           st);
  else if (k == 5)
    err = dispatch_k<T, 5>(x, we, wd, be, bd, hidden, sums, n, h, w, cin, e,
                           st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return gp::launch<T>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, nullptr,
                       gate, y, n, (h / 2) * (w / 2), e, s, cout, st);
}

}  // namespace
}  // namespace s2
}  // namespace ast_kernels

// x (n, h, w, cin) with h, w even; hidden (n, h/2, w/2, e), sums (n, e),
// gate (n, e; f32 scratch) and y (n, h/2, w/2, cout) must be allocated by
// the caller, sums zeroed.  The
// SE and projection operands are as in flat_block_launch.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flat_s2_launch(const void* x, const void* we, const void* wd,
                              const void* be, const void* bd, const void* d0t,
                              const void* d0b, const void* d1k,
                              const void* d1b, const void* wpt,
                              const void* pb, void* hidden, void* sums,
                              void* gate, void* y, int n, int h, int w,
                              int cin, int e, int s, int cout, int k,
                              int is_bf16, void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  if (h % 2 != 0 || w % 2 != 0 || we == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)s2::run<__nv_bfloat16>(x, we, wd, be, bd, d0t, d0b, d1k, d1b,
                                       wpt, pb, hidden, sums, gate, y, n, h,
                                       w, cin, e, s, cout, k, st);
  return (int)s2::run<float>(x, we, wd, be, bd, d0t, d0b, d1k, d1b, wpt, pb,
                             hidden, sums, gate, y, n, h, w, cin, e, s, cout,
                             k, st);
}
