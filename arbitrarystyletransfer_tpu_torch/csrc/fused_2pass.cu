// The two-pass inverted-residual block: SE sums first, then the hidden
// recomputed, gated and projected, so the hidden never reaches HBM.
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/fused_block.py
// `_fused_kernel` in modes "sums" and "project" (host wrapper
// `fused_block_apply_2pass`).  For NHWC x:
//
//   out  = hswish(dw_kxk(reflect_pad(hswish(x @ We + be))) + bd)   (f32)
//   sums = sum over H, W of out                  (f32, before any rounding)
//   -- the host takes gate = se_gate(sums / HW) --
//   y    = round(round(round(out) * round(gate)) @ Wp [f32 acc]) (+ x)
//
// where round() casts to the I/O dtype, at the TPU kernel's rounding points.
// The residual is added in the kernel only when the caller asks (the JAX host
// adds the folded projection bias after the kernel, then the residual).
//
// On the TPU "project" keeps each row tile's hidden in VMEM between the
// depthwise and the projection.  What bounds it on an H100: both passes
// recompute the expand and the f32 depthwise (the work of expand_dw.cu,
// twice), and HBM moves only x (read twice) and y; so the pair trades the
// fused route's hidden round trip (d10 at 512px batch 8: 1.0 GB written and
// read) for a second expand + depthwise, and is bound by that arithmetic and
// its shared-memory traffic, as expand_dw is.
//
// Design (simple; the same 16x16 tiles as expand_dw.cuh):
//   * "sums": expand_dw.cuh's persistent sweep with kSums, the sums of the
//     unrounded hidden by atomics, no hidden stored.
//   * "project": one CTA per (image, 16x16 tile), 256 threads, looping over
//     E in chunks of 32.  The tile's x halo is staged once (expand_dw.cuh's
//     stage_x, a TMA box); each chunk's expand + depthwise (expand_dw.cuh's
//     device functions) leaves 256 pixels x 32 gated, rounded hidden values in
//     shared memory;
//     for bf16 with an even C_out <= 96 each warp then runs mma.sync
//     m16n8k16 on 32 pixels x all of C_out, accumulating in registers across
//     the chunks; otherwise (f32) each thread owns one pixel and accumulates
//     its C_out outputs in shared memory.  The whole hidden of the tile never
//     exists at once: at most 227 KB of shared memory per CTA, against
//     256 x 384 x 2 B for d4's tile alone.

#include "expand_dw.cuh"

namespace ast_kernels {
namespace f2p {
namespace {

using edw::CE;
using edw::DW_COLS;
using edw::DW_ROWS;
using edw::NTHREADS;
using edw::NWARPS;
using edw::TH;
using edw::TW;

constexpr int TP = TH * TW;        // pixels per tile
constexpr int MAX_NT = 12;         // 8-wide output tiles: C_out <= 96
constexpr int MAX_COUT = MAX_NT * 8;
constexpr int HS_LD = CE + 8;      // bf16 hidden row: 80 B, conflict-free frags
constexpr int HS_F32_LD = CE + 1;  // f32 hidden row (CUDA-core projection)
static_assert(TP == NTHREADS, "one pixel per thread in the f32 projection");
static_assert(TP == NWARPS * 2 * 16, "two 16-pixel MMA tiles per warp");

// Shared memory of the project kernel (byte offsets): expand_dw.cuh's
// (the halo buffers and the chunk's expand weights), then the gated hidden
// chunk, the projection weights' chunk and (f32) the outputs.
template <int K, bool EXPAND, bool MMA, bool PMMA>
struct Smem {
  edw::Smem<K, EXPAND, MMA> ex;
  int hs, ws, ys, total;
  __host__ __device__ explicit Smem(int cin) : ex(cin) {
    hs = ex.total;
    ws = hs + (PMMA ? TP * HS_LD * 2 : TP * HS_F32_LD * 4);
    ys = ws + (PMMA ? MAX_COUT * HS_LD * 2 : CE * MAX_COUT * 4);
    total = ys + (PMMA ? 0 : TP * (MAX_COUT + 1) * 4);
  }
};

// y (n, h, w, cout); gate (n, e) f32 from the sums pass; wpt the projection
// transposed, (cout, e); xmap: x as edw::make_x_map's map (MMA only).
// PMMA: the projection runs on the tensor cores.
template <typename T, int K, bool EXPAND, bool MMA, bool PMMA>
__global__ void __launch_bounds__(NTHREADS)
    fused_project_kernel(const __grid_constant__ CUtensorMap xmap,
                         const T* __restrict__ x, const T* __restrict__ we,
                         const float* __restrict__ wd,
                         const float* __restrict__ be,
                         const float* __restrict__ bd,
                         const float* __restrict__ gate,
                         const T* __restrict__ wpt, T* __restrict__ y, int H,
                         int W, int cin, int E, int cout, int pre_act,
                         int identity, int tiles_x) {
  char* base = edw::smem_base();
  const Smem<K, EXPAND, MMA, PMMA> L(cin);
  float* buf = reinterpret_cast<float*>(base);
  char* hs_b = base + L.hs;
  char* ws_b = base + L.ws;
  float* ys = reinterpret_cast<float*>(base + L.ys);  // [TP][cout | 1]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const T* xn = x + (size_t)n * H * W * cin;
  const int nt_count = (cout + 7) / 8;
  const int ldy = cout | 1;

  float acc[2][MAX_NT][4];
  if constexpr (PMMA) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
  } else {
    for (int idx = threadIdx.x; idx < TP * ldy; idx += NTHREADS) ys[idx] = 0.f;
  }

  // The tile's x halo is staged once for every chunk of E (the expand's
  // first barrier publishes it).
  if constexpr (MMA) {
    uint64_t* xbar = reinterpret_cast<uint64_t*>(base + L.ex.bar);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + L.ex.xs);
    if (threadIdx.x == 0) {
      mbar_init(xbar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    edw::stage_x<T, K, edw::kFused>(&xmap, xbar, x, xs, L.ex.ldx,
                                    L.ex.cin16, H, W, cin, n, ty0, tx0);
    edw::wait_x<K>(xbar, 0, xs, L.ex.ldx, H, W, ty0, tx0);
  }
  const int oy0 = edw::dw_row0(), ox0 = edw::dw_col0();
  for (int c0 = 0; c0 < E; c0 += CE) {
    // The previous chunk's expand is done with the expand weights (its last
    // barrier), its projection with the hidden chunk (this expand's first).
    edw::stage_weights<T, K, EXPAND, MMA>(we, be, base, L.ex, cin, E, c0);
    if constexpr (EXPAND)
      edw::expand_halo<T, K, EXPAND, MMA, edw::kFused>(
          xn, base, L.ex, H, W, cin, pre_act, ty0, tx0);
    else
      edw::expand_halo_identity<T, K, edw::kFused>(
          xn, base, reinterpret_cast<const float*>(base + L.ex.bes), H, W,
          cin, pre_act, ty0, tx0, c0);
    const int c = c0 + lane;
    const float gc = c < E ? round_to<T>(gate[(size_t)n * E + c]) : 0.f;
    float wk[K * K], bdv, o[DW_ROWS][DW_COLS];
    edw::load_dw<K>(wd, bd, E, c, wk, bdv);
    edw::depthwise_tile<K>(buf, wk, bdv, o);
#pragma unroll
    for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < DW_COLS; ++j) {
        const int p = (oy0 + r) * TW + ox0 + j;
        float hv = 0.f;
        if (c < E && ty0 + oy0 + r < H && tx0 + ox0 + j < W)
          hv = round_to<T>(round_to<T>(o[r][j]) * gc);
        if constexpr (PMMA)
          reinterpret_cast<__nv_bfloat16*>(hs_b)[p * HS_LD + lane] =
              __float2bfloat16_rn(hv);
        else
          reinterpret_cast<float*>(hs_b)[p * HS_F32_LD + lane] = hv;
      }
    if constexpr (PMMA) {
      __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(ws_b);
      for (int idx = threadIdx.x; idx < nt_count * 8 * CE; idx += NTHREADS) {
        const int co = idx / CE, kk = idx % CE;
        wsT[co * HS_LD + kk] = (co < cout && c0 + kk < E)
                                   ? wpt[(size_t)co * E + c0 + kk]
                                   : __float2bfloat16_rn(0.f);
      }
    } else {
      float* wsf = reinterpret_cast<float*>(ws_b);  // [CE][cout]
      for (int idx = threadIdx.x; idx < CE * cout; idx += NTHREADS) {
        const int kk = idx / cout, co = idx % cout;
        wsf[idx] = c0 + kk < E ? to_f32(wpt[(size_t)co * E + c0 + kk]) : 0.f;
      }
    }
    __syncthreads();

    if constexpr (PMMA) {
      const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(hs_b);
      const __nv_bfloat16* wsT = reinterpret_cast<const __nv_bfloat16*>(ws_b);
#pragma unroll
      for (int ks = 0; ks < CE; ks += 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* ap =
              hs + ((warp * 2 + i) * 16 + g) * HS_LD + ks + tig * 2;
          const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * HS_LD),
                                 lds32(ap + 8), lds32(ap + 8 * HS_LD + 8)};
#pragma unroll
          for (int nt = 0; nt < MAX_NT; ++nt) {
            if (nt < nt_count) {
              const __nv_bfloat16* bp =
                  wsT + (nt * 8 + g) * HS_LD + ks + tig * 2;
              const uint32_t b[2] = {lds32(bp), lds32(bp + 8)};
              mma_bf16(acc[i][nt], a, b);
            }
          }
        }
      }
    } else {
      const float* hs = reinterpret_cast<const float*>(hs_b);
      const float* wsf = reinterpret_cast<const float*>(ws_b);
      const int p = threadIdx.x;
      for (int co = 0; co < cout; ++co) {
        float a = ys[p * ldy + co];
#pragma unroll 8
        for (int kk = 0; kk < CE; ++kk)
          a = fmaf(hs[p * HS_F32_LD + kk], wsf[kk * cout + co], a);
        ys[p * ldy + co] = a;
      }
    }
  }

  T* yn = y + (size_t)n * H * W * cout;
  if constexpr (PMMA) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        const int col = nt * 8 + tig * 2;
        if (nt >= nt_count || col >= cout) continue;  // cout is even
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (warp * 2 + i) * 16 + g + half * 8;
          const int gy = ty0 + p / TW, gx = tx0 + p % TW;
          if (gy >= H || gx >= W) continue;
          const size_t px = (size_t)gy * W + gx;
          __nv_bfloat162 out = __floats2bfloat162_rn(acc[i][nt][2 * half],
                                                     acc[i][nt][2 * half + 1]);
          if (identity) {
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(xn + px * cin + col);
            out = __floats2bfloat162_rn(
                __bfloat162float(out.x) + __bfloat162float(r.x),
                __bfloat162float(out.y) + __bfloat162float(r.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(yn + px * cout + col) = out;
        }
      }
  } else {
    __syncthreads();  // every pixel's outputs are summed
    for (int idx = threadIdx.x; idx < TP * cout; idx += NTHREADS) {
      const int p = idx / cout, co = idx % cout;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const size_t px = (size_t)gy * W + gx;
      T out = from_f32<T>(ys[p * ldy + co]);
      if (identity) out = from_f32<T>(to_f32(out) + to_f32(xn[px * cin + co]));
      yn[px * cout + co] = out;
    }
  }
}

template <typename T, int K, bool EXPAND, bool MMA, bool PMMA>
cudaError_t launch_project(const void* x, const void* we, const void* wd,
                           const void* be, const void* bd, const void* gate,
                           const void* wpt, void* y, int n, int h, int w,
                           int cin, int e, int cout, int pre_act, int identity,
                           cudaStream_t stream) {
  const int smem = Smem<K, EXPAND, MMA, PMMA>(cin).total;
  auto kernel = fused_project_kernel<T, K, EXPAND, MMA, PMMA>;
  CUtensorMap xmap{};
  if (MMA && !edw::make_x_map(&xmap, x, n, h, w, cin,
                                     edw::Halo<K>::HW, edw::Halo<K>::HH))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, n);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      xmap, static_cast<const T*>(x), static_cast<const T*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<const float*>(gate),
      static_cast<const T*>(wpt), static_cast<T*>(y), h, w, cin, e, cout,
      pre_act, identity, tiles_x);
  return cudaGetLastError();
}

template <typename T, int K, bool PMMA>
cudaError_t project_k(const void* x, const void* we, const void* wd,
                      const void* be, const void* bd, const void* gate,
                      const void* wpt, void* y, int n, int h, int w, int cin,
                      int e, int cout, int pre_act, int identity,
                      cudaStream_t s) {
  if (we == nullptr)
    return launch_project<T, K, false, false, PMMA>(
        x, we, wd, be, bd, gate, wpt, y, n, h, w, cin, e, cout, pre_act,
        identity, s);
  if (edw::use_mma<T, edw::kFused>(x, cin))
    return launch_project<T, K, true, sizeof(T) == 2, PMMA>(
        x, we, wd, be, bd, gate, wpt, y, n, h, w, cin, e, cout, pre_act,
        identity, s);
  return launch_project<T, K, true, false, PMMA>(
      x, we, wd, be, bd, gate, wpt, y, n, h, w, cin, e, cout, pre_act,
      identity, s);
}

template <typename T>
cudaError_t project(const void* x, const void* we, const void* wd,
                    const void* be, const void* bd, const void* gate,
                    const void* wpt, void* y, int n, int h, int w, int cin,
                    int e, int cout, int k, int pre_act, int identity,
                    cudaStream_t s) {
  if (cout > MAX_COUT || (we == nullptr && e != cin) ||
      (identity && cin != cout))
    return cudaErrorInvalidValue;
  const bool pmma = sizeof(T) == 2 && cout % 2 == 0 && aligned(y, 4) &&
                    (!identity || aligned(x, 4));
  if (k == 3)
    return pmma ? project_k<T, 3, sizeof(T) == 2>(x, we, wd, be, bd, gate,
                                                  wpt, y, n, h, w, cin, e,
                                                  cout, pre_act, identity, s)
                : project_k<T, 3, false>(x, we, wd, be, bd, gate, wpt, y, n,
                                         h, w, cin, e, cout, pre_act,
                                         identity, s);
  if (k == 5)
    return pmma ? project_k<T, 5, sizeof(T) == 2>(x, we, wd, be, bd, gate,
                                                  wpt, y, n, h, w, cin, e,
                                                  cout, pre_act, identity, s)
                : project_k<T, 5, false>(x, we, wd, be, bd, gate, wpt, y, n,
                                         h, w, cin, e, cout, pre_act,
                                         identity, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace f2p
}  // namespace ast_kernels

// Pass 1: sums (n, e) of the unrounded hidden; sums must be zeroed by the
// caller.  we == nullptr is the expand==1 form (e == cin).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_sums_launch(const void* x, const void* we, const void* wd,
                                 const void* be, const void* bd, void* sums,
                                 int n, int h, int w, int cin, int e, int k,
                                 int pre_act, int is_bf16, void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)edw::dispatch<__nv_bfloat16, edw::kSums>(
        x, we, wd, be, bd, nullptr, sums, n, h, w, cin, e, k, pre_act, s);
  return (int)edw::dispatch<float, edw::kSums>(
      x, we, wd, be, bd, nullptr, sums, n, h, w, cin, e, k, pre_act, s);
}

// Pass 2: y (n, h, w, cout), allocated by the caller, from x (n, h, w, cin),
// the f32 SE gate (n, e) and the projection transposed, wpt (cout, e), with
// cout <= 96; identity adds x (cin == cout).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_project_launch(const void* x, const void* we,
                                    const void* wd, const void* be,
                                    const void* bd, const void* gate,
                                    const void* wpt, void* y, int n, int h,
                                    int w, int cin, int e, int cout, int k,
                                    int pre_act, int identity, int is_bf16,
                                    void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)f2p::project<__nv_bfloat16>(x, we, wd, be, bd, gate, wpt, y,
                                            n, h, w, cin, e, cout, k, pre_act,
                                            identity, s);
  return (int)f2p::project<float>(x, we, wd, be, bd, gate, wpt, y, n, h, w,
                                  cin, e, cout, k, pre_act, identity, s);
}
