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
// directly and no plane is built.
//
// What bounds sweep 1 on an H100: one read of x and one write of the
// output-resolution hidden (e2: 134 + 201 MB, 0.100 ms at 3.35 TB/s) against
// the expand at input resolution on the tensor cores and k*k f32 FMAs per
// output hidden value: bytes at both path shapes.  So the design keeps the
// x halo's loads, the expand and the hidden's stores out of each other's
// way, as expand_dw.cuh does for the stride-1 sweep:
//   * Persistent CTAs of 256 threads, grid (as many as fit at once, E / 32):
//     a CTA keeps one 32-channel chunk of E (its expand weights staged once,
//     its depthwise weights in registers) and walks (image, 8 x 16 output
//     tile; f32: 4 x 16) items.  The SE sums go by tile to a row of
//     partials (each thread's outputs row by row, the 8 warps' as a tree)
//     that edw::tile_sums_kernel adds per image in a fixed order: no
//     atomics, the same bits on every run (expand_dw.cuh has the order).
//   * The tile's input halo, (2*8 - 1 + 2p) x (2*16 - 1 + 2p) pixels (17 x
//     33 at k3, 19 x 35 at k5), is one TMA box of NHWC x ([pixel][C_in16 +
//     8]: conflict-free ldmatrix rows), issued by one thread for the next
//     tile while this tile's depthwise runs; the box is zero outside the
//     image and the reflected edge rows and columns are copied in shared
//     memory (edw::reflect_box), so the reflection stays an index map.  An
//     8 x 16 tile, not 16 x 16: the 16 x 16 tile's 35^2-pixel box and its
//     expanded halo (98 + 78 KB at k5) would leave one CTA per SM; this
//     one's (54 + 43 KB) leave two, for 1.30x the outputs' input pixels at
//     k5 (1.20x at 16 x 16).
//   * Expand: mma.sync m16n8k16 (bf16 in, f32 accumulate) on 16-pixel
//     tiles of the box, A and B fragments by ldmatrix (edw::mma_tile); the
//     bias, hswish and the rounding to bf16 (the flat rounding), written as
//     bf16 pairs into the expanded halo [pixel][32], whose 4-byte words are
//     XOR-swizzled by 4 * ((pixel / 2) % 4): the stores are conflict-free and
//     the depthwise's reads (lane = channel) stay so.
//   * Stride-2 depthwise: each thread owns one channel (lane) and a 4 x 4
//     block of output pixels (8 warps cover 8 x 16), 16 accumulators; each
//     of the (6 + k)^2 halo values it reads feeds up to ceil(k / 2)^2 of
//     them (k5: 400 FMAs per 121 reads), each output summing its k*k taps
//     in row-major order, one fmaf each (tests/test_torch_sweeps_s2.py
//     holds that order against the TPU kernel).  Blocks start at halo
//     pixels that are multiples of 8, so the swizzle of every read is a
//     compile-time constant.
//   * The hidden is staged [pixel][32] in the expanded halo's space and
//     written with 16-byte stores.
//   * A box the sweep cannot stage whole (wider than a TMA box may be, or
//     past the shared memory: C_in above 144 at k3, 112 at k5; none in the
//     model) comes in chunks of 32 channels, the expand's partial sums kept
//     in f32 in shared memory (prt) as expand_dw.cuh's kCSplit does; one
//     CTA per SM.
//   * f32 (C_in % 8 == 0, an aligned x: e2 and e4, the stylize CLI's
//     dtype): the same walk with an f32 box ([pixel][bch + 4] words,
//     edw::make_x_map's f32 map, reflected by edw::reflect_box on f32) and
//     the 3xTF32 expand of every f32 block of the model
//     (edw::expand_mtile_tf32: x split into TF32 hi + lo as its fragments
//     load, the weights split once per CTA, lo hi + hi lo + hi hi on
//     mma.sync m16n8k8, partials of TF_PAIR k8 steps added in f32 to
//     nearest), into an f32 expanded halo swizzled as expand_dw.cuh's
//     (edw::swz: channel c of pixel p at c ^ 8 (p % 4), the expand's float2
//     stores and the depthwise's reads conflict-free); the flat rounding is
//     a no-op at f32.  Its tile is 4 x 16 (OH_TF; each thread's depthwise
//     block 2 x 4): the 8 x 16 tile's f32 halo alone takes 71,808 B at k3
//     and 85,120 B at k5, and with the whole f32 box (46,080 B at e2,
//     75,264 B at e4) and the split weights (256 (C_in + 4) B) 124,296 B
//     and 168,840 B, one CTA per SM (two need at most 115,712 B each; e2
//     reached two with the box in two chunks of 8, 105,864 B, e4 at no
//     chunk).  The 4 x 16 tile takes 68,744 B at e2 and 102,536 B at e4
//     with the whole box: two CTAs at both.  A box that does not fit comes
//     in channel chunks sized by expand_dw.cuh's rule (s2_tf32_chunk), the
//     chunks' products kept as f32 partial sums in the halo itself.
//   * C_in % 8 != 0 or an unaligned x (off the path): the same walk with
//     the x halo read synchronously (reflect-indexed loads) and expanded on
//     the CUDA cores in passes of 128 pixels, the halo kept in the I/O
//     dtype.
// Sweep 2 is gate_project.cuh without residual.

#include "common.cuh"
#include "expand_dw.cuh"
#include "gate_project.cuh"

namespace ast_kernels {
namespace s2 {
namespace {

using edw::CE;
using edw::NTHREADS;
using edw::NWARPS;
constexpr int CK = 32;                        // input channels per step (CC)
constexpr int NPW = 16;                       // pixels per warp and pass (CC)
constexpr int PASS_CC = NWARPS * NPW;
constexpr int OW = 16;                        // output tile columns
constexpr int CCH2 = 32;                      // channels per split box
constexpr int BC = 4;                         // a thread's depthwise columns
// The f32 3xTF32 design's (TF) output tile rows: 4, not the others' 8.
// At 8 its f32 halo and box leave two CTAs per SM at e2 only with the box
// in two chunks, and one at e4; at 4 two share an SM with the whole box,
// for 1.06x (e2) and 1.16x (e4) the expand's pixels: 9.6% and 2.6% less
// time per launch on an H100 (scripts/sweep_ablation.py --f32, the cut
// s2_tile_8x16).  The k5 instance spills 12 B at the 128 registers two
// CTAs allow.
constexpr int OH_TF = 4;

// The tile of a sweep (TF: the f32 3xTF32 design): OH x 16 outputs, each
// thread's depthwise block BR x 4.
template <int K, bool TF = false>
struct Geo {
  static constexpr int OH = TF ? OH_TF : 8;       // output tile rows
  static constexpr int BR = OH / 2;               // a thread's block rows
  static_assert((OH / BR) * (OW / BC) == NWARPS, "the warps cover the tile");
  static constexpr int P = (K - 1) / 2;
  static constexpr int HSH = 2 * OH - 1 + 2 * P;  // input halo rows
  static constexpr int HSW = 2 * OW - 1 + 2 * P;  // and columns
  static constexpr int HP = HSH * HSW;
  static constexpr int MT = (HP + 15) / 16;       // 16-row MMA tiles
  // Depthwise blocks start at halo pixels 2 * BR * HSW * i + 2 * BC * j,
  // multiples of the swizzle's period (ex_at): 8 pixels, 4 at f32.
  static_assert((2 * BR) % (TF ? 4 : 8) == 0 && (2 * BC) % 8 == 0,
                "swizzle");
};

__host__ __device__ constexpr int up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Byte offsets of the shared memory from a 128-byte aligned base:
//   exs  T [HP][32]: the expanded halo (swizzled, see ex_at), then the
//        tile's hidden [OH * OW][32] before its stores;
//   xs   MMA: bf16 [MT * 16][ldxs], the x box; TF: f32 [MT * 16][ldxs];
//        else the CUDA-core expand's f32 staging [PASS_CC][CK] and
//        weights [CK][32];
//   ws   MMA: bf16 [32][ldx], the chunk's expand weights; TF: their TF32
//        hi then lo parts, f32 [32][ldx] each;
//   prt  SPLIT: f32 [HP][32] (edw::swz), the expand's partial sums;
//   red  f32 [NWARPS][32]; bes f32 [32]; bar the box's mbarrier.
// SPLIT (the whole box cannot be one, s2_split): xs holds one chunk of
// CCH2 channels of the box ([pixel][ldxs = CCH2 + 8]) and cin16 is padded
// to whole chunks, the weights' K zero past C_in; otherwise ldxs = ldx and
// bch = cin16.  TF (f32, the 3xTF32 expand): xs holds one chunk of `tbch`
// channels (s2_tf32_chunk), ldxs = bch + 4 words, cin16 = C_in padded to
// 8 (k8 steps), ldx = cin16 + 4; the chunks' partial sums go to exs.
template <typename T, int K, bool MMA, bool SPLIT = false, bool TF = false>
struct Smem {
  int cin16, bch, ldx, ldxs, xs, ws, prt, red, bes, bar, total;
  __host__ __device__ explicit Smem(int cin, int tbch = 0) {
    using G = Geo<K, TF>;
    if (TF) {
      cin16 = up(cin, 8);
      bch = tbch;
      ldx = cin16 + 4;
      ldxs = bch + 4;
      xs = up(G::HP * CE * 4, 128);
      ws = xs + G::MT * 16 * ldxs * 4;
      prt = ws + 2 * CE * ldx * 4;
      red = prt;
      bes = red + NWARPS * 32 * 4;
      bar = bes + CE * 4;
      total = bar + 8 + 128;
      return;
    }
    cin16 = SPLIT ? up(cin, CCH2) : up(cin, 16);
    bch = SPLIT ? CCH2 : cin16;
    ldx = cin16 + 8;
    ldxs = bch + 8;
    xs = up(G::HP * CE * (int)sizeof(T), 128);
    ws = xs + (MMA ? G::MT * 16 * ldxs * 2 : (PASS_CC * CK + CK * CE) * 4);
    prt = ws + (MMA ? up(CE * ldx * 2, 16) : 0);
    red = prt + (SPLIT ? G::HP * CE * 4 : 0);
    bes = red + NWARPS * 32 * 4;
    bar = bes + CE * 4;
    total = bar + 8 + 128;
  }
};

// Element index of channel c of halo pixel p in exs.  bf16: channel pairs
// are 4-byte words, word c / 2 of pixel p at (c / 2) ^ (4 * ((p / 2) % 4)),
// so the expand's bf16-pair stores (pixels g and g + 8 of a tile, channel
// pairs tig) land in 32 distinct banks.  f32: expand_dw.cuh's swizzle,
// channel c at c ^ edw::swz(p), which the 3xTF32 expand's store_mtile
// writes.
template <typename T>
__device__ __forceinline__ int ex_at(int p, int c) {
  if constexpr (sizeof(T) == 2)
    return ((p * 16 + ((c >> 1) ^ (((p >> 1) & 3) << 2))) << 1) | (c & 1);
  return p * CE + (c ^ edw::swz(p));
}

// The slot of halo pixel p0 + d's swizzle in depthwise_s2's lw, p0 a
// multiple of the swizzle's period: bf16 swizzles by (p / 2) % 4, f32 by
// p % 4.
template <typename T>
__host__ __device__ constexpr int swz_slot(int d) {
  return sizeof(T) == 2 ? (d >> 1) & 3 : d & 3;
}

// The expanded halo of output tile (oy0, ox0) into exs, rounded to T.
// MMA: from the x box in xs (waited for and reflected); TF: the same from
// the f32 box, as 3xTF32; otherwise from x, reflect-indexed, on the CUDA
// cores.  Starts and ends with a barrier.  PASS (SPLIT and TF's chunks,
// edw::store_pass's passes): xs holds the weights' K columns [kofs, kofs
// + bch); 1 stores the products as partial sums (SPLIT: in prt; TF: in
// exs), 3 adds them, 2 adds them and runs the epilogue.
template <typename T, int K, bool MMA, bool SPLIT, bool TF, int PASS = 0>
__device__ __forceinline__ void expand_tile(const T* __restrict__ xn,
                                            const T* __restrict__ we,
                                            char* smem,
                                            const Smem<T, K, MMA, SPLIT,
                                                       TF>& L,
                                            int H, int W, int cin, int E,
                                            int c0, int iy0, int ix0,
                                            int kofs = 0) {
  using G = Geo<K, TF>;
  constexpr int HP = G::HP, HSW = G::HSW;
  T* exs = reinterpret_cast<T*>(smem);
  const float* bes = reinterpret_cast<const float*>(smem + L.bes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the box is reflected; exs's readers are done
  if constexpr (MMA) {
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.xs);
    const __nv_bfloat16* wsT =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.ws);
    __nv_bfloat16* exb = reinterpret_cast<__nv_bfloat16*>(smem);
    [[maybe_unused]] float* prt = reinterpret_cast<float*>(smem + L.prt);
    auto tile = [&](auto ntn, int mt, int nt0) {
      constexpr int NTN = decltype(ntn)::value;
      const __nv_bfloat16* ap =
          xs + (mt * 16 + (lane & 15)) * L.ldxs + (lane >> 4) * 8;
      edw::mma_tile<NTN>(
          wsT + kofs, L.ldx, L.bch, nt0,
          [&](uint32_t(&a)[4], int ks) { ldmatrix_x4(a, ap + ks); },
          [&](int r, int col, float v0, float v1) {
            const int p = mt * 16 + r;
            if (p >= HP) return;
            if constexpr (PASS != 0) {
              float2* part = reinterpret_cast<float2*>(
                  &prt[p * CE + (col ^ edw::swz(p))]);
              if constexpr (PASS != 1) {
                const float2 a = *part;
                v0 += a.x;
                v1 += a.y;
              }
              if constexpr (PASS != 2) {
                *part = make_float2(v0, v1);
                return;
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(&exb[ex_at<T>(p, col)]) =
                __floats2bfloat162_rn(hswish(v0 + bes[col]),
                                      hswish(v1 + bes[col + 1]));
          });
    };
    constexpr int ROUNDS = G::MT / NWARPS;
    constexpr int LEFT = (G::MT - ROUNDS * NWARPS) * (CE / 8);
    for (int i = 0; i < ROUNDS; ++i)
      tile(std::integral_constant<int, CE / 8>{}, warp + i * NWARPS, 0);
    for (int u = warp; u < LEFT; u += NWARPS)
      tile(std::integral_constant<int, 1>{}, ROUNDS * NWARPS + u / (CE / 8),
           u % (CE / 8));
  } else if constexpr (TF) {
    // As the bf16 expand divides its tiles among the warps; the chunk's K
    // columns [kofs, kofs + kext).
    const float* xs = reinterpret_cast<const float*>(smem + L.xs);
    const uint32_t* wh = reinterpret_cast<const uint32_t*>(smem + L.ws);
    const uint32_t* wl = wh + CE * L.ldx;
    float* exf = reinterpret_cast<float*>(smem);
    const int kext = min(L.bch, L.cin16 - kofs);
    auto tile = [&](auto ntn, int mt, int nt0) {
      constexpr int NTN = decltype(ntn)::value;
      edw::expand_mtile_tf32<float, NTN, false, PASS>(
          xs, L.ldxs, wh + kofs, wl + kofs, bes, exf, L.ldx, kext, mt, nt0,
          1, HP);
    };
    constexpr int ROUNDS = G::MT / NWARPS;
    constexpr int LEFT = (G::MT - ROUNDS * NWARPS) * (CE / 8);
    for (int i = 0; i < ROUNDS; ++i)
      tile(std::integral_constant<int, CE / 8>{}, warp + i * NWARPS, 0);
    for (int u = warp; u < LEFT; u += NWARPS)
      tile(std::integral_constant<int, 1>{}, ROUNDS * NWARPS + u / (CE / 8),
           u % (CE / 8));
  } else {
    float* xsf = reinterpret_cast<float*>(smem + L.xs);  // [PASS_CC][CK]
    float* wsf = xsf + PASS_CC * CK;                     // [CK][CE]
    for (int pb = 0; pb < HP; pb += PASS_CC) {
      float acc[NPW];
#pragma unroll
      for (int i = 0; i < NPW; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < cin; k0 += CK) {
        const int kc = min(CK, cin - k0);
        if (pb > 0 || k0 > 0) __syncthreads();  // the last step's readers
        for (int idx = threadIdx.x; idx < PASS_CC * CK; idx += NTHREADS) {
          const int p = idx / CK, ci = idx % CK;
          const int hp = pb + p;
          float v = 0.f;
          if (hp < HP && ci < kc) {
            const int gy = reflect_idx(iy0 + hp / HSW, H);
            const int gx = reflect_idx(ix0 + hp % HSW, W);
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
        if (hp < HP)
          exs[ex_at<T>(hp, lane)] = from_f32<T>(hswish(acc[i] + bes[lane]));
      }
    }
  }
  __syncthreads();
}

// The stride-2 depthwise of the lane's channel over the expanded halo:
// o[r][j] = hswish(dw + bd) in f32 at output row BR * (warp / 4) + r,
// column 4 * (warp % 4) + j of the tile.  Output (oy, ox) tap (di, dj)
// reads halo (2 oy + di, 2 ox + dj); each output sums its k*k taps in
// row-major order (row di, then column dj), one fmaf each.  Only reads
// exs.
template <typename T, int K, bool TF>
__device__ __forceinline__ void depthwise_s2(
    const T* exs, const float (&wk)[K * K], float bdv,
    float (&o)[Geo<K, TF>::BR][BC]) {
  using G = Geo<K, TF>;
  constexpr int BR = G::BR, HSW = G::HSW;
  constexpr int ROWS = 2 * (BR - 1) + K, COLS = 2 * (BC - 1) + K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 =
      2 * BR * (warp / (OW / BC)) * HSW + 2 * BC * (warp % (OW / BC));
  // p0 is a multiple of the swizzle's period, so ex_at(p0 + d, lane) =
  // (p0 + d) * 32 + lw[swz_slot<T>(d)] with the lane's four swizzled
  // offsets lw.
  const T* base = exs + p0 * CE;
  constexpr int QS = sizeof(T) == 2 ? 2 : 1;  // pixels per slot step
  int lw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) lw[q] = ex_at<T>(QS * q, lane) - QS * q * CE;
#pragma unroll
  for (int r = 0; r < BR; ++r)
#pragma unroll
    for (int j = 0; j < BC; ++j) o[r][j] = 0.f;
#pragma unroll
  for (int hr = 0; hr < ROWS; ++hr) {
#pragma unroll
    for (int hc = 0; hc < COLS; ++hc) {
      const int d = hr * HSW + hc;  // relative to the block's first pixel
      const float v = to_f32(base[d * CE + lw[swz_slot<T>(d)]]);
#pragma unroll
      for (int j = 0; j < BC; ++j) {
        const int dj = hc - 2 * j;
        if (dj < 0 || dj >= K) continue;
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const int di = hr - 2 * r;
          if (di >= 0 && di < K) o[r][j] = fmaf(v, wk[di * K + dj], o[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BR; ++r)
#pragma unroll
    for (int j = 0; j < BC; ++j) o[r][j] = hswish(o[r][j] + bdv);
}

// xmap: x as edw::make_x_map's map with this tile's box (MMA and TF only;
// SPLIT and TF's chunks: boxes of one chunk of channels, the first
// prefetched, the others loaded after the previous chunk's products).
// tbch: TF's channels per box (s2_tf32_chunk); unused otherwise.
template <typename T, int K, bool MMA, bool SPLIT = false, bool TF = false>
__global__ void __launch_bounds__(NTHREADS, MMA || TF ? 2 : 1)
    s2_expand_dw_kernel(const __grid_constant__ CUtensorMap xmap,
                        const T* __restrict__ x, const T* __restrict__ we,
                        const float* __restrict__ wd,
                        const float* __restrict__ be,
                        const float* __restrict__ bd, T* __restrict__ hidden,
                        float* __restrict__ part, int N, int H, int W,
                        int cin, int E, int tiles_x, int tiles_per_image,
                        int tbch) {
  using G = Geo<K, TF>;
  constexpr int P = G::P, OH = G::OH, VEC = 16 / (int)sizeof(T);
  constexpr bool BOX = MMA || TF;  // x comes as TMA boxes
  char* smem = edw::smem_base();
  const Smem<T, K, MMA, SPLIT, TF> L(cin, tbch);
  T* exs = reinterpret_cast<T*>(smem);
  T* hs = exs;  // the tile's hidden, [OH * OW][32]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  [[maybe_unused]] float* xs32 = reinterpret_cast<float*>(smem + L.xs);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * CE, c = c0 + lane;
  const bool c_ok = c < E;
  const int Ho = H / 2, Wo = W / 2;
  const int total = N * tiles_per_image;
  int item = blockIdx.x;
  if (item >= total) return;

  if constexpr (MMA) {
    // The chunk's expand weights, lanes on consecutive output channels.
    __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
    for (int idx = threadIdx.x; idx < CE * L.cin16; idx += NTHREADS) {
      const int cc = idx % CE, ci = idx / CE;
      T v = from_f32<T>(0.f);
      if (ci < cin && c0 + cc < E) v = we[(size_t)ci * E + c0 + cc];
      wsT[cc * L.ldx + ci] = v;
    }
  } else if constexpr (TF) {
    edw::stage_weights_tf32(we, reinterpret_cast<uint32_t*>(smem + L.ws),
                            L.ldx, L.cin16, cin, E, c0);
  }
  float* bes = reinterpret_cast<float*>(smem + L.bes);
  if (threadIdx.x < CE)
    bes[threadIdx.x] =
        (be != nullptr && c0 + (int)threadIdx.x < E) ? be[c0 + threadIdx.x]
                                                     : 0.f;
  float wk[K * K], bdv;
  edw::load_dw<K>(wd, bd, E, c, wk, bdv);
  auto origin = [&](int it, int& n, int& oy0, int& ox0) {
    n = it / tiles_per_image;
    const int t = it % tiles_per_image;
    oy0 = (t / tiles_x) * OH;
    ox0 = (t % tiles_x) * OW;
  };
  // One thread issues the box of the input halo of item it (channels from
  // ch0).
  auto issue = [&](int it, int ch0) {
    int n, oy0, ox0;
    origin(it, n, oy0, ox0);
    fence_proxy_async();  // this thread's earlier accesses of xs come first
    mbar_expect_tx(xbar, G::HP * L.ldxs * (int)(TF ? 4 : 2));
    tma_load_4d(xs, &xmap, ch0, 2 * ox0 - P, 2 * oy0 - P, n, xbar);
  };
  // The box's edges outside the image, copied from inside it.
  auto reflect = [&](int iy0, int ix0) {
    if constexpr (TF)
      edw::reflect_box<P, G::HSH, G::HSW, 0, float>(xs32, L.ldxs, H, W, iy0,
                                                    ix0);
    else
      edw::reflect_box<P, G::HSH, G::HSW>(xs, L.ldxs, H, W, iy0, ix0);
  };
  uint32_t xphase = 0;
  if constexpr (BOX) {
    if (threadIdx.x == 0) {
      mbar_init(xbar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) issue(item, 0);
  }
  const bool vec_out = E % VEC == 0 &&
                       (reinterpret_cast<uintptr_t>(hidden) & 15) == 0;
  const int by0 = G::BR * (warp / (OW / BC));
  const int bx0 = BC * (warp % (OW / BC));

  for (; item < total; item += gridDim.x) {
    int n, oy0, ox0;
    origin(item, n, oy0, ox0);
    const int iy0 = 2 * oy0 - P, ix0 = 2 * ox0 - P;
    const T* xn = x + (size_t)n * H * W * cin;
    if constexpr (BOX) {
      mbar_wait(xbar, xphase);
      xphase ^= 1;
      reflect(iy0, ix0);
    }
    if constexpr (SPLIT || TF) {
      if (!SPLIT && L.bch >= L.cin16) {  // TF: the whole box
        expand_tile<T, K, MMA, SPLIT, TF>(xn, we, smem, L, H, W, cin, E, c0,
                                          iy0, ix0);
      } else {
        // Chunk 0's partial sums, then each further chunk's box (xs is
        // free after the last expand's barrier), its products added; the
        // last one's epilogue.
        expand_tile<T, K, MMA, SPLIT, TF, 1>(xn, we, smem, L, H, W, cin, E,
                                             c0, iy0, ix0, 0);
        for (int ch0 = L.bch; ch0 < L.cin16; ch0 += L.bch) {
          if (threadIdx.x == 0) issue(item, ch0);
          mbar_wait(xbar, xphase);
          xphase ^= 1;
          reflect(iy0, ix0);
          if (ch0 + L.bch < L.cin16)
            expand_tile<T, K, MMA, SPLIT, TF, 3>(xn, we, smem, L, H, W, cin,
                                                 E, c0, iy0, ix0, ch0);
          else
            expand_tile<T, K, MMA, SPLIT, TF, 2>(xn, we, smem, L, H, W, cin,
                                                 E, c0, iy0, ix0, ch0);
        }
      }
    } else {
      expand_tile<T, K, MMA, SPLIT, TF>(xn, we, smem, L, H, W, cin, E, c0,
                                        iy0, ix0);
    }
    if constexpr (BOX) {
      // The next tile's box comes in while this one's depthwise runs.
      if (threadIdx.x == 0 && item + (int)gridDim.x < total)
        issue(item + gridDim.x, 0);
    }
    float o[G::BR][BC];
    depthwise_s2<T, K, TF>(exs, wk, bdv, o);
    __syncthreads();  // every read of the expanded halo is done
    float tsum = 0.f;  // this thread's outputs, row by row
#pragma unroll
    for (int r = 0; r < G::BR; ++r)
#pragma unroll
      for (int j = 0; j < BC; ++j) {
        const T hv = from_f32<T>(o[r][j]);
        if (c_ok && oy0 + by0 + r < Ho && ox0 + bx0 + j < Wo)
          tsum += to_f32(hv);
        hs[((by0 + r) * OW + bx0 + j) * CE + lane] = hv;
      }
    // red is free: warp 0 read the last tile's before the barrier above.
    red[threadIdx.x] = tsum;
    __syncthreads();
    edw::store_tile_sums(red, part, item, E, c);
    // 16-byte stores: a pixel's 32 channels are CE / VEC vectors.
    constexpr int VPP = CE / VEC;
    for (int idx = threadIdx.x; idx < OH * OW * VPP; idx += NTHREADS) {
      const int p = idx / VPP, cc = (idx % VPP) * VEC;
      const int gy = oy0 + p / OW, gx = ox0 + p % OW;
      if (gy >= Ho || gx >= Wo || c0 + cc >= E) continue;
      T* dst = hidden + (((size_t)n * Ho + gy) * Wo + gx) * E + c0 + cc;
      const T* src = hs + p * CE + cc;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < VEC && c0 + cc + j < E; ++j) dst[j] = src[j];
      }
    }
  }
}

// tbch: TF's channels per box (s2_tf32_chunk); unused otherwise.
template <typename T, int K, bool MMA, bool SPLIT = false, bool TF = false>
cudaError_t launch(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, void* hidden,
                   const edw::SumsOut& sums, int n, int h, int w, int cin,
                   int e, cudaStream_t stream, int tbch = 0) {
  using G = Geo<K, TF>;
  const Smem<T, K, MMA, SPLIT, TF> L(cin, tbch);
  auto kernel = s2_expand_dw_kernel<T, K, MMA, SPLIT, TF>;
  CUtensorMap xmap{};
  if ((MMA || TF) && !edw::make_x_map(&xmap, x, n, h, w, cin, G::HSW,
                                      G::HSH, L.ldxs, TF))
    return cudaErrorInvalidValue;
  if (L.total > edw::max_smem()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        NTHREADS, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (w / 2 + OW - 1) / OW;
  const int tiles_per_image = tiles_x * ((h / 2 + G::OH - 1) / G::OH);
  if (tiles_per_image > sums.tiles) return cudaErrorInvalidValue;
  const int chunks = (e + CE - 1) / CE;
  const long long items = (long long)n * tiles_per_image;
  // Never more CTAs than fit at once (edw::launch says why).
  const int gx = (int)std::min<long long>(
      items, std::max(1, per_sm * sms / chunks));
  kernel<<<dim3(gx, chunks), NTHREADS, L.total, stream>>>(
      xmap, static_cast<const T*>(x), static_cast<const T*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<T*>(hidden),
      static_cast<float*>(sums.part), n, h, w, cin, e, tiles_x,
      tiles_per_image, tbch);
  edw::last_async() = MMA || TF ? 1 : 0;
  edw::last_boxes() = (L.cin16 + L.bch - 1) / L.bch;
  edw::last_design() = TF ? 2 : MMA ? 1 : 0;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return edw::launch_tile_sums(sums, n, tiles_per_image, e, stream);
}

// Whether the bf16 sweep stages x's box in chunks of CCH2 channels: where
// the whole box would be wider than a TMA box may be, or the kernel with it
// would need more shared memory than a CTA may have (C_in above 144 at k3,
// 112 at k5; the model's stride-2 blocks have 16-40).
// ops/kernels/limits.py mirrors this rule and the Smem arithmetic.
template <int K>
bool s2_split(int cin) {
  const Smem<__nv_bfloat16, K, true> whole(cin);
  return edw::box_split(whole.ldx, whole.total);
}

// The f32 sweep's channels per x box at this k and C_in: expand_dw.cuh's
// rule (edw::tf32_sized) on this sweep's layout, the box's inner extent
// bch + 4.  e2 (k3 C_in 16) and e4 (k5 C_in 24): the whole box, two CTAs
// per SM.  ops/kernels/limits.py mirrors the rule.
template <int K>
int s2_tf32_chunk(int cin) {
  return edw::tf32_sized(cin, [&](int b, int& dim) {
    dim = b + 4;
    return Smem<float, K, false, false, true>(cin, b).total;
  });
}

template <typename T, int K>
cudaError_t dispatch_k(const void* x, const void* we, const void* wd,
                       const void* be, const void* bd, void* hidden,
                       const edw::SumsOut& sums, int n, int h, int w, int cin,
                       int e, cudaStream_t s) {
  // f32: the 3xTF32 expand from f32 boxes (C_in % 8 == 0, an aligned x,
  // a chunk that fits).
  if constexpr (sizeof(T) == 4) {
    const int b =
        edw::use_tf32<T, edw::kFlat>(x, cin, w) ? s2_tf32_chunk<K>(cin) : 0;
    if (b > 0)
      return launch<T, K, false, false, true>(x, we, wd, be, bd, hidden,
                                              sums, n, h, w, cin, e, s, b);
  }
  // The tensor-core expand with the TMA box: bf16, C_in % 8 == 0 (16-byte
  // box rows), an aligned x.
  if constexpr (sizeof(T) == 2) {
    if (edw::use_mma<T, edw::kFlat>(x, cin) && s2_split<K>(cin))
      return launch<T, K, true, true>(x, we, wd, be, bd, hidden, sums, n, h,
                                      w, cin, e, s);
  }
  if (edw::use_mma<T, edw::kFlat>(x, cin))
    return launch<T, K, sizeof(T) == 2>(x, we, wd, be, bd, hidden, sums, n,
                                        h, w, cin, e, s);
  return launch<T, K, false>(x, we, wd, be, bd, hidden, sums, n, h, w, cin,
                             e, s);
}

// Registers, dynamic shared memory and CTAs per SM of the bf16 sweep-1
// kernel (the tensor-core expand) at this k and C_in, into out[0..2].
cudaError_t occupancy(int k, int cin, int* out) {
  using B = __nv_bfloat16;
  if (k == 3)
    return s2_split<3>(cin)
               ? edw::query(s2_expand_dw_kernel<B, 3, true, true>, NTHREADS,
                            Smem<B, 3, true, true>(cin).total, out)
               : edw::query(s2_expand_dw_kernel<B, 3, true>, NTHREADS,
                            Smem<B, 3, true>(cin).total, out);
  if (k == 5)
    return s2_split<5>(cin)
               ? edw::query(s2_expand_dw_kernel<B, 5, true, true>, NTHREADS,
                            Smem<B, 5, true, true>(cin).total, out)
               : edw::query(s2_expand_dw_kernel<B, 5, true>, NTHREADS,
                            Smem<B, 5, true>(cin).total, out);
  return cudaErrorInvalidValue;
}

// Registers, dynamic shared memory and CTAs per SM of the f32 sweep-1
// kernel (the 3xTF32 expand) at this k and C_in, its x boxes per halo and
// channels per box, into out[0..4]; cudaErrorInvalidValue where the design
// does not take the shape.
cudaError_t occupancy_tf32(int k, int cin, int* out) {
  const int b = cin % 8 != 0 ? 0
                : k == 3     ? s2_tf32_chunk<3>(cin)
                : k == 5     ? s2_tf32_chunk<5>(cin)
                             : 0;
  if (b == 0) return cudaErrorInvalidValue;
  out[3] = (up(cin, 8) + b - 1) / b;
  out[4] = b;
  if (k == 3)
    return edw::query(s2_expand_dw_kernel<float, 3, false, false, true>,
                      NTHREADS,
                      Smem<float, 3, false, false, true>(cin, b).total, out);
  return edw::query(s2_expand_dw_kernel<float, 5, false, false, true>,
                    NTHREADS, Smem<float, 5, false, false, true>(cin, b).total,
                    out);
}

template <typename T>
cudaError_t run(const void* x, const void* we, const void* wd, const void* be,
                const void* bd, const void* d0t, const void* d0b,
                const void* d1k, const void* d1b, const void* wpt,
                const void* pb, void* hidden, const edw::SumsOut& sums,
                void* gate, void* y, int n, int h, int w, int cin, int e,
                int s, int cout, int k, cudaStream_t st) {
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
  return gp::launch<T>(hidden, sums.sums, d0t, d0b, d1k, d1b, wpt, pb,
                       nullptr, gate, y, n, (h / 2) * (w / 2), e, s, cout,
                       st);
}

}  // namespace
}  // namespace s2
}  // namespace ast_kernels

// x (n, h, w, cin) with h, w even; hidden (n, h/2, w/2, e), sums (n, e),
// part (n, part_tiles, e; f32 scratch, expand_dw.cuh SumsOut), gate (n, e;
// f32 scratch) and y (n, h/2, w/2, cout) must be allocated by the caller,
// none zeroed.  The
// SE and projection operands are as in flat_block_launch.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flat_s2_launch(const void* x, const void* we, const void* wd,
                              const void* be, const void* bd, const void* d0t,
                              const void* d0b, const void* d1k,
                              const void* d1b, const void* wpt,
                              const void* pb, void* hidden, void* sums,
                              void* part, void* gate, void* y, int n, int h,
                              int w, int cin, int e, int s, int cout, int k,
                              int is_bf16, int part_tiles, void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  if (h % 2 != 0 || w % 2 != 0 || we == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const edw::SumsOut so{part, part_tiles, sums};
  if (is_bf16)
    return (int)s2::run<__nv_bfloat16>(x, we, wd, be, bd, d0t, d0b, d1k, d1b,
                                       wpt, pb, hidden, so, gate, y, n, h,
                                       w, cin, e, s, cout, k, st);
  return (int)s2::run<float>(x, we, wd, be, bd, d0t, d0b, d1k, d1b, wpt, pb,
                             hidden, so, gate, y, n, h, w, cin, e, s, cout,
                             k, st);
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of the
// two bf16 sweeps a block of this shape launches, sweep 1 into out[0..2]
// and sweep 2 into out[3..5], for measurement.  Launches nothing.
extern "C" int flat_s2_occupancy(int k, int cin, int e, int cout, int* out) {
  using namespace ast_kernels;
  cudaError_t err = s2::occupancy(k, cin, out);
  if (err != cudaSuccess) return (int)err;
  return (int)gp::occupancy(e, cout, false, out + 3);
}

// flat_s2_occupancy's sweep 1 for f32 x: the 3xTF32 kernel's registers,
// shared memory, CTAs per SM, x boxes per halo and channels per box into
// out[0..4].  Launches nothing.
extern "C" int flat_s2_f32_occupancy(int k, int cin, int* out) {
  return (int)ast_kernels::s2::occupancy_tf32(k, cin, out);
}

// The sweep-1 design of the last flat_s2_launch: 0 the CUDA-core expand, 1
// the bf16 tensor-core expand, 2 the f32 3xTF32 one; -1 before any launch.
extern "C" int flat_s2_block_last_sweep1() {
  return ast_kernels::edw::last_design();
}

// How the last flat_s2_launch staged x in sweep 1: 1 as TMA boxes
// (asynchronous), 0 with plain loads, -1 before any launch.
extern "C" int flat_s2_block_last_staging() {
  return ast_kernels::edw::last_async();
}

// The x boxes per halo of the last flat_s2_launch's sweep 1: 1 the whole box
// (or plain loads), more its channel chunks; -1 before any launch.
extern "C" int flat_s2_block_last_boxes() {
  return ast_kernels::edw::last_boxes();
}

// The design of the last flat_s2_launch's sweep 2: 0 gate_project_generic,
// 1 gate_project_mma (bf16), 2 gate_project_tf32 (f32); -1 before any.
extern "C" int flat_s2_block_last_sweep2() {
  return ast_kernels::gp::last_design();
}
