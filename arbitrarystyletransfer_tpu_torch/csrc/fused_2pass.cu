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
// read) for a second expand + depthwise, and is bound by that arithmetic
// (the f32 depthwise, k*k FMAs per hidden value, at the 67 TFLOP/s f32 peak)
// and its shared-memory traffic, as expand_dw is.  "project" adds the
// projection, C_out bf16 MACs per hidden value on the tensor cores.
//
// "sums": expand_dw.cuh's persistent sweep 1 with kSums, the sums of the
// unrounded hidden by atomics, no hidden stored.
//
// "project", the path's design (bf16 x with the tensor-core expand, C_out a
// multiple of 8 up to 96; `fused_project_ws`).  The first design (the tile design
// below: one CTA per tile, every stage in series between CTA barriers, one
// CTA per SM, each tile restaging every weight) took 2.2x the sums pass
// for the same expand and depthwise.  So:
//   * Persistent CTAs, one wave (one CTA of 512 threads per SM), walking
//     (image, 16x16 tile) items.  The next item's x halo is one TMA box on
//     an mbarrier, issued once the current item's last expand has read the
//     halo, so it lands while the last chunk's depthwise runs.
//   * Two warp groups.  Warps 0-7 (producers) run sweep 1's expand (mma.sync
//     into the swizzled f32 halo) and depthwise (8 x 4 outputs per thread,
//     one channel per lane) for each 32-channel chunk of E, exactly as
//     expand_dw.cuh's kFused mode, their CTA barriers named (bar.sync 1,
//     256) so the other group never waits on them; the lane's depthwise
//     weights and gate are loaded before the expand, so their latency
//     passes under it.  Each thread then gates and rounds its 32 hidden
//     values two pixels at a time (one bf16x2 fma: the product of two bf16
//     values is exact in f32) into one of two shared-memory slots ([256
//     pixels][40]: the A fragments' conflict-free rows) and its warp
//     arrives on the slot's `full` mbarrier.  Warps 8-15 (consumers) take
//     each chunk's rows of W_p ((E, C_out) as it lies in HBM: no host
//     transpose) as one bulk copy two chunks ahead, wait for `full`, run
//     mma.sync m16n8k16 on 32 pixels x all of C_out per warp (B fragments
//     by ldmatrix.trans), accumulating y in registers across the chunks
//     (96 f32 at C_out 96), arrive on `empty`, and store y (+ x) after the
//     last chunk while the producers already work on the next item.  So
//     the projection and the y stores run beside the depthwise, and each
//     group has its own 128 registers (the projection's accumulators no
//     longer sit beside the depthwise's).
//   * The expand weights and biases of all chunks are staged once per CTA
//     where they fit in shared memory beside sweep 1's buffers and the
//     slots (every path shape but d3 and d4, whose W_e is 55-74 KB; those
//     restage each chunk's from L2, as sweep 1's CTAs do once).
//   * Shared memory: sweep 1's (~101 KB at k5 C_in 40, ~142 KB at d4), the
//     two hidden slots (40,960 B), the two weight slots (<= 12,288 B) and
//     the resident W_e (<= 56 KB): <= 227 KB, one CTA per SM.
// What limits it (the ablation below, chip_smoke.project_sweep): the
// projection is hidden (cutting its products moves a shape by a few
// percent at most); the producers' one group of 8 warps per SM, expand and depthwise in
// turn between barriers, sets the pace, where sweep 1 runs two CTAs per SM
// and hides one's barriers under the other's work.  Two variants were
// slower on the H100: a second f32 halo (each warp's depthwise of chunk q
// beside its expand of q + 1, one barrier per chunk) and the expand on the
// consumer warps (into two halos, beside the producers' depthwise): both
// compete for the same issue slots.
// Other dtypes and layouts (f32, the expand==1 form, C_in or C_out that the
// persistent design cannot take, C_out above 96 up to 128, unaligned
// tensors: none on the path) take the tile design (`fused_project_tile`):
// one CTA per (image, 16x16 tile), looping over E in chunks of 32, the
// hidden chunk in shared memory, the projection by mma.sync (bf16, even
// C_out) or by one pixel per thread on the CUDA cores (f32, odd C_out),
// accumulated in registers across the chunks (12 or 16 8-wide output
// tiles: the CUDA-core path's 96 or 128 f32 per thread, written out 32
// outputs at a time through the hidden chunk's buffer; with them in shared
// memory, 99 KB at C_out 96, an odd C_out did not fit past C_in 48 at k3).
// Its x halo is staged once per tile, or, where the whole box cannot be
// one or leaves no room for the projection's buffers (C_in above 240 at
// k3, 192 at k5: expand_dw.cuh's c_split), in 64-channel chunks for each
// chunk of E, their products added in f32 (kCSplit).
//
// Both designs take cuts for the ablation (`fused_project_cut_launch`,
// timing only, results wrong): the projection's products, the depthwise's
// FMAs, and (the persistent design) the prefetch of the x halo and the
// resident expand weights, each item's halo then awaited before its first
// expand and each chunk's weights staged in turn.

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
using edw::max_smem;
using bf16 = __nv_bfloat16;

constexpr int TP = TH * TW;        // pixels per tile
constexpr int MAX_NT = 16;         // 8-wide output tiles: C_out <= 128
constexpr int MAX_COUT = MAX_NT * 8;
constexpr int WS_NT = 12;          // the persistent design's: C_out <= 96
constexpr int HS_LD = CE + 8;      // bf16 hidden row: 80 B, conflict-free frags
constexpr int HS_F32_LD = CE + 1;  // f32 hidden row (CUDA-core projection)
static_assert(TP == NTHREADS, "one pixel per thread in the f32 projection");
static_assert(TP == NWARPS * 2 * 16, "two 16-pixel MMA tiles per warp");

// Parts cut out for the ablation (timing only).
enum Cut { kNone = 0, kNoProj = 1, kNoDw = 2, kSyncStage = 3 };

// The depthwise of the kNoDw cut: each output is its own expanded value
// (one read of buf) plus the bias, so the stages around it keep their work.
template <int K>
__device__ __forceinline__ void depthwise_cut(const float* buf, float bdv,
                                              float (&o)[DW_ROWS][DW_COLS]) {
  constexpr int P = edw::Halo<K>::P, HW = edw::Halo<K>::HW;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j) {
      const int p = (edw::dw_row0() + P + r) * HW + edw::dw_col0() + P + j;
      o[r][j] = buf[p * CE + (lane ^ edw::swz(p))] + bdv;
    }
}

// The projection of one warp's 32 pixels (rows 32 w .. + 31 of the hidden
// chunk hs, [TP][HS_LD] bf16) by the chunk's weights wsT ([C_out8][HS_LD],
// transposed), mma.sync m16n8k16 into acc.
template <int CUT, int NT>
__device__ __forceinline__ void project_chunk(const bf16* hs, const bf16* wsT,
                                              int w, int nt_count,
                                              float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < CE; ks += 16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16* ap = hs + ((w * 2 + i) * 16 + g) * HS_LD + ks + tig * 2;
      const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * HS_LD), lds32(ap + 8),
                             lds32(ap + 8 * HS_LD + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt_count) {
          const bf16* bp = wsT + (nt * 8 + g) * HS_LD + ks + tig * 2;
          const uint32_t b[2] = {lds32(bp), lds32(bp + 8)};
          if (CUT == kNoProj) {
            // Keeps the operands' loads at one ALU operation.
            acc[i][nt][0] += 0.f * __uint_as_float(
                (a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]) & 0x3f800000u);
          } else {
            mma_bf16(acc[i][nt], a, b);
          }
        }
      }
    }
  }
}

// project_chunk with the chunk's weights as W_p's own rows, wr [32][cout]
// bf16 (cout % 8 == 0: 16-byte rows), B fragments by ldmatrix.trans (lanes
// 0-7 and 8-15 give k rows 0-7 and 8-15 of an 8-column tile, 16-31 the
// next tile's).
template <int CUT>
__device__ __forceinline__ void project_chunk_rm(const bf16* hs,
                                                 const bf16* wr, int cout,
                                                 int w, int nt_count,
                                                 float (&acc)[2][WS_NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* bp = wr + ((lane >> 3) & 1) * 8 * cout + (lane & 7) * cout +
                   (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < CE; ks += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16* ap = hs + ((w * 2 + i) * 16 + g) * HS_LD + ks + tig * 2;
      a[i][0] = lds32(ap);
      a[i][1] = lds32(ap + 8 * HS_LD);
      a[i][2] = lds32(ap + 8);
      a[i][3] = lds32(ap + 8 * HS_LD + 8);
    }
#pragma unroll
    for (int nt = 0; nt < WS_NT; nt += 2) {
      if (nt >= nt_count) continue;
      uint32_t b[4];
      const bf16* bq = bp + ks * cout + nt * 8;
      if (nt + 1 < nt_count) {
        ldmatrix_x4_trans(b, bq);
      } else {
        // The odd last tile: lanes 16-31 repeat tile nt's addresses.
        ldmatrix_x4_trans(b, bq - (lane >> 4) * 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (nt + h >= nt_count) continue;
        const uint32_t bb[2] = {b[2 * h], b[2 * h + 1]};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (CUT == kNoProj) {
            acc[i][nt + h][0] += 0.f * __uint_as_float(
                (a[i][0] ^ a[i][1] ^ a[i][2] ^ a[i][3] ^ bb[0] ^ bb[1]) &
                0x3f800000u);
          } else {
            mma_bf16(acc[i][nt + h], a[i], bb);
          }
        }
      }
    }
  }
}

// y of one warp's 32 pixels from acc (rounded, plus x with identity); cout
// even.
template <int NT>
__device__ __forceinline__ void store_y(const float (&acc)[2][NT][4],
                                        const bf16* __restrict__ xn,
                                        bf16* __restrict__ yn, int w,
                                        int nt_count, int H, int W, int cin,
                                        int cout, int identity, int ty0,
                                        int tx0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + tig * 2;
      if (nt >= nt_count || col >= cout) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (w * 2 + i) * 16 + g + half * 8;
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
}

// =============================================================================
// The persistent, warp-specialised design (the path's).

constexpr int PRODUCERS = NTHREADS;  // warps 0-7: expand, depthwise, gate
constexpr int CONSUMERS = NTHREADS;  // warps 8-15: projection, y
constexpr int WS_THREADS = PRODUCERS + CONSUMERS;
constexpr int SLOTS = 2;             // hidden chunks in flight
constexpr int BAR_P = 1;             // the producers' named barrier
constexpr int BAR_C = 2;             // the consumers'

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(BAR_C), "n"(CONSUMERS) : "memory");
}

// Shared memory (byte offsets from smem_base): sweep 1's (expand_dw.cuh's
// Smem: the f32 halo, the x halo box, one chunk's expand weights and bias,
// the box's mbarrier), the hidden slots [SLOTS][TP][HS_LD] bf16, the
// projection-weight slots, a chunk's rows of W_p as they lie in HBM,
// [SLOTS][32][C_out] bf16, the mbarriers (hidden full and empty, weights
// full: SLOTS each) and, when `resident`, every chunk's expand weights
// [E32][ldx] bf16 and bias [E32] f32.
template <int K>
struct WsSmem {
  edw::Smem<K, true, true> ex;
  int hs, wp, bars, wres, bres, total;
  __host__ __device__ WsSmem(int cin, int e, int cout, bool resident)
      : ex(cin) {
    const int e32 = (e + CE - 1) / CE * CE;
    hs = (ex.bar + 8 + 127) / 128 * 128;
    wp = hs + SLOTS * TP * HS_LD * 2;
    bars = wp + SLOTS * CE * cout * 2;
    wres = bars + 3 * SLOTS * 8;
    bres = wres + (resident ? e32 * ex.ldx * 2 : 0);
    total = bres + (resident ? e32 * 4 : 0) + 128;
  }
};

template <int K, int CUT>
__global__ void __launch_bounds__(WS_THREADS, 1)
    fused_project_ws(const __grid_constant__ CUtensorMap xmap,
                     const bf16* __restrict__ x, const bf16* __restrict__ we,
                     const float* __restrict__ wd,
                     const float* __restrict__ be,
                     const float* __restrict__ bd,
                     const float* __restrict__ gate,
                     const bf16* __restrict__ wp, bf16* __restrict__ y, int N,
                     int H, int W, int cin, int E, int cout, int pre_act,
                     int identity, int tiles_x, int tiles_per_image,
                     int resident) {
  using G = edw::Halo<K>;
  char* base = edw::smem_base();
  const WsSmem<K> L(cin, E, cout, resident != 0);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(base + L.ex.bar);
  uint64_t* hs_full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* hs_empty = hs_full + SLOTS;
  uint64_t* wp_full = hs_empty + SLOTS;
  bf16* hslots = reinterpret_cast<bf16*>(base + L.hs);
  bf16* xs = reinterpret_cast<bf16*>(base + L.ex.xs);
  const int ldx = L.ex.ldx;
  const int nch = (E + CE - 1) / CE;
  const int total = N * tiles_per_image;
  // This CTA's items: blockIdx.x + i gridDim.x, nch chunks each.
  const int items = (int)blockIdx.x < total
                        ? (total - (int)blockIdx.x + (int)gridDim.x - 1) /
                              (int)gridDim.x
                        : 0;
  const int lane = threadIdx.x & 31;
  auto origin = [&](int i, int& n, int& ty0, int& tx0) {
    const int it = (int)blockIdx.x + i * (int)gridDim.x;
    const int t = it % tiles_per_image;
    n = it / tiles_per_image;
    ty0 = (t / tiles_x) * TH;
    tx0 = (t % tiles_x) * TW;
  };
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&hs_full[s], PRODUCERS / 32);
      mbar_init(&hs_empty[s], CONSUMERS / 32);
      mbar_init(&wp_full[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (items == 0) return;

  if (threadIdx.x < PRODUCERS) {
    // ---- producers: expand + depthwise + gate -> hidden slots ----------
    // Item i's x halo as one TMA box (xs is free: the previous expand's
    // last barrier).
    auto issue_x = [&](int i) {
      if (threadIdx.x == 0) {
        int n, ty0, tx0;
        origin(i, n, ty0, tx0);
        fence_proxy_async();
        mbar_expect_tx(xbar, G::HP * ldx * 2);
        tma_load_4d(xs, &xmap, 0, tx0 - G::P, ty0 - G::P, n, xbar);
      }
    };
    if (resident) {
      // Every chunk's expand weights (lanes on consecutive channels:
      // coalesced reads) and biases, once; the first expand's barrier
      // publishes them.
      const int e32 = nch * CE;
      bf16* wr = reinterpret_cast<bf16*>(base + L.wres);
      for (int idx = threadIdx.x; idx < e32 * L.ex.cin16; idx += PRODUCERS) {
        const int ee = idx % e32, ci = idx / e32;
        bf16 v = __float2bfloat16_rn(0.f);
        if (ci < cin && ee < E) v = we[(size_t)ci * E + ee];
        wr[ee * ldx + ci] = v;
      }
      float* br = reinterpret_cast<float*>(base + L.bres);
      for (int i = threadIdx.x; i < e32; i += PRODUCERS)
        br[i] = (be != nullptr && i < E) ? be[i] : 0.f;
    }
    if (CUT != kSyncStage) issue_x(0);
    const float* buf = reinterpret_cast<const float*>(base);
    const int oy0 = edw::dw_row0(), ox0 = edw::dw_col0();
    int q = 0;  // chunks so far: hidden slot q % SLOTS, its use q / SLOTS
    for (int i = 0; i < items; ++i) {
      int n, ty0, tx0;
      origin(i, n, ty0, tx0);
      const bf16* xn = x + (size_t)n * H * W * cin;
      if (CUT == kSyncStage) issue_x(i);
      mbar_wait(xbar, i & 1);
      edw::reflect_box<G::P, G::HH, G::HW, BAR_P>(xs, ldx, H, W, ty0 - G::P,
                                                  tx0 - G::P);
      for (int c0 = 0; c0 < E; c0 += CE, ++q) {
        edw::Smem<K, true, true> Lc = L.ex;
        if (resident) {
          Lc.ws = L.wres + c0 * ldx * 2;
          Lc.bes = L.bres + c0 * 4;
        } else {
          // The previous expand is done with ws (its last barrier).
          edw::stage_weights<bf16, K, true, true>(we, be, base, L.ex, cin,
                                                  E, c0);
        }
        // The lane's depthwise weights, bias and gate, loaded before the
        // expand so that their latency passes under it.
        const int ch = c0 + lane;
        const float gv = ch < E ? gate[(size_t)n * E + ch] : 0.f;
        float wk[K * K], bdv, o[DW_ROWS][DW_COLS];
        edw::load_dw<K>(wd, bd, E, ch, wk, bdv);
        edw::expand_halo<bf16, K, true, true, edw::kFused, 0, BAR_P>(
            xn, base, Lc, H, W, cin, pre_act, ty0, tx0);
        // The next item's halo comes in while this chunk's depthwise runs.
        if (CUT != kSyncStage && c0 + CE >= E && i + 1 < items)
          issue_x(i + 1);
        // The gate rounded to bf16 in both halves (0 past E).
        const __nv_bfloat162 g2 = __float2bfloat162_rn(gv);
        if constexpr (CUT == kNoDw)
          depthwise_cut<K>(buf, bdv, o);
        else
          edw::depthwise_tile<K>(buf, wk, bdv, o);
        const int s = q % SLOTS, use = q / SLOTS;
        if (use > 0) mbar_wait(&hs_empty[s], (use - 1) & 1);
        bf16* hs = hslots + s * TP * HS_LD + (oy0 * TW + ox0) * HS_LD + lane;
        // round(round(out) * round(gate)), two pixels at a time: the
        // product of two bf16 values is exact in f32, so one bf16x2 fma
        // (bf16x2_mul) rounds it as the f32 product rounded would be.
        const bool cols_in = tx0 + ox0 + DW_COLS <= W;
#pragma unroll
        for (int r = 0; r < DW_ROWS; ++r) {
          const bool row_in = ty0 + oy0 + r < H;
#pragma unroll
          for (int j = 0; j < DW_COLS; j += 2) {
            const __nv_bfloat162 ob = __floats2bfloat162_rn(o[r][j],
                                                            o[r][j + 1]);
            uint32_t hv = bf16x2_mul(*reinterpret_cast<const uint32_t*>(&ob),
                                     *reinterpret_cast<const uint32_t*>(&g2));
            if (!(row_in && cols_in)) {
              // The ragged edge: pixels outside the image are zero.
              const bool in0 = row_in && tx0 + ox0 + j < W;
              const bool in1 = row_in && tx0 + ox0 + j + 1 < W;
              hv &= (in0 ? 0xffffu : 0u) | (in1 ? 0xffff0000u : 0u);
            }
            reinterpret_cast<uint16_t*>(hs)[(r * TW + j) * HS_LD] =
                (uint16_t)(hv & 0xffffu);
            reinterpret_cast<uint16_t*>(hs)[(r * TW + j + 1) * HS_LD] =
                (uint16_t)(hv >> 16);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&hs_full[s]);
      }
    }
  } else {
    // ---- consumers: projection weights, products, y --------------------
    const int ct = threadIdx.x - PRODUCERS;
    const int w = ct >> 5;
    const int nt_count = (cout + 7) / 8;
    const int nq = items * nch;
    bf16* wslots = reinterpret_cast<bf16*>(base + L.wp);
    // Chunk q's rows of W_p, contiguous in HBM, as one bulk copy into slot
    // q % SLOTS (a partial last chunk leaves the slot's other rows, zero
    // or an earlier chunk's weights, against zero hidden channels).
    auto issue_wp = [&](int q) {
      const int c0 = (q % nch) * CE, rows = min(CE, E - c0);
      uint64_t* bar = &wp_full[q % SLOTS];
      fence_proxy_async();
      mbar_expect_tx(bar, rows * cout * 2);
      bulk_load(wslots + (q % SLOTS) * CE * cout, wp + (size_t)c0 * cout,
                rows * cout * 2, bar);
    };
    for (int i = ct; i < SLOTS * CE * cout / 8; i += CONSUMERS)
      reinterpret_cast<uint4*>(wslots)[i] = make_uint4(0, 0, 0, 0);
    consumer_sync();
    if (ct == 0)
      for (int q = 0; q < min(SLOTS, nq); ++q) issue_wp(q);
    int q = 0;
    for (int i = 0; i < items; ++i) {
      int n, ty0, tx0;
      origin(i, n, ty0, tx0);
      float acc[2][WS_NT][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int nt = 0; nt < WS_NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[a][nt][r] = 0.f;
      for (int c = 0; c < nch; ++c, ++q) {
        const int s = q % SLOTS, use = q / SLOTS;
        mbar_wait(&wp_full[s], use & 1);
        mbar_wait(&hs_full[s], use & 1);
        project_chunk_rm<CUT>(hslots + s * TP * HS_LD,
                                      wslots + s * CE * cout, cout, w,
                                      nt_count, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&hs_empty[s]);
        // Every consumer is done with the weights' slot: refill it.
        consumer_sync();
        if (ct == 0 && q + SLOTS < nq) issue_wp(q + SLOTS);
      }
      store_y(acc, x + (size_t)n * H * W * cin,
                      y + (size_t)n * H * W * cout, w, nt_count, H, W, cin,
                      cout, identity, ty0, tx0);
    }
  }
}

// Whether the persistent design keeps every chunk's expand weights: where
// they fit, and not under the kSyncStage cut.
template <int K>
bool ws_resident(int cin, int e, int cout, int cut) {
  return cut != kSyncStage &&
         WsSmem<K>(cin, e, cout, true).total <= max_smem();
}

template <int K, int CUT>
cudaError_t launch_ws(const void* x, const void* we, const void* wd,
                      const void* be, const void* bd, const void* gate,
                      const void* wp, void* y, int n, int h, int w, int cin,
                      int e, int cout, int pre_act, int identity,
                      cudaStream_t stream) {
  const bool resident = ws_resident<K>(cin, e, cout, CUT);
  const WsSmem<K> L(cin, e, cout, resident);
  if (L.total > max_smem()) return cudaErrorInvalidValue;
  auto kernel = fused_project_ws<K, CUT>;
  CUtensorMap xmap{};
  if (!edw::make_x_map(&xmap, x, n, h, w, cin, edw::Halo<K>::HW,
                       edw::Halo<K>::HH))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        WS_THREADS, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_per_image = tiles_x * ((h + TH - 1) / TH);
  const long long items = (long long)n * tiles_per_image;
  const int grid = (int)std::min<long long>(items, (long long)per_sm * sms);
  kernel<<<grid, WS_THREADS, L.total, stream>>>(
      xmap, static_cast<const bf16*>(x), static_cast<const bf16*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<const float*>(gate),
      static_cast<const bf16*>(wp), static_cast<bf16*>(y), n, h, w, cin, e,
      cout, pre_act, identity, tiles_x, tiles_per_image, (int)resident);
  return cudaGetLastError();
}

// =============================================================================
// The tile design: one CTA per (image, 16x16 tile).

// Shared memory of the tile kernel (byte offsets): expand_dw.cuh's (the halo
// buffers and the chunk's expand weights; SPLIT: its kCSplit layout, one
// 64-channel chunk of the x box at a time), then the gated hidden chunk and
// the projection weights' chunk: PMMA bf16 [TP][HS_LD] and [NT * 8][HS_LD]
// (transposed); else f32 [TP][HS_F32_LD] and, 16-byte aligned,
// [CE][NT * 8] (zeros past C_out).  The CUDA-core projection's outputs
// stay in registers (one pixel per thread), as PMMA's do.
template <int K, bool EXPAND, bool MMA, bool PMMA, int NT, bool SPLIT = false>
struct Smem {
  edw::Smem<K, EXPAND, MMA, SPLIT ? 3 : 0> ex;
  int hs, ws, total;
  __host__ __device__ explicit Smem(int cin) : ex(cin) {
    hs = ex.total;
    ws = PMMA ? hs + TP * HS_LD * 2 : (hs + TP * HS_F32_LD * 4 + 15) / 16 * 16;
    total = ws + (PMMA ? NT * 8 * HS_LD * 2 : CE * NT * 8 * 4);
  }
};

// y (n, h, w, cout); gate (n, e) f32 from the sums pass; wp the projection,
// (e, cout); xmap: x as edw::make_x_map's map (MMA only).  PMMA: the
// projection runs on the tensor cores (acc, per warp 32 pixels x NT * 8
// outputs); else on the CUDA cores, each thread one pixel's NT * 8 outputs
// in registers (accp; f32 fmaf chains over the chunks in order, as the
// twin's f32 sums).  Both accumulate across the chunks of E.  SPLIT (bf16
// x whose whole box cannot be one, edw::c_split): each chunk of E restages
// the x box in 64-channel chunks and adds their products in f32
// (expand_dw.cuh's kCSplit), instead of staging the whole box once per
// tile.  NT: 12 (C_out <= 96) or 16.
template <typename T, int K, bool EXPAND, bool MMA, bool PMMA, int CUT,
          int NT, bool SPLIT = false>
__global__ void __launch_bounds__(NTHREADS)
    fused_project_tile(const __grid_constant__ CUtensorMap xmap,
                       const T* __restrict__ x, const T* __restrict__ we,
                       const float* __restrict__ wd,
                       const float* __restrict__ be,
                       const float* __restrict__ bd,
                       const float* __restrict__ gate,
                       const T* __restrict__ wp, T* __restrict__ y, int H,
                       int W, int cin, int E, int cout, int pre_act,
                       int identity, int tiles_x) {
  constexpr int CO = NT * 8;  // outputs per pixel the kernel holds
  char* base = edw::smem_base();
  const Smem<K, EXPAND, MMA, PMMA, NT, SPLIT> L(cin);
  float* buf = reinterpret_cast<float*>(base);
  char* hs_b = base + L.hs;
  char* ws_b = base + L.ws;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const T* xn = x + (size_t)n * H * W * cin;
  const int nt_count = (cout + 7) / 8;

  [[maybe_unused]] float acc[2][NT][4];  // PMMA
  [[maybe_unused]] float accp[CO];       // the CUDA-core projection
  if constexpr (PMMA) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
  } else {
#pragma unroll
    for (int co = 0; co < CO; ++co) accp[co] = 0.f;
  }

  // The tile's x halo is staged once for every chunk of E (the expand's
  // first barrier publishes it); SPLIT: chunk by chunk for each.
  [[maybe_unused]] uint64_t* xbar =
      reinterpret_cast<uint64_t*>(base + L.ex.bar);
  [[maybe_unused]] __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(base + L.ex.xs);
  [[maybe_unused]] uint32_t xphase = 0;
  if constexpr (MMA) {
    if (threadIdx.x == 0) {
      mbar_init(xbar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    if constexpr (!SPLIT) {
      edw::stage_x<T, K, edw::kFused>(&xmap, xbar, x, xs, L.ex.ldx,
                                      L.ex.cin16, H, W, cin, n, ty0, tx0);
      edw::wait_x<K>(xbar, 0, xs, L.ex.ldx, H, W, ty0, tx0);
    }
  }
  const int oy0 = edw::dw_row0(), ox0 = edw::dw_col0();
  for (int c0 = 0; c0 < E; c0 += CE) {
    // The previous chunk's expand is done with the expand weights (its last
    // barrier), its projection with the hidden chunk (this expand's first).
    edw::stage_weights<T, K, EXPAND, MMA>(we, be, base, L.ex, cin, E, c0);
    if constexpr (SPLIT) {
      // Each x chunk once the last expand is done with xs (its last
      // barrier): the first's products as partial sums, the middle ones'
      // added, the last one's with the epilogue.
      constexpr int MODE = edw::kFused | edw::kCSplit;
      for (int ch0 = 0; ch0 < L.ex.cin16; ch0 += L.ex.bch) {
        edw::stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ex.ldxs, L.ex.bch, H,
                                 W, cin, n, ty0, tx0, ch0);
        edw::wait_x<K>(xbar, xphase, xs, L.ex.ldxs, H, W, ty0, tx0);
        xphase ^= 1;
        if (ch0 == 0)
          edw::expand_halo<T, K, EXPAND, MMA, MODE, 1>(
              xn, base, L.ex, H, W, cin, pre_act, ty0, tx0, ch0);
        else if (ch0 + L.ex.bch < L.ex.cin16)
          edw::expand_halo<T, K, EXPAND, MMA, MODE, 3>(
              xn, base, L.ex, H, W, cin, pre_act, ty0, tx0, ch0);
        else
          edw::expand_halo<T, K, EXPAND, MMA, MODE, 2>(
              xn, base, L.ex, H, W, cin, pre_act, ty0, tx0, ch0);
      }
    } else if constexpr (EXPAND)
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
    if constexpr (CUT == kNoDw)
      depthwise_cut<K>(buf, bdv, o);
    else
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
    // The chunk's W_p rows [c0, c0 + 32) are contiguous: lanes on
    // consecutive output channels.
    if constexpr (PMMA) {
      __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(ws_b);
      const int cout8 = nt_count * 8;
      for (int idx = threadIdx.x; idx < cout8 * CE; idx += NTHREADS) {
        const int kk = idx / cout8, co = idx % cout8;
        wsT[co * HS_LD + kk] = (co < cout && c0 + kk < E)
                                   ? wp[(size_t)(c0 + kk) * cout + co]
                                   : __float2bfloat16_rn(0.f);
      }
    } else {
      float* wsf = reinterpret_cast<float*>(ws_b);  // [CE][CO]
      for (int idx = threadIdx.x; idx < CE * CO; idx += NTHREADS) {
        const int kk = idx / CO, co = idx % CO;
        wsf[idx] = co < cout && c0 + kk < E
                       ? to_f32(wp[(size_t)(c0 + kk) * cout + co])
                       : 0.f;
      }
    }
    __syncthreads();

    if constexpr (PMMA) {
      project_chunk<CUT, NT>(reinterpret_cast<const bf16*>(hs_b),
                             reinterpret_cast<const bf16*>(ws_b), warp,
                             nt_count, acc);
    } else {
      const float* hp = reinterpret_cast<const float*>(hs_b) +
                        threadIdx.x * HS_F32_LD;
      const float4* w4 = reinterpret_cast<const float4*>(ws_b);
      if (CUT == kNoProj) {
        accp[0] += 0.f * hp[0] * w4[0].x;
      } else {
        // Every thread reads the same weights: broadcasts.
#pragma unroll 2
        for (int kk = 0; kk < CE; ++kk) {
          const float h = hp[kk];
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 wv = w4[kk * (CO / 4) + q];
            accp[4 * q] = fmaf(h, wv.x, accp[4 * q]);
            accp[4 * q + 1] = fmaf(h, wv.y, accp[4 * q + 1]);
            accp[4 * q + 2] = fmaf(h, wv.z, accp[4 * q + 2]);
            accp[4 * q + 3] = fmaf(h, wv.w, accp[4 * q + 3]);
          }
        }
      }
    }
  }

  T* yn = y + (size_t)n * H * W * cout;
  if constexpr (PMMA) {
    store_y<NT>(acc, reinterpret_cast<const bf16*>(xn),
                reinterpret_cast<bf16*>(yn), warp, nt_count, H, W, cin, cout,
                identity, ty0, tx0);
  } else {
    // 32 outputs of every pixel at a time through the hidden chunk's rows
    // (their last readers are past the barrier), then stored coalesced.
    float* hs = reinterpret_cast<float*>(hs_b);
#pragma unroll
    for (int co0 = 0; co0 < CO; co0 += CE) {
      if (co0 < cout) {  // the same for every thread
        __syncthreads();
#pragma unroll
        for (int j = 0; j < CE; ++j)
          hs[threadIdx.x * HS_F32_LD + j] = accp[co0 + j];
        __syncthreads();
        for (int idx = threadIdx.x; idx < TP * CE; idx += NTHREADS) {
          const int p = idx / CE, j = idx % CE, co = co0 + j;
          const int gy = ty0 + p / TW, gx = tx0 + p % TW;
          if (co >= cout || gy >= H || gx >= W) continue;
          const size_t px = (size_t)gy * W + gx;
          T out = from_f32<T>(hs[p * HS_F32_LD + j]);
          if (identity)
            out = from_f32<T>(to_f32(out) + to_f32(xn[px * cin + co]));
          yn[px * cout + co] = out;
        }
      }
    }
  }
}

template <typename T, int K, bool EXPAND, bool MMA, bool PMMA, int CUT,
          int NT, bool SPLIT = false>
cudaError_t launch_tile(const void* x, const void* we, const void* wd,
                        const void* be, const void* bd, const void* gate,
                        const void* wp, void* y, int n, int h, int w, int cin,
                        int e, int cout, int pre_act, int identity,
                        cudaStream_t stream) {
  const Smem<K, EXPAND, MMA, PMMA, NT, SPLIT> L(cin);
  const int smem = L.total;
  auto kernel = fused_project_tile<T, K, EXPAND, MMA, PMMA, CUT, NT, SPLIT>;
  CUtensorMap xmap{};
  if (MMA && !edw::make_x_map(&xmap, x, n, h, w, cin, edw::Halo<K>::HW,
                              edw::Halo<K>::HH, L.ex.ldxs))
    return cudaErrorInvalidValue;
  if (smem > max_smem()) return cudaErrorInvalidValue;
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
      static_cast<const T*>(wp), static_cast<T*>(y), h, w, cin, e, cout,
      pre_act, identity, tiles_x);
  return cudaGetLastError();
}

// Whether the tile design stages a bf16 tensor-core expand's x box in
// chunks: where it cannot be one (edw::c_split), or where the whole box
// leaves no room for the hidden chunk and W_p's rows (PMMA's bf16 ones,
// else the CUDA-core projection's f32 hidden and weights).
template <int K, bool PMMA, int NT>
bool tile_split(int cin) {
  const Smem<K, true, true, PMMA, NT> whole(cin);
  return edw::c_split<K>(cin) || edw::box_split(whole.ex.ldx, whole.total);
}

// The tile design for this shape (its PMMA and NT chosen by the caller).
template <typename T, int K, bool PMMA, int NT>
cudaError_t tile_k(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, const void* gate,
                   const void* wp, void* y, int n, int h, int w, int cin,
                   int e, int cout, int pre_act, int identity,
                   cudaStream_t s) {
  if (we == nullptr)
    return launch_tile<T, K, false, false, PMMA, kNone, NT>(
        x, we, wd, be, bd, gate, wp, y, n, h, w, cin, e, cout, pre_act,
        identity, s);
  if constexpr (sizeof(T) == 2) {
    if (edw::use_mma<T, edw::kFused>(x, cin) && tile_split<K, PMMA, NT>(cin))
      return launch_tile<T, K, true, true, PMMA, kNone, NT, true>(
          x, we, wd, be, bd, gate, wp, y, n, h, w, cin, e, cout, pre_act,
          identity, s);
  }
  if (edw::use_mma<T, edw::kFused>(x, cin))
    return launch_tile<T, K, true, sizeof(T) == 2, PMMA, kNone, NT>(
        x, we, wd, be, bd, gate, wp, y, n, h, w, cin, e, cout, pre_act,
        identity, s);
  return launch_tile<T, K, true, false, PMMA, kNone, NT>(
      x, we, wd, be, bd, gate, wp, y, n, h, w, cin, e, cout, pre_act,
      identity, s);
}

// tile_k at the NT of this C_out: 12 up to 96 (the instances before C_out
// 128 was taken), else 16.
template <typename T, int K, bool PMMA>
cudaError_t tile_nt(const void* x, const void* we, const void* wd,
                    const void* be, const void* bd, const void* gate,
                    const void* wp, void* y, int n, int h, int w, int cin,
                    int e, int cout, int pre_act, int identity,
                    cudaStream_t s) {
  if (cout <= WS_NT * 8)
    return tile_k<T, K, PMMA, WS_NT>(x, we, wd, be, bd, gate, wp, y, n, h, w,
                                     cin, e, cout, pre_act, identity, s);
  return tile_k<T, K, PMMA, MAX_NT>(x, we, wd, be, bd, gate, wp, y, n, h, w,
                                    cin, e, cout, pre_act, identity, s);
}

// =============================================================================

// Design 1 (persistent) takes bf16 NHWC x with the tensor-core expand
// (C_in % 8 == 0, x 16-byte aligned) whose whole box is one (not
// edw::c_split: it stages the box once per item) and fits beside its
// slots, C_out % 8 == 0 (W_p's rows are 16-byte bulk copies) and <= 96 (its
// consumers' 128 registers), a 16-byte aligned W_p and a 4-byte aligned y;
// design 0 (tile) any shape, C_out <= 128.
template <typename T>
bool persistent_ok(const void* x, const void* we, const void* wp,
                   const void* y, int cin, int cout, int k) {
  return sizeof(T) == 2 && we != nullptr &&
         edw::use_mma<T, edw::kFused>(x, cin) && cout % 8 == 0 &&
         cout <= WS_NT * 8 && aligned(wp, 16) && aligned(y, 4) &&
         (k == 3 ? !edw::c_split<3>(cin) &&
                       WsSmem<3>(cin, 0, cout, false).total <= max_smem()
                 : !edw::c_split<5>(cin) &&
                       WsSmem<5>(cin, 0, cout, false).total <= max_smem());
}

bool shape_ok(const void* we, int cin, int e, int cout, int k,
              int identity) {
  return cout <= MAX_COUT && (we != nullptr || e == cin) &&
         (!identity || cin == cout) && (k == 3 || k == 5);
}

template <typename T>
cudaError_t project(int design, const void* x, const void* we,
                    const void* wd, const void* be, const void* bd,
                    const void* gate, const void* wp, void* y, int n, int h,
                    int w, int cin, int e, int cout, int k, int pre_act,
                    int identity, cudaStream_t s) {
  if (!shape_ok(we, cin, e, cout, k, identity)) return cudaErrorInvalidValue;
  if (design == 1) {
    if constexpr (sizeof(T) == 2)
      return k == 3 ? launch_ws<3, kNone>(x, we, wd, be, bd, gate, wp, y, n,
                                          h, w, cin, e, cout, pre_act,
                                          identity, s)
                    : launch_ws<5, kNone>(x, we, wd, be, bd, gate, wp, y, n,
                                          h, w, cin, e, cout, pre_act,
                                          identity, s);
    return cudaErrorInvalidValue;
  }
  const bool pmma = sizeof(T) == 2 && cout % 2 == 0 && aligned(y, 4) &&
                    (!identity || aligned(x, 4));
  if (k == 3)
    return pmma ? tile_nt<T, 3, sizeof(T) == 2>(x, we, wd, be, bd, gate, wp,
                                                y, n, h, w, cin, e, cout,
                                                pre_act, identity, s)
                : tile_nt<T, 3, false>(x, we, wd, be, bd, gate, wp, y, n, h,
                                       w, cin, e, cout, pre_act, identity, s);
  return pmma ? tile_nt<T, 5, sizeof(T) == 2>(x, we, wd, be, bd, gate, wp, y,
                                              n, h, w, cin, e, cout, pre_act,
                                              identity, s)
              : tile_nt<T, 5, false>(x, we, wd, be, bd, gate, wp, y, n, h, w,
                                     cin, e, cout, pre_act, identity, s);
}

// One design with one part cut out, at a bf16 shape of the persistent
// design (the tile design's tensor-core variant, PMMA).
template <int CUT>
cudaError_t project_cut(int design, const void* x, const void* we,
                        const void* wd, const void* be, const void* bd,
                        const void* gate, const void* wp, void* y, int n,
                        int h, int w, int cin, int e, int cout, int k,
                        int pre_act, int identity, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (!shape_ok(we, cin, e, cout, k, identity) ||
      !persistent_ok<B>(x, we, wp, y, cin, cout, k))
    return cudaErrorInvalidValue;
  if (design == 1)
    return k == 3 ? launch_ws<3, CUT>(x, we, wd, be, bd, gate, wp, y, n, h,
                                      w, cin, e, cout, pre_act, identity, s)
                  : launch_ws<5, CUT>(x, we, wd, be, bd, gate, wp, y, n, h,
                                      w, cin, e, cout, pre_act, identity, s);
  return k == 3 ? launch_tile<B, 3, true, true, true, CUT, WS_NT>(
                      x, we, wd, be, bd, gate, wp, y, n, h, w, cin, e, cout,
                      pre_act, identity, s)
                : launch_tile<B, 5, true, true, true, CUT, WS_NT>(
                      x, we, wd, be, bd, gate, wp, y, n, h, w, cin, e, cout,
                      pre_act, identity, s);
}

// 1 if the last fused_project launch took the persistent design, 0 the
// tile design, -1 before any.
int last_design = -1;

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
// the f32 SE gate (n, e) and the projection wp (e, cout), with cout <= 128;
// identity adds x (cin == cout).  The persistent design where it takes the
// shape, else the tile design.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_project_launch(const void* x, const void* we,
                                    const void* wd, const void* be,
                                    const void* bd, const void* gate,
                                    const void* wp, void* y, int n, int h,
                                    int w, int cin, int e, int cout, int k,
                                    int pre_act, int identity, int is_bf16,
                                    void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int design =
      is_bf16 &&
      f2p::persistent_ok<__nv_bfloat16>(x, we, wp, y, cin, cout, k);
  f2p::last_design = design;
  if (is_bf16)
    return (int)f2p::project<__nv_bfloat16>(design, x, we, wd, be, bd, gate,
                                            wp, y, n, h, w, cin, e, cout, k,
                                            pre_act, identity, s);
  return (int)f2p::project<float>(design, x, we, wd, be, bd, gate, wp, y, n,
                                  h, w, cin, e, cout, k, pre_act, identity,
                                  s);
}

// Which design the last fused_project_launch took: 1 persistent, 0 tile,
// -1 none yet.
extern "C" int fused_project_last_design() {
  return ast_kernels::f2p::last_design;
}

// bf16 fused_project through one design (0 tile, 1 persistent) with one
// part cut out (`cut`: 0 none, 1 the projection's products, 2 the
// depthwise's FMAs, 3 the x halo's prefetch and the resident expand
// weights; 3 is the tile design's own staging), for the ablation: its
// results are wrong under a cut.  Returns the cudaError_t of the launch.
extern "C" int fused_project_cut_launch(int design, int cut, const void* x,
                                        const void* we, const void* wd,
                                        const void* be, const void* bd,
                                        const void* gate, const void* wp,
                                        void* y, int n, int h, int w, int cin,
                                        int e, int cout, int k, int pre_act,
                                        int identity, void* stream) {
  using namespace ast_kernels;
  if (design < 0 || design > 1 || cut < 0 || cut > 3)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0 && cut == f2p::kSyncStage) cut = f2p::kNone;
#define AST_PROJECT(CUT)                                                    \
  return (int)f2p::project_cut<CUT>(design, x, we, wd, be, bd, gate, wp, y, \
                                    n, h, w, cin, e, cout, k, pre_act,      \
                                    identity, s)
  if (cut == f2p::kNoProj) AST_PROJECT(f2p::kNoProj);
  if (cut == f2p::kNoDw) AST_PROJECT(f2p::kNoDw);
  if (cut == f2p::kSyncStage) AST_PROJECT(f2p::kSyncStage);
  AST_PROJECT(f2p::kNone);
#undef AST_PROJECT
}

namespace ast_kernels {
namespace f2p {
namespace {

template <int K, bool PMMA, int NT>
cudaError_t tile_query(int cin, int* out) {
  using B = __nv_bfloat16;
  if (tile_split<K, PMMA, NT>(cin))
    return edw::query(
        fused_project_tile<B, K, true, true, PMMA, kNone, NT, true>, NTHREADS,
        Smem<K, true, true, PMMA, NT, true>(cin).total, out);
  return edw::query(fused_project_tile<B, K, true, true, PMMA, kNone, NT>,
                    NTHREADS, Smem<K, true, true, PMMA, NT>(cin).total, out);
}

// query() of the persistent design's kernel (1) or of the tile design's
// variant (0) that fused_project_launch takes for a bf16 block of
// contiguous tensors with the tensor-core expand: PMMA at an even C_out,
// NT 12 up to C_out 96, else 16, its x box whole or in chunks
// (tile_split).  Past C_out 128, or the persistent design past 96 (neither
// takes it): cudaErrorInvalidValue.
template <int K>
cudaError_t occupancy(int design, int cin, int e, int cout, int* out) {
  if (cout > (design == 1 ? WS_NT * 8 : MAX_COUT))
    return cudaErrorInvalidValue;
  if (design == 1) {
    out[3] = ws_resident<K>(cin, e, cout, kNone);
    return edw::query(fused_project_ws<K, kNone>, WS_THREADS,
                      WsSmem<K>(cin, e, cout, out[3]).total, out);
  }
  const bool small = cout <= WS_NT * 8;
  if (cout % 2 == 0)
    return small ? tile_query<K, true, WS_NT>(cin, out)
                 : tile_query<K, true, MAX_NT>(cin, out);
  return small ? tile_query<K, false, WS_NT>(cin, out)
               : tile_query<K, false, MAX_NT>(cin, out);
}

}  // namespace
}  // namespace f2p
}  // namespace ast_kernels

// Registers per thread, dynamic shared memory per CTA, resident CTAs per SM
// and (persistent design) whether every chunk's expand weights stay
// resident, of the bf16 tensor-core kernel of one design (0 tile, 1
// persistent) that a block of this shape launches, into out[4].  Launches
// nothing.
extern "C" int fused_project_occupancy(int design, int k, int cin, int e,
                                       int cout, int* out) {
  using namespace ast_kernels;
  out[3] = 0;
  if (k == 3) return (int)f2p::occupancy<3>(design, cin, e, cout, out);
  if (k == 5) return (int)f2p::occupancy<5>(design, cin, e, cout, out);
  return (int)cudaErrorInvalidValue;
}
