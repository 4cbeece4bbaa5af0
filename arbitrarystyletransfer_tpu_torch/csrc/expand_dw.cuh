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
//     NHWC.  The hidden is NHWC either way.  kXBox (with kXT): its halo
//     comes as a TMA box (below);
//   * kNoHidden: only the sums are written (_fused_kernel "sums");
//   * kTf32: f32 x, the expand as 3xTF32 (below); with kXBox from the
//     (N, H, C, W) box.
// At f32 the rounding bits change nothing.
//
// What bounds it on an H100: at the 512px decoder tail (d8-d10: k5, C_in 40,
// E 160-240, 8 x 512 x 512 pixels) the arithmetic is k*k f32 MACs per hidden
// value for the depthwise (d10: 12.6 G, 0.38 ms at the 67 TFLOP/s f32 peak)
// plus the 1x1 expand, ~1.5x the block's C_in*E MACs per pixel once the
// halo is recomputed, on the tensor cores for bf16 (mma.sync m16n8k16, bf16
// in, f32 accumulate: the products are exact in f32, as in the TPU's bf16
// matmul with f32 accumulation) and for f32 (3xTF32, a third of the 495
// TFLOP/s TF32 rate); the only large memory traffic is the one write of the
// hidden (d10: 1.0 GB bf16, 0.30 ms at 3.35 TB/s; twice that at f32).  So
// the design aims at the f32 FMA rate of the depthwise, and keeps
// everything else (the x halo's loads, the expand, the hidden's stores) off
// its way.  Both dtypes are served: f32 is ModelConfig's default, the
// stylize CLI's.
//
// Design:
//   * Persistent CTAs of 256 threads: grid (about two per SM, E / 32); a CTA
//     keeps one 32-channel chunk of E and walks (image, 16x16 output tile)
//     items, so the chunk's expand and depthwise weights and biases are
//     staged once per CTA (coalesced), the depthwise weights of the lane's
//     channel held in registers.  The SE sums are kept per thread across the
//     CTA's tiles of one image and added with one atomic per (CTA, image,
//     channel) into a zeroed (N, E) buffer; the order of those adds varies
//     from run to run (a few f32 ulps of the sum).
//   * The x halo ((16+2p)^2 pixels x all of C_in, reflect-indexed: the
//     reflection is an index map, valid because expand and hswish are per
//     pixel; channels past C_in zero, so K is padded to 16 in shared memory,
//     never in HBM) is staged as bf16 rows padded to conflict-free fragment
//     loads.  For NHWC x (C_in % 8 == 0, 16-byte aligned: every NHWC block
//     of the model) the next tile's halo is one TMA box, issued by one
//     thread while this tile's depthwise runs; the box is zero outside the
//     image, and the few halo rows and columns that reflection takes from
//     inside it are copied in shared memory (wait_x), so the reflection
//     stays an index map.  For (N, H, C, W) x with W % 8 == 0 (kXBox: every
//     mega block) the same, with a box of a (W, C, H, N) map: [halo row]
//     [cin16 channels][BW = 24 columns] (the inner extent a 16-byte
//     multiple, and its start too: an unaligned innermost coordinate
//     faults, so this mode's tile grid starts at column P - 8, XSHIFT, one
//     more tile per row; channels past C_in zero outside the tensor),
//     edges copied
//     by wait_xt, and the expand's A fragments read from it by
//     ldmatrix.trans (expand_mtile_t: 16-pixel tiles of two 8-column
//     groups, 24/20 of the MMA work at k5, 24/18 at k3).  Other (N, H, C, W)
//     x is staged synchronously by a thread per (channel, halo row), 16-byte
//     loads of the interior.
//   * Expand: each warp runs mma.sync on 16-row tiles of the halo x all 32
//     channels over the whole C_in, one tile at a time (the tiles left over
//     after whole rounds of 8 split by 8-channel column), and writes the
//     hswish'd values to the f32 halo buffer with 8-byte stores.  The halo
//     buffer is [pixel][32 channels] with the channel index XOR-swizzled by
//     8 * (pixel % 4), so those stores are conflict-free, and the
//     depthwise's reads (lane = channel, 32 consecutive words of a pixel)
//     stay so.  (Off the model's path, NHWC x at C_in % 8 != 0, (N, H, C,
//     W) x at W % 8 != 0, an unaligned x, or f32 C_in past the kTf32
//     design's shared memory: a CUDA-core expand, x staged as f32 in
//     32-channel steps into the halo buffer.)
//   * kTf32 (f32 NHWC x, C_in % 8 == 0, 16-byte aligned: every NHWC block
//     of the model): x comes as f32 TMA boxes ([pixel][bch + 4] words),
//     reflected in shared memory as the bf16 box is (reflect_box), and the
//     expand runs on the tensor cores as 3xTF32 (expand_mtile_tf32: x split
//     into TF32 hi + lo as its fragments are loaded, the weights split once
//     per CTA; lo hi + hi lo + hi hi on mma.sync m16n8k8, partials of
//     TF_PAIR k8 steps added in f32 to nearest).  The warps divide the
//     tiles as the bf16 expand does.  The split weights take 256 B per
//     input channel, so the box comes in chunks of bch channels
//     (tf32_chunk: the fewest with which two CTAs share an SM where that
//     costs at most one more chunk than one CTA's fewest, else those of
//     one CTA), kCSplit's machinery: chunk 0 prefetched while the previous
//     tile's depthwise runs, the others loaded after the previous chunk's
//     products, which are kept as f32 partial sums in the halo buffer.
//     k5 C_in 40: two chunks of 24 channels, 108,552 B, two CTAs per SM
//     (the whole box would take 134,152 B: one).
//   * kTf32 with kXBox (f32 (N, H, C, W) x, W % 8 == 0, 16-byte aligned:
//     every mega block): kXBox's box in f32, [halo row][bch][BW = 24]
//     words (96-byte rows, on kXBox's shifted tile grid), in tf32_chunk's
//     channel chunks as above.  ldmatrix.trans moves 16-bit elements only,
//     so the A fragments (row = pixel, column = input channel) come by
//     32-bit loads (expand_mtile_tf32_t): lane (g, t) reads word
//     (k0 + t) * 24 + p0 + g, bank 24 t + g mod 32, 32 distinct banks, no
//     conflict.  Shared memory: the f32 halo, the box HH * bch * 96 B and
//     the split weights 256 * (C_in8 + 4) B: k5 C_in 40 two chunks of 24,
//     109,832 B, two CTAs (the whole box 140,552 B: one); k3 C_in 16 and
//     24 the whole box, 75,528 and 91,400 B, two CTAs; k3 C_in 80 the
//     whole box, 202,504 B, and k5 C_in 96 two chunks of 48, 170,248 B,
//     one CTA (two would take four and six chunks).
//   * Depthwise (depthwise_tile): each thread owns one channel (lane) and a
//     8-row x 4-column block of the tile (the 8 warps cover 16 x 16), 32
//     independent accumulators; every value read from shared memory feeds
//     up to 4 * k FMAs (k5: 800 FMAs per 96 reads; k3: 288 per 60).  The
//     swizzle of each read is known at compile time.
//   * The tile's hidden is staged as [pixel][32] in the halo buffer, then
//     written with 16-byte stores (64 contiguous bytes per pixel and chunk).
//   * Shared memory: the f32 halo, (16+2p)^2 * 128 B (51,200 B at k5), the
//     bf16 x halo, 16 * ceil((16+2p)^2 / 16) * (C_in16 + 8) * 2 B (44,800 B
//     at k5, C_in 40), the weights and 1.2 KB: ~100 KB at the k5 decoder
//     shapes: two CTAs per SM, and __launch_bounds__ asks for two, i.e. at
//     most 128 registers (three, at most 85, spilled at k3, gained 3-5%
//     at C_in <= 24 and lost 4% at C_in 80 on an H100; the CUDA-core
//     expand, off the path, asks for one to keep its 50 accumulators at
//     k5 in registers).  kXBox's box instead of the x halo: (16+2p) *
//     C_in16 * 24 * 2 B, 46,080 B at k5 C_in 40 (two CTAs).  At C_in16 >= 64
//     the whole box (k3 C_in 80: 69,120 B, 117.5 KB in all) would leave
//     one CTA per SM (two need at most 115,712 B each), so kXSplit loads it
//     in two channel halves, the second after the first half's products
//     (stored as f32 partial sums in the halo buffer): 90.9 KB at k3 C_in
//     80, 105.2 KB at k5 C_in 96, two CTAs.  The launcher sizes the grid
//     from the occupancy the runtime reports for the shape, never above it.
//   * kCSplit (NHWC x where the whole box cannot be one: its C_in16 + 8
//     channels wider than a TMA box may be, 256, or the kernel's shared
//     memory above the opt-in; ada_out's C_in 256 at 1024px and up): the
//     box comes in chunks of CCH = 64 channels ([pixel][72]), chunk 0
//     prefetched as above, the others each loaded after the previous
//     chunk's products, which are kept as f32 partial sums in the halo
//     buffer (as kXSplit's halves); the weights' K is padded to whole
//     chunks, zero past C_in.  k3 C_in 256: 108.0 KB, two CTAs (the whole
//     box would be 264 channels wide and take 237 KB).  Every other NHWC
//     shape of the model takes the whole box, as before.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace ast_kernels {
namespace edw {
// Internal linkage: every source that includes this header gets its own
// copy of the kernels, so no two objects of the library share a symbol.
namespace {

constexpr int TH = 16;        // output tile rows
constexpr int TW = 16;        // output tile columns
constexpr int CE = 32;        // hidden channels per CTA: one per lane
constexpr int CK = 32;        // input channels per step (CUDA-core expand)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DW_ROWS = 8;    // depthwise outputs per thread: rows
constexpr int DW_COLS = 4;    //   and columns
static_assert((TH / DW_ROWS) * (TW / DW_COLS) == NWARPS,
              "the warps' depthwise blocks cover the tile");

// MODE bits (see the top of this file).
constexpr int kRoundEx = 1;
constexpr int kSumRounded = 2;
constexpr int kXT = 4;
constexpr int kNoHidden = 8;
constexpr int kXBox = 16;  // with kXT: x's halo as a TMA box (see stage_x)
constexpr int kXSplit = 32;  // with kXBox: the box in two channel halves
constexpr int kCSplit = 64;  // NHWC: the box in chunks of CCH channels
constexpr int CCH = 64;      // kCSplit's channels per box
constexpr int kTf32 = 128;   // NHWC f32 x: the 3xTF32 expand (see the top)
constexpr int TF_PAIR = 2;   // kTf32: k8 steps per partial sum
constexpr int kMaxBox = 256;  // elements along one dim of a TMA box
constexpr int kFused = 0;                      // _fused_kernel "hidden"
constexpr int kFlat = kRoundEx | kSumRounded;  // _flat_kernel
constexpr int kMega = kSumRounded | kXT;       // _mega_kernel_t
constexpr int kSums = kNoHidden;               // _fused_kernel "sums"

template <int K>
struct Halo {
  static constexpr int P = (K - 1) / 2;
  static constexpr int HH = TH + 2 * P;      // halo rows
  static constexpr int HW = TW + 2 * P;      // halo columns
  static constexpr int HP = HH * HW;         // halo pixels
  static constexpr int MT = (HP + 15) / 16;  // 16-row MMA tiles
  // The (N, H, C, W) box: BW columns (16-byte rows), cut into GPR groups of
  // 8 pixels along a halo row; two groups make one 16-row MMA tile.
  static constexpr int BW = (HW + 7) / 8 * 8;
  static constexpr int GPR = BW / 8;
  static constexpr int MTB = HH * GPR / 2;
  static_assert((HH * GPR) % 2 == 0, "whole MMA tiles of groups");
  // The depthwise blocks start at pixels that are multiples of 4, so the
  // swizzle of each of their reads is a compile-time constant.
  static_assert((DW_ROWS * HW) % 4 == 0 && DW_COLS % 4 == 0, "swizzle");
};

// Where a pixel's 32 channels sit in the f32 halo buffer: channel c of
// pixel p at p * 32 + (c ^ swz(p)).
__host__ __device__ constexpr int swz(int p) { return (p & 3) << 3; }

// Byte offsets of the shared memory of expand_halo and the kernel:
//   buf  f32 [HP][32], swizzled: the expanded halo; also the CUDA-core
//        expand's f32 x staging and the tile's hidden before its stores;
//   xs   bf16 [MT * 16][ldx] (MMA only): the x halo, C_in padded to cin16;
//   ws   the chunk's expand weights: bf16 [32][ldx] (MMA), f32 [cin4][32];
//   red  f32 [NWARPS][32]: the SE sums' reduction;
//   bes  f32 [32]: the chunk's expand bias (0 past E);
//   bar  the mbarrier of xs's TMA box;
// from a 128-byte aligned base (smem_base), which `total` leaves room for.
//   (XB 1: xs holds the (N, H, C, W) box, bf16 [HH][bch][BW], bch = cin16;
//   XB 2, kXSplit: one channel half of it at a time, bch = cin16 / 2 and
//   cin16 padded to 2 bch, the weights' K zero past C_in; XB 3, kCSplit:
//   xs holds one NHWC chunk, [pixel][ldxs = CCH + 8], bch = CCH and cin16
//   padded to whole chunks.  Otherwise ldxs = ldx.  XB 4, kTf32: f32
//   words, xs one NHWC chunk of `tbch` channels (tf32_chunk),
//   [MT * 16][ldxs = bch + 4], cin16 = C_in padded to 8 (k8 steps), ws
//   the TF32 hi then lo parts of the weights, f32 [32][ldx = cin16 + 4]
//   each: rows an odd multiple of 16 bytes apart, so ldmatrix meets no
//   bank conflict.  XB 5, kTf32 with kXBox: as XB 4, xs one chunk of the
//   (N, H, C, W) box, f32 [HH][bch][BW], ldxs = BW.)
template <int K, bool EXPAND, bool MMA, int XB = 0>
struct Smem {
  int cin16, bch, ldx, ldxs, xs, ws, red, bes, bar, total;
  __host__ __device__ explicit Smem(int cin, int tbch = 0) {
    using G = Halo<K>;
    if (XB == 4 || XB == 5) {
      cin16 = (cin + 7) / 8 * 8;
      bch = tbch;
      ldx = cin16 + 4;
      ldxs = XB == 4 ? bch + 4 : G::BW;
      xs = G::HP * CE * 4;
      ws = xs + (XB == 4 ? G::MT * 16 * ldxs : G::HH * bch * G::BW) * 4;
      red = ws + 2 * CE * ldx * 4;
      bes = red + NWARPS * 32 * 4;
      bar = bes + CE * 4;
      total = bar + 8 + 128;
      return;
    }
    cin16 = (cin + 15) / 16 * 16;
    bch = XB == 2 ? (cin16 / 2 + 15) / 16 * 16 : XB == 3 ? CCH : cin16;
    if (XB == 2) cin16 = 2 * bch;
    if (XB == 3) cin16 = (cin + CCH - 1) / CCH * CCH;
    ldx = cin16 + 8;  // 16-byte multiple; rows 4 banks apart: conflict-free
    ldxs = XB == 3 ? bch + 8 : ldx;
    xs = G::HP * CE * 4;
    ws = xs + (!MMA ? 0
                    : XB == 1 || XB == 2 ? G::HH * bch * G::BW * 2
                                         : G::MT * 16 * ldxs * 2);
    const int wbytes = MMA ? CE * ldx * 2
                           : (EXPAND ? (cin + 3) / 4 * 4 * CE * 4 : 0);
    red = ws + (wbytes + 15) / 16 * 16;
    bes = red + NWARPS * 32 * 4;
    bar = bes + CE * 4;
    total = bar + 8 + 128;
  }
};

// The first output column of a row's tiles: 0, or with kXBox P - 8, so
// that every box starts at a multiple of 8 columns (TMA takes a box whose
// innermost coordinate is 16-byte aligned; an unaligned one faults on an
// H100).  The shifted grid has one more tile per row, its first and last
// partly outside the image (masked).
template <int K, int MODE>
constexpr int XSHIFT = (MODE & kXBox) != 0 ? Halo<K>::P - 8 : 0;

// The layout of a kernel of this MODE.
template <int K, bool EXPAND, bool MMA, int MODE>
using SmemM = Smem<K, EXPAND, MMA,
                   !MMA                        ? 0
                   : (MODE & kTf32) != 0       ? ((MODE & kXBox) != 0 ? 5
                                                                      : 4)
                   : (MODE & kCSplit) != 0     ? 3
                   : (MODE & kXBox) == 0       ? 0
                   : (MODE & kXSplit) != 0     ? 2
                                               : 1>;

// A barrier over the CTA (BAR 0: __syncthreads) or, in a warp-specialised
// kernel whose first NTHREADS threads run these sweep-1 functions, over
// those threads alone (named barrier BAR).
template <int BAR>
__device__ __forceinline__ void sweep_sync() {
  if constexpr (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"n"(BAR), "n"(NTHREADS) : "memory");
}

// The dynamic shared memory, aligned to 128 bytes (TMA's destination).
__device__ __forceinline__ char* smem_base() {
  extern __shared__ float4 smem4[];
  char* raw = reinterpret_cast<char*>(smem4);
  return raw + ((128 - (smem_addr(raw) & 127)) & 127);
}

// A 4-d tensor map over x (dims and byte strides innermost first), boxes
// of `box`, zeros outside; bf16 elements unless `type` says otherwise.
inline bool make_map_4d(
    CUtensorMap* map, const void* x, const cuuint64_t (&dims)[4],
    const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (n, h, w, cin) bf16 as the map of NHWC halo boxes (ldx channels, bw
// columns, bh rows, 1 image); cin % 8 == 0.  ldx: C_in16 + 8 (the whole
// box, the default) or kCSplit's CCH + 8.  f32: x is float (kTf32's
// chunks, ldx = bch + 4; cin % 4 == 0).
inline bool make_x_map(CUtensorMap* map, const void* x, int n, int h, int w,
                       int cin, int bw, int bh, int ldx = 0,
                       bool f32 = false) {
  if (ldx == 0) ldx = (cin + 15) / 16 * 16 + 8;
  const cuuint64_t es = f32 ? 4 : 2;
  return make_map_4d(map, x,
                     {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h,
                      (cuuint64_t)n},
                     {(cuuint64_t)cin * es, (cuuint64_t)w * cin * es,
                      (cuuint64_t)h * w * cin * es},
                     {(cuuint32_t)ldx, (cuuint32_t)bw, (cuuint32_t)bh, 1},
                     f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// x (n, h, cin, w) bf16 as the map of kXBox's boxes (BW columns, bch
// channels, 16 + 2p rows, 1 image): the channels past C_in lie outside
// the tensor and come as zeros.  w % 8 == 0 (16-byte strides).  f32: x
// is float (kTf32 with kXBox).
template <int K>
bool make_xt_map(CUtensorMap* map, const void* x, int n, int h, int w,
                 int cin, int bch, bool f32 = false) {
  const cuuint64_t es = f32 ? 4 : 2;
  return make_map_4d(map, x,
                     {(cuuint64_t)w, (cuuint64_t)cin, (cuuint64_t)h,
                      (cuuint64_t)n},
                     {(cuuint64_t)w * es, (cuuint64_t)cin * w * es,
                      (cuuint64_t)h * cin * w * es},
                     {(cuuint32_t)Halo<K>::BW, (cuuint32_t)bch,
                      (cuuint32_t)Halo<K>::HH, 1},
                     f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// x[n] at row gy, column gx, channel ci; xn is image n's base.
template <typename T, bool XT>
__device__ __forceinline__ T x_at(const T* __restrict__ xn, int gy, int gx,
                                  int ci, int W, int cin) {
  return XT ? xn[((size_t)gy * cin + ci) * W + gx]
            : xn[((size_t)gy * W + gx) * cin + ci];
}

// The 3xTF32 expand's weights of channels [c0, c0 + 32): each split once
// into its TF32 parts, hi and lo both rounded to nearest (split_tf32), so
// that the tensor cores, which read a TF32 operand's top 19 bits, take lo
// as it is; wh [32][ldx] the hi parts, then wl the lo parts, K columns
// [0, cin8) (zero past C_in).  Lanes on consecutive output channels:
// coalesced reads.
template <typename T>
__device__ __forceinline__ void stage_weights_tf32(const T* __restrict__ we,
                                                   uint32_t* wh, int ldx,
                                                   int cin8, int cin, int E,
                                                   int c0) {
  uint32_t* wl = wh + CE * ldx;
  for (int idx = threadIdx.x; idx < CE * cin8; idx += NTHREADS) {
    const int cc = idx % CE, ci = idx / CE;
    float v = 0.f;
    if (ci < cin && c0 + cc < E) v = to_f32(we[(size_t)ci * E + c0 + cc]);
    uint32_t hi, lo, lo_hi, lo_lo;
    split_tf32(v, hi, lo);
    split_tf32(__uint_as_float(lo), lo_hi, lo_lo);
    wh[cc * ldx + ci] = hi;
    wl[cc * ldx + ci] = lo_hi;
  }
}

// The expand weights of channels [c0, c0 + 32) into ws, the expand bias
// into bes.  The caller's next barrier publishes them.
template <typename T, int K, bool EXPAND, bool MMA, int XB>
__device__ __forceinline__ void stage_weights(
    const T* __restrict__ we, const float* __restrict__ be, char* smem,
    const Smem<K, EXPAND, MMA, XB>& L, int cin, int E, int c0) {
  if constexpr (XB == 4 || XB == 5) {
    stage_weights_tf32(we, reinterpret_cast<uint32_t*>(smem + L.ws), L.ldx,
                       L.cin16, cin, E, c0);
  } else if constexpr (MMA) {
    __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
    // Lanes on consecutive output channels: coalesced 64-byte reads.
    for (int idx = threadIdx.x; idx < CE * L.cin16; idx += NTHREADS) {
      const int cc = idx % CE, ci = idx / CE;
      T v = from_f32<T>(0.f);
      if (ci < cin && c0 + cc < E) v = we[(size_t)ci * E + c0 + cc];
      wsT[cc * L.ldx + ci] = v;
    }
  } else if constexpr (EXPAND) {
    float* ws = reinterpret_cast<float*>(smem + L.ws);
    const int cin4 = (cin + 3) / 4 * 4;
    for (int idx = threadIdx.x; idx < cin4 * CE; idx += NTHREADS) {
      const int cc = idx % CE, ci = idx / CE;
      float v = 0.f;
      if (ci < cin && c0 + cc < E) v = to_f32(we[(size_t)ci * E + c0 + cc]);
      ws[idx] = v;
    }
  }
  float* bes = reinterpret_cast<float*>(smem + L.bes);
  if (threadIdx.x < CE)
    bes[threadIdx.x] = (be != nullptr && c0 + (int)threadIdx.x < E)
                           ? be[c0 + threadIdx.x]
                           : 0.f;
}

// The bf16 x halo of output tile (ty0, tx0) of image n into xs (MMA only),
// channels past C_in zero.  NHWC x: [pixel][ldx], one TMA box of (ldx
// channels from ch0, halo columns, halo rows) from xmap (kCSplit: one
// chunk, ldx = ldxs), zeros outside the image,
// completing on bar (wait_x then reflects the image's edges); rows past
// the halo are not written (they feed only dropped outputs).  (N, H, C, W)
// x with kXBox: [halo row][cin16][BW], one TMA box of (BW columns, cin16
// channels from ch0, halo rows) from make_xt_map's map, completing on bar
// (wait_xt reflects); kXSplit passes a half's channel count as cin16.
// (N, H, C, W) x otherwise: [pixel][ldx], plain loads and stores,
// reflected here.  xs must be free (the previous expand has ended).
template <typename T, int K, int MODE>
__device__ __forceinline__ void stage_x(const CUtensorMap* xmap,
                                        uint64_t* bar,
                                        const T* __restrict__ xn,
                                        __nv_bfloat16* xs, int ldx,
                                        int cin16, int H, int W, int cin,
                                        int n, int ty0, int tx0,
                                        int ch0 = 0) {
  using G = Halo<K>;
  constexpr int P = G::P, HW = G::HW, HP = G::HP;
  if constexpr ((MODE & kXT) == 0) {
    if (threadIdx.x == 0) {
      fence_proxy_async();  // this thread's earlier writes of xs come first
      mbar_expect_tx(bar, HP * ldx * 2);
      tma_load_4d(xs, xmap, ch0, tx0 - P, ty0 - P, n, bar);
    }
  } else if constexpr ((MODE & kXBox) != 0) {
    if (threadIdx.x == 0) {
      fence_proxy_async();
      mbar_expect_tx(bar, G::HH * cin16 * G::BW * 2);
      tma_load_4d(xs, xmap, tx0 - P, ch0, ty0 - P, n, bar);
    }
  } else {
    // One thread per (channel, halo row), lanes on consecutive channels, so
    // the transposing stores are conflict-free.  The 16 interior columns
    // come as two 16-byte loads where the tile lies inside the image and
    // W % 8 == 0 (every block of the model), the 2p reflected edge columns
    // one by one; all loads are issued before the stores.
    constexpr int HH = G::HH;
    const bool vec = W % 8 == 0 && tx0 + TW <= W &&
                     (reinterpret_cast<uintptr_t>(xn) & 15) == 0;
    for (int pr = threadIdx.x; pr < cin16 * HH; pr += NTHREADS) {
      const int q = pr % cin16, hr = pr / cin16;
      __nv_bfloat16* dst = xs + hr * HW * ldx + q;  // column c: c * ldx
      if (q >= cin) {
#pragma unroll
        for (int col = 0; col < HW; ++col) dst[col * ldx] = from_f32<T>(0.f);
        continue;
      }
      const T* row = xn + ((size_t)reflect_idx(ty0 - P + hr, H) * cin + q) * W;
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
          dst[j * ldx] = edge[j];
          dst[(P + TW + j) * ldx] = edge[P + j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dst[(P + j) * ldx] = av[j];
          dst[(P + 8 + j) * ldx] = bv[j];
        }
      } else {
#pragma unroll
        for (int col = 0; col < HW; ++col)
          dst[col * ldx] = row[reflect_idx(tx0 - P + col, W)];
      }
    }
    // The rows of the last MMA tile past the halo feed only outputs that
    // are dropped; zero them all the same.
    for (int idx = threadIdx.x; idx < (G::MT * 16 - HP) * cin16;
         idx += NTHREADS)
      xs[(HP + idx / cin16) * ldx + idx % cin16] = from_f32<T>(0.f);
  }
}

// The reflected rows and columns of an NHWC halo box in xs ([pixel][ldx]
// elements of type E, HH x HW pixels from image row y0, column x0) that
// lie outside the image (torch ReflectionPad: -1 -> 1, H -> H - 2), copied
// from the rows and columns inside it, rows first, so the corners follow.
// Halo positions further out feed only dropped outputs and stay zero.  The
// caller's next barrier publishes xs.
template <int P, int HH, int HW, int BAR = 0, typename E = __nv_bfloat16>
__device__ __forceinline__ void reflect_box(E* xs, int ldx, int H, int W,
                                            int y0, int x0) {
  constexpr int EPV = 16 / (int)sizeof(E);  // elements per 16 bytes
  const bool top = y0 < 0, bottom = y0 + HH > H;
  const bool left = x0 < 0, right = x0 + HW > W;
  if (!(top || bottom || left || right)) return;  // uniform over the CTA
  const int vpp = ldx / EPV;  // 16-byte vectors per pixel
  uint4* v = reinterpret_cast<uint4*>(xs);
  // Halo row hr (image row y0 + hr) from its reflection, for the P rows
  // above row 0 and below row H - 1.
  for (int idx = threadIdx.x; idx < 2 * P * HW * vpp; idx += NTHREADS) {
    const int j = idx / (HW * vpp), rest = idx % (HW * vpp);
    const int y = j < P ? j - P : H + (j - P);  // -P..-1, H..H+P-1
    const int hr = y - y0, hs = reflect_idx(y, H) - y0;
    if (hr >= 0 && hr < HH && hs >= 0 && hs < HH)
      v[hr * HW * vpp + rest] = v[hs * HW * vpp + rest];
  }
  sweep_sync<BAR>();
  for (int idx = threadIdx.x; idx < 2 * P * HH * vpp; idx += NTHREADS) {
    const int j = idx / (HH * vpp), rest = idx % (HH * vpp);
    const int hr = rest / vpp, q = rest % vpp;
    const int x = j < P ? j - P : W + (j - P);
    const int hc = x - x0, hs = reflect_idx(x, W) - x0;
    if (hc >= 0 && hc < HW && hs >= 0 && hs < HW)
      v[(hr * HW + hc) * vpp + q] = v[(hr * HW + hs) * vpp + q];
  }
}

// Waits for stage_x's (or stage_x32's) NHWC TMA box (the barrier's phase
// parity), then reflects the image's edges into it (reflect_box).
template <int K, typename E = __nv_bfloat16>
__device__ __forceinline__ void wait_x(uint64_t* bar, uint32_t parity, E* xs,
                                       int ldx, int H, int W, int ty0,
                                       int tx0) {
  using G = Halo<K>;
  mbar_wait(bar, parity);
  reflect_box<G::P, G::HH, G::HW>(xs, ldx, H, W, ty0 - G::P, tx0 - G::P);
}

// kTf32's x box: ldxs f32 channels from ch0 of the halo of output tile
// (ty0, tx0) of image n into xs ([pixel][ldxs]), one TMA box from
// make_x_map's f32 map, zeros outside the image and past C_in, completing
// on bar (wait_x reflects); rows of the last MMA tile past the halo are
// not written (they feed only dropped outputs).  XT (with kXBox): `width`
// f32 channels from ch0 of make_xt_map's f32 map into xs ([halo row]
// [width][BW]; wait_xt reflects).  xs must be free.
template <int K, bool XT = false>
__device__ __forceinline__ void stage_x32(const CUtensorMap* xmap,
                                          uint64_t* bar, float* xs, int width,
                                          int n, int ty0, int tx0, int ch0) {
  using G = Halo<K>;
  if (threadIdx.x == 0) {
    fence_proxy_async();  // this thread's earlier writes of xs come first
    if constexpr (XT) {
      mbar_expect_tx(bar, G::HH * width * G::BW * 4);
      tma_load_4d(xs, xmap, tx0 - G::P, ch0, ty0 - G::P, n, bar);
    } else {
      mbar_expect_tx(bar, G::HP * width * 4);
      tma_load_4d(xs, xmap, ch0, tx0 - G::P, ty0 - G::P, n, bar);
    }
  }
}

// wait_x for kXBox's box ([halo row][cin16][BW] elements of type E):
// whole channel planes for the rows, single values for the columns, rows
// first.
template <int K, typename E = __nv_bfloat16>
__device__ __forceinline__ void wait_xt(uint64_t* bar, uint32_t parity,
                                        E* xs, int cin16, int H, int W,
                                        int ty0, int tx0) {
  using G = Halo<K>;
  constexpr int P = G::P, HH = G::HH, HW = G::HW, BW = G::BW;
  mbar_wait(bar, parity);
  const int y0 = ty0 - P, x0 = tx0 - P;
  const bool top = y0 < 0, bottom = y0 + HH > H;
  const bool left = x0 < 0, right = x0 + HW > W;
  if (!(top || bottom || left || right)) return;  // uniform over the CTA
  // 16-byte vectors per halo row
  const int vpr = cin16 * BW / (16 / (int)sizeof(E));
  uint4* v = reinterpret_cast<uint4*>(xs);
  for (int idx = threadIdx.x; idx < 2 * P * vpr; idx += NTHREADS) {
    const int j = idx / vpr, rest = idx % vpr;
    const int y = j < P ? j - P : H + (j - P);
    const int hr = y - y0, hs = reflect_idx(y, H) - y0;
    if (hr >= 0 && hr < HH && hs >= 0 && hs < HH)
      v[hr * vpr + rest] = v[hs * vpr + rest];
  }
  __syncthreads();
  if (!(left || right)) return;
  // The 2P columns' targets and sources are the same in every (row,
  // channel) line: a thread copies all of them for its lines.
  int hc[2 * P], hs[2 * P];
#pragma unroll
  for (int j = 0; j < 2 * P; ++j) {
    const int x = j < P ? j - P : W + (j - P);
    hc[j] = x - x0;
    hs[j] = reflect_idx(x, W) - x0;
    if (hc[j] < 0 || hc[j] >= HW || hs[j] < 0 || hs[j] >= HW) hc[j] = -1;
  }
  for (int row = threadIdx.x; row < HH * cin16; row += NTHREADS) {
    E* line = xs + row * BW;
#pragma unroll
    for (int j = 0; j < 2 * P; ++j)
      if (hc[j] >= 0) line[hc[j]] = line[hs[j]];
  }
}

// One warp's product of a 16-row tile of x (its A fragments from
// aload(a, ks) at channel ks) by 8-channel columns [nt0, nt0 + NTN) of the
// chunk's expand weights wsT, on the tensor cores; then store(r, col, v0,
// v1) for tile row r and channels col, col + 1 (f32 sums).  B fragments by
// ldmatrix: lane l gives channel row 8 * (l / 16) + l % 8 at k offset
// 8 * ((l / 8) % 2) (two 8-channel columns; x2 takes lanes 0-15); rows
// ldx * 2 bytes apart (an odd multiple of 16 modulo 128 for every C_in)
// meet no bank conflict.
template <int NTN, typename ALoad, typename Store>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* wsT, int ldx,
                                         int cin16, int nt0, ALoad aload,
                                         Store store) {
  static_assert(NTN == 1 || NTN % 2 == 0, "B columns come in pairs");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  float acc[NTN][4];
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  const __nv_bfloat16* bp =
      wsT + (nt0 * 8 + (lane >> 4) * 8 + (lane & 7)) * ldx +
      ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < cin16; ks += 16) {
    uint32_t a[4];
    aload(a, ks);
    if constexpr (NTN == 1) {
      uint32_t b[2];
      ldmatrix_x2(b, bp + ks);
      mma_bf16(acc[0], a, b);
    } else {
#pragma unroll
      for (int i = 0; i < NTN; i += 2) {
        uint32_t b[4];  // columns i and i + 1, k 0-7 and 8-15 of each
        ldmatrix_x4(b, bp + i * 8 * ldx + ks);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(acc[i], a, b0);
        mma_bf16(acc[i + 1], a, b1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      store(g + half * 8, (nt0 + i) * 8 + tig * 2, acc[i][2 * half],
            acc[i][2 * half + 1]);
}

// The expand's epilogue of halo pixel p, channels col and col + 1: the
// bias, hswish and (ROUND_EX) the rounding, then one 8-byte store into buf
// at the swizzled channel (conflict-free: within a half-warp the four
// pixels p % 4 land 8 banks apart).
template <typename T, bool ROUND_EX>
__device__ __forceinline__ void store_ex(float* buf, const float* bes,
                                         int pre_act, int p, int col,
                                         float v0, float v1) {
  v0 += bes[col];
  v1 += bes[col + 1];
  if (pre_act) {
    v0 = hswish(v0);
    v1 = hswish(v1);
  }
  if (ROUND_EX) {
    v0 = round_to<T>(v0);
    v1 = round_to<T>(v1);
  }
  *reinterpret_cast<float2*>(&buf[p * CE + (col ^ swz(p))]) =
      make_float2(v0, v1);
}

// One pass of an expand whose K comes in parts (kXSplit's halves,
// kCSplit's chunks): PASS 1 (the first part) stores its f32 sums v0, v1 in
// buf as the partial sums of pixel p, channels col, col + 1; PASS 3 (a
// middle part) adds them to the partial sums; PASS 2 (the last) adds the
// partial sums and runs the epilogue (store_ex); PASS 0 (the whole K) the
// epilogue alone.
template <typename T, bool ROUND_EX, int PASS>
__device__ __forceinline__ void store_pass(float* buf, const float* bes,
                                           int pre_act, int p, int col,
                                           float v0, float v1) {
  float2* part = reinterpret_cast<float2*>(&buf[p * CE + (col ^ swz(p))]);
  if constexpr (PASS == 2 || PASS == 3) {
    const float2 a = *part;
    v0 += a.x;
    v1 += a.y;
  }
  if constexpr (PASS == 1 || PASS == 3)
    *part = make_float2(v0, v1);
  else
    store_ex<T, ROUND_EX>(buf, bes, pre_act, p, col, v0, v1);
}

// The epilogue of one warp's expand of 16-row tile mt, 8-channel columns
// [nt0, nt0 + NTN): acc in the mma fragment layout (rows g, g + 8;
// channels 2t, 2t + 1 of each column).  PASS 0: the bias, hswish and
// (ROUND_EX) the rounding, then 8-byte stores into buf at the swizzled
// channel (conflict-free: within a half-warp the four rows g % 4 land 8
// banks apart); otherwise store_pass.  Rows past the halo's hp pixels are
// dropped.
template <typename T, int NTN, bool ROUND_EX, int PASS>
__device__ __forceinline__ void store_mtile(const float (&acc)[NTN][4],
                                            const float* bes, float* buf,
                                            int mt, int nt0, int pre_act,
                                            int hp) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  if constexpr (PASS != 0) {
#pragma unroll
    for (int i = 0; i < NTN; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + half * 8;
        if (row < hp)
          store_pass<T, ROUND_EX, PASS>(buf, bes, pre_act, row,
                                        (nt0 + i) * 8 + tig * 2,
                                        acc[i][2 * half],
                                        acc[i][2 * half + 1]);
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < NTN; ++i) {
    const int col = (nt0 + i) * 8 + tig * 2;
    const float b0 = bes[col], b1 = bes[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + g + half * 8;
      if (row >= hp) continue;
      float v0 = acc[i][2 * half] + b0, v1 = acc[i][2 * half + 1] + b1;
      if (pre_act) {
        v0 = hswish(v0);
        v1 = hswish(v1);
      }
      if (ROUND_EX) {
        v0 = round_to<T>(v0);
        v1 = round_to<T>(v1);
      }
      *reinterpret_cast<float2*>(&buf[row * CE + (col ^ swz(row))]) =
          make_float2(v0, v1);
    }
  }
}

// One warp's expand of 16-row tile mt of the halo, 8-channel columns
// [nt0, nt0 + NTN) of the chunk, on the tensor cores, then its epilogue
// (store_mtile).  xs's rows are ldxa apart and hold the K columns
// [0, kext) of wsT, whose rows are ldx apart (the whole K: ldxa = ldx,
// kext = C_in16; kCSplit's chunk: the caller offsets wsT to the chunk's
// first channel; PASS: store_pass).
template <typename T, int NTN, bool ROUND_EX, int PASS = 0>
__device__ __forceinline__ void expand_mtile(const __nv_bfloat16* xs,
                                             int ldxa,
                                             const __nv_bfloat16* wsT,
                                             const float* bes, float* buf,
                                             int ldx, int kext, int mt,
                                             int nt0, int pre_act, int hp) {
  static_assert(NTN == 1 || NTN % 2 == 0, "B columns come in pairs");
  const int lane = threadIdx.x & 31;
  float acc[NTN][4];
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  // ldmatrix addresses: lane l gives halo row l % 16 at k offset
  // 8 * (l / 16) (A), and channel row 8 * (l / 16) + l % 8 at k offset
  // 8 * ((l / 8) % 2) (B: two 8-channel columns; x2 takes lanes 0-15).
  // Rows ldx * 2 bytes apart (an odd multiple of 16 modulo 128 for every
  // C_in) meet no bank conflict.
  const __nv_bfloat16* ap =
      xs + (mt * 16 + (lane & 15)) * ldxa + (lane >> 4) * 8;
  const __nv_bfloat16* bp =
      wsT + (nt0 * 8 + (lane >> 4) * 8 + (lane & 7)) * ldx +
      ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < kext; ks += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, ap + ks);
    if constexpr (NTN == 1) {
      uint32_t b[2];
      ldmatrix_x2(b, bp + ks);
      mma_bf16(acc[0], a, b);
    } else {
#pragma unroll
      for (int i = 0; i < NTN; i += 2) {
        uint32_t b[4];  // columns i and i + 1, k 0-7 and 8-15 of each
        ldmatrix_x4(b, bp + i * 8 * ldx + ks);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(acc[i], a, b0);
        mma_bf16(acc[i + 1], a, b1);
      }
    }
  }
  store_mtile<T, NTN, ROUND_EX, PASS>(acc, bes, buf, mt, nt0, pre_act, hp);
}

// expand_mtile for kTf32: f32 x ([pixel][ldxa] words in xs) by the split
// weights (wh, wl: the chunk's K columns, rows ldx apart; stage_weights)
// as 3xTF32 on the tensor cores (mma.sync m16n8k8), over K columns
// [0, kext).  Each x value is split as its fragment is loaded (split_tf32:
// an integer add and a mask), and each k8 step takes three products, lo
// hi, hi lo and hi hi (the small terms first), each over all NTN columns
// before the next, so that no product waits on the one before it.  The
// tensor cores add in f32 rounding toward zero, so the products go into
// partials of TF_PAIR k8 steps from zero, each added to the accumulator in
// f32 to nearest (as gate_project_tf32 does in sweep 2;
// tests/test_torch_tf32_expand.py emulates this arithmetic).  A and B
// fragments by ldmatrix, an 8 x 8 b16 matrix being 8 rows of 4 f32: lane l
// gives halo row l % 16 at k offset 4 * (l / 16) (A: a0-a3 as mma_tf32
// takes them), and channel row 8 * (l / 16) + l % 8 at k offset
// 4 * ((l / 8) % 2) (B: b0, b1 of two columns; x2 takes lanes 0-15).  Rows
// an odd multiple of 16 bytes apart meet no bank conflict.  (Two tiles at
// a time, sharing the B fragments, spilled at k5 and ran slower there on
// an H100, and gained little at k3.)  Then store_mtile.  tf32_products
// forms the products into acc, its aload(a, ks) giving the A fragment of
// the k8 step at channel ks (expand_mtile_tf32_t's from the (N, H, C, W)
// box).
template <int NTN, typename ALoad>
__device__ __forceinline__ void tf32_products(float (&acc)[NTN][4],
                                              const uint32_t* wh,
                                              const uint32_t* wl, int ldx,
                                              int kext, int nt0,
                                              ALoad aload) {
  static_assert(NTN == 1 || NTN % 2 == 0, "B columns come in pairs");
  const int lane = threadIdx.x & 31;
  float part[NTN][4];
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  const int bo =
      (nt0 * 8 + (lane >> 4) * 8 + (lane & 7)) * ldx + ((lane >> 3) & 1) * 4;
  for (int ks = 0, step = 0; ks < kext; ks += 8, ++step) {
    if (step % TF_PAIR == 0) {
#pragma unroll
      for (int i = 0; i < NTN; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][r] = 0.f;
    }
    uint32_t a[4], ah[4], al[4];
    aload(a, ks);
#pragma unroll
    for (int m = 0; m < 4; ++m) split_tf32(__uint_as_float(a[m]), ah[m], al[m]);
    uint32_t bh[NTN][2], bl[NTN][2];
    if constexpr (NTN == 1) {
      ldmatrix_x2(bh[0], wh + bo + ks);
      ldmatrix_x2(bl[0], wl + bo + ks);
    } else {
#pragma unroll
      for (int i = 0; i < NTN; i += 2) {
        uint32_t b[4];  // columns i and i + 1: k 0-3 (b0) and 4-7 (b1)
        ldmatrix_x4(b, wh + bo + i * 8 * ldx + ks);
        bh[i][0] = b[0], bh[i][1] = b[1], bh[i + 1][0] = b[2],
        bh[i + 1][1] = b[3];
        ldmatrix_x4(b, wl + bo + i * 8 * ldx + ks);
        bl[i][0] = b[0], bl[i][1] = b[1], bl[i + 1][0] = b[2],
        bl[i + 1][1] = b[3];
      }
    }
#pragma unroll
    for (int i = 0; i < NTN; ++i) mma_tf32(part[i], al, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < NTN; ++i) mma_tf32(part[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < NTN; ++i) mma_tf32(part[i], ah, bh[i][0], bh[i][1]);
    if (step % TF_PAIR == TF_PAIR - 1 || ks + 8 >= kext) {
#pragma unroll
      for (int i = 0; i < NTN; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] += part[i][r];
    }
  }
}

template <typename T, int NTN, bool ROUND_EX, int PASS = 0>
__device__ __forceinline__ void expand_mtile_tf32(
    const float* xs, int ldxa, const uint32_t* wh, const uint32_t* wl,
    const float* bes, float* buf, int ldx, int kext, int mt, int nt0,
    int pre_act, int hp) {
  const int lane = threadIdx.x & 31;
  const float* ap = xs + (mt * 16 + (lane & 15)) * ldxa + (lane >> 4) * 4;
  float acc[NTN][4];
  tf32_products<NTN>(acc, wh, wl, ldx, kext, nt0,
                     [&](uint32_t(&a)[4], int ks) { ldmatrix_x4(a, ap + ks); });
  store_mtile<T, NTN, ROUND_EX, PASS>(acc, bes, buf, mt, nt0, pre_act, hp);
}

// expand_mtile_tf32 for kXBox's f32 box ([halo row][bch][BW] words): tile
// mt is the 8-pixel groups 2 mt and 2 mt + 1, as in expand_mtile_t, over
// the box's channels, which are the weights' K columns [kofs, kofs +
// kext) (the caller offsets wh, wl).  ldmatrix.trans moves 16-bit
// elements only, so each A value comes by a 32-bit load from its channel
// row: lane (g, t) reads a0 = pixel g of group 2 mt at channel ks + t, a1
// the same of group 2 mt + 1, a2 and a3 at channel ks + t + 4; its word
// (ks + t) * BW + 8 j + g lies in bank 24 t + g + const mod 32, 32
// distinct banks for each load.  Then store_pass per value (columns past
// the halo dropped).
template <typename T, int K, int NTN, bool ROUND_EX, int PASS>
__device__ __forceinline__ void expand_mtile_tf32_t(
    const float* xs, int bch, const uint32_t* wh, const uint32_t* wl,
    const float* bes, float* buf, int ldx, int kext, int mt, int nt0,
    int pre_act) {
  using G = Halo<K>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int g0 = 2 * mt, g1 = 2 * mt + 1;
  const float* a0 = xs + ((g0 / G::GPR) * bch + tig) * G::BW +
                    (g0 % G::GPR) * 8 + g;
  const float* a1 = xs + ((g1 / G::GPR) * bch + tig) * G::BW +
                    (g1 % G::GPR) * 8 + g;
  float acc[NTN][4];
  tf32_products<NTN>(acc, wh, wl, ldx, kext, nt0,
                     [&](uint32_t(&a)[4], int ks) {
                       a[0] = __float_as_uint(a0[ks * G::BW]);
                       a[1] = __float_as_uint(a1[ks * G::BW]);
                       a[2] = __float_as_uint(a0[(ks + 4) * G::BW]);
                       a[3] = __float_as_uint(a1[(ks + 4) * G::BW]);
                     });
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int grp = 2 * mt + half;
      const int hc = (grp % G::GPR) * 8 + g;
      if (hc >= G::HW) continue;
      store_pass<T, ROUND_EX, PASS>(buf, bes, pre_act,
                                    (grp / G::GPR) * G::HW + hc,
                                    (nt0 + i) * 8 + tig * 2, acc[i][2 * half],
                                    acc[i][2 * half + 1]);
    }
}

// expand_mtile for kXBox's box ([halo row][bch][BW]): tile mt is the 8-
// pixel groups 2 mt and 2 mt + 1 (group gi: halo row gi / GPR, columns
// 8 (gi % GPR) + 0..7; columns past the halo dropped), over the box's bch
// channels, which are the weights' K columns [kofs, kofs + bch).  A
// fragments by ldmatrix.trans from the channel rows (BW * 2 = 48 bytes
// apart: conflict-free): lane l gives group 2 mt + (l / 8) % 2, channel
// 8 * (l / 16) + l % 8, so matrices 0-3 are the fragment's (rows 0-7 |
// 8-15) x (k 0-7 | 8-15).  PASS 0: the whole K; kXSplit's halves PASS 1
// and 2 (store_pass).
template <typename T, int K, int NTN, bool ROUND_EX, int PASS>
__device__ __forceinline__ void expand_mtile_t(const __nv_bfloat16* xs,
                                               const __nv_bfloat16* wsT,
                                               const float* bes, float* buf,
                                               int ldx, int bch, int kofs,
                                               int mt, int nt0, int pre_act) {
  using G = Halo<K>;
  const int lane = threadIdx.x & 31;
  const int gi = 2 * mt + ((lane >> 3) & 1);
  const __nv_bfloat16* ap =
      xs + ((gi / G::GPR) * bch + (lane >> 4) * 8 + (lane & 7)) * G::BW +
      (gi % G::GPR) * 8;
  mma_tile<NTN>(
      wsT + kofs, ldx, bch, nt0,
      [&](uint32_t(&a)[4], int ks) { ldmatrix_x4_trans(a, ap + ks * G::BW); },
      [&](int r, int col, float v0, float v1) {
        const int grp = 2 * mt + (r >> 3);
        const int hc = (grp % G::GPR) * 8 + (r & 7);
        if (hc >= G::HW) return;
        const int p = (grp / G::GPR) * G::HW + hc;
        store_pass<T, ROUND_EX, PASS>(buf, bes, pre_act, p, col, v0, v1);
      });
}

// The expanded halo of output tile (ty0, tx0) for the chunk whose weights
// stage_weights put in shared memory, into buf (f32, swizzled; rounded to T
// with kRoundEx).  MMA: the x halo is in xs (stage_x, stage_x32; the
// caller has waited for its copies); otherwise x is read here.  Starts and
// ends with a barrier (sweep_sync<BAR>).  EXPAND: a 1x1 expand precedes
// the depthwise; MMA: it runs on the tensor cores (bf16, or with kTf32
// f32 as 3xTF32).  PASS (store_pass): the part of K in xs, from the
// weights' channel kofs (kXSplit, kCSplit, kTf32's chunks).
template <typename T, int K, bool EXPAND, bool MMA, int MODE, int PASS = 0,
          int BAR = 0>
__device__ __forceinline__ void expand_halo(const T* __restrict__ xn,
                                            char* smem,
                                            const SmemM<K, EXPAND, MMA,
                                                        MODE>& L,
                                            int H, int W, int cin,
                                            int pre_act, int ty0, int tx0,
                                            int kofs = 0) {
  using G = Halo<K>;
  constexpr int P = G::P, HW = G::HW, HP = G::HP;
  constexpr bool XT = (MODE & kXT) != 0;
  constexpr bool ROUND_EX = (MODE & kRoundEx) != 0;
  static_assert(EXPAND, "expand==1 takes expand_halo_identity");
  float* buf = reinterpret_cast<float*>(smem);
  const float* bes = reinterpret_cast<const float*>(smem + L.bes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  sweep_sync<BAR>();  // x and the weights are staged; buf's readers are done
  if constexpr ((MODE & kTf32) != 0) {
    // As the bf16 expand below divides its tiles among the warps; the
    // chunk's K columns [kofs, kofs + kext).
    const float* xs = reinterpret_cast<const float*>(smem + L.xs);
    const uint32_t* wh = reinterpret_cast<const uint32_t*>(smem + L.ws);
    const uint32_t* wl = wh + CE * L.ldx;
    const int kext = min(L.bch, L.cin16 - kofs);
    constexpr bool XBOX = (MODE & kXBox) != 0;
    constexpr int MT = XBOX ? G::MTB : G::MT;
    constexpr int ROUNDS = MT / NWARPS;
    constexpr int LEFT = (MT - ROUNDS * NWARPS) * (CE / 8);
    auto tile = [&](auto ntn, int mt, int nt0) {
      constexpr int NTN = decltype(ntn)::value;
      if constexpr (XBOX)
        expand_mtile_tf32_t<T, K, NTN, ROUND_EX, PASS>(
            xs, L.bch, wh + kofs, wl + kofs, bes, buf, L.ldx, kext, mt, nt0,
            pre_act);
      else
        expand_mtile_tf32<T, NTN, ROUND_EX, PASS>(
            xs, L.ldxs, wh + kofs, wl + kofs, bes, buf, L.ldx, kext, mt, nt0,
            pre_act, HP);
    };
    for (int i = 0; i < ROUNDS; ++i)
      tile(std::integral_constant<int, CE / 8>{}, warp + i * NWARPS, 0);
    for (int u = warp; u < LEFT; u += NWARPS)
      tile(std::integral_constant<int, 1>{}, ROUNDS * NWARPS + u / (CE / 8),
           u % (CE / 8));
  } else if constexpr (MMA) {
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.xs);
    const __nv_bfloat16* wsT =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.ws);
    // Warp w takes the 16-row tiles w, w + 8, ... as whole tiles (32
    // channels); the tiles left over after whole rounds of 8 are split by
    // 8-channel column, one per warp in turn, so no warp does a whole
    // extra tile (k5: 25 tiles, 30 from the (N, H, C, W) box).
    constexpr bool XBOX = (MODE & kXBox) != 0;
    constexpr int MT = XBOX ? G::MTB : G::MT;
    constexpr int ROUNDS = MT / NWARPS;
    constexpr int LEFT = (MT - ROUNDS * NWARPS) * (CE / 8);
    auto tile = [&](auto ntn, int mt, int nt0) {
      constexpr int NTN = decltype(ntn)::value;
      if constexpr (XBOX)
        expand_mtile_t<T, K, NTN, ROUND_EX, PASS>(
            xs, wsT, bes, buf, L.ldx, L.bch, kofs, mt, nt0, pre_act);
      else
        expand_mtile<T, NTN, ROUND_EX, PASS>(xs, L.ldxs, wsT + kofs, bes,
                                             buf, L.ldx, L.bch, mt, nt0,
                                             pre_act, HP);
    };
    for (int i = 0; i < ROUNDS; ++i)
      tile(std::integral_constant<int, CE / 8>{}, warp + i * NWARPS, 0);
    for (int u = warp; u < LEFT; u += NWARPS)
      tile(std::integral_constant<int, 1>{}, ROUNDS * NWARPS + u / (CE / 8),
           u % (CE / 8));
  } else {
    constexpr int NPX = (HP + NWARPS - 1) / NWARPS;  // halo pixels per warp
    const float* ws = reinterpret_cast<const float*>(smem + L.ws);
    float acc[NPX];
#pragma unroll
    for (int i = 0; i < NPX; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += CK) {
      const int kc = min(CK, cin - k0);
      if (k0 > 0) sweep_sync<BAR>();  // the previous step's readers are done
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
      sweep_sync<BAR>();
      const int kc4 = (kc + 3) & ~3;  // staged tail channels are zero
      for (int ci = 0; ci < kc4; ci += 4) {
        const float w0 = ws[(k0 + ci + 0) * CE + lane];
        const float w1 = ws[(k0 + ci + 1) * CE + lane];
        const float w2 = ws[(k0 + ci + 2) * CE + lane];
        const float w3 = ws[(k0 + ci + 3) * CE + lane];
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
    sweep_sync<BAR>();  // every read of the staged x is done
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int p = warp + i * NWARPS;
      if (p < HP) {
        float v = acc[i] + bes[lane];
        if (pre_act) v = hswish(v);
        buf[p * CE + (lane ^ swz(p))] = ROUND_EX ? round_to<T>(v) : v;
      }
    }
  }
  sweep_sync<BAR>();
}

// expand==1 (E == cin): the halo of x's channels [c0, c0 + 32) plus the
// bias, into buf.  Starts and ends with a barrier.
template <typename T, int K, int MODE>
__device__ __forceinline__ void expand_halo_identity(
    const T* __restrict__ xn, char* smem, const float* bes, int H, int W,
    int cin, int pre_act, int ty0, int tx0, int c0) {
  using G = Halo<K>;
  constexpr int P = G::P, HW = G::HW, HP = G::HP;
  constexpr bool XT = (MODE & kXT) != 0;
  constexpr bool ROUND_EX = (MODE & kRoundEx) != 0;
  float* buf = reinterpret_cast<float*>(smem);
  __syncthreads();
  for (int idx = threadIdx.x; idx < HP * CE; idx += NTHREADS) {
    const int p = idx / CE, cc = idx % CE;
    float v = 0.f;
    if (c0 + cc < cin) {
      const int gy = reflect_idx(ty0 - P + p / HW, H);
      const int gx = reflect_idx(tx0 - P + p % HW, W);
      v = to_f32(x_at<T, XT>(xn, gy, gx, c0 + cc, W, cin)) + bes[cc];
      if (pre_act) v = hswish(v);
    }
    buf[p * CE + (cc ^ swz(p))] = ROUND_EX ? round_to<T>(v) : v;
  }
  __syncthreads();
}

// First output row and column of this thread's depthwise block.
__device__ __forceinline__ int dw_row0() {
  return (threadIdx.x >> 5) / (TW / DW_COLS) * DW_ROWS;
}
__device__ __forceinline__ int dw_col0() {
  return (threadIdx.x >> 5) % (TW / DW_COLS) * DW_COLS;
}

// The depthwise weights of channel c (0 past E) and its bias.
template <int K>
__device__ __forceinline__ void load_dw(const float* __restrict__ wd,
                                        const float* __restrict__ bd, int E,
                                        int c, float (&wk)[K * K],
                                        float& bdv) {
  const bool c_ok = c < E;
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = c_ok ? wd[(size_t)t * E + c] : 0.f;
  bdv = (bd != nullptr && c_ok) ? bd[c] : 0.f;
}

// Depthwise over the expanded halo in buf for the lane's channel:
// o[r][j] = hswish(dw + bd) in f32 at output row dw_row0() + r, column
// dw_col0() + j of the 16x16 tile.  Each output sums its k*k taps in
// row-major order (row di, then column dj), one fmaf each.  Only reads
// buf; the caller masks the ragged edge and channels past E.
template <int K>
__device__ __forceinline__ void depthwise_tile(const float* buf,
                                               const float (&wk)[K * K],
                                               float bdv,
                                               float (&o)[DW_ROWS][DW_COLS]) {
  constexpr int HW = Halo<K>::HW;
  const int lane = threadIdx.x & 31;
  const float* base = buf + (dw_row0() * HW + dw_col0()) * CE;
  int sw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sw[q] = lane ^ (q << 3);
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j) o[r][j] = 0.f;
#pragma unroll
  for (int hr = 0; hr < DW_ROWS + K - 1; ++hr) {
#pragma unroll
    for (int hc = 0; hc < DW_COLS + K - 1; ++hc) {
      const int p = hr * HW + hc;  // relative to the block's first pixel
      const float v = base[p * CE + sw[p & 3]];
#pragma unroll
      for (int j = 0; j < DW_COLS; ++j) {
        const int dj = hc - j;
        if (dj < 0 || dj >= K) continue;
#pragma unroll
        for (int r = 0; r < DW_ROWS; ++r) {
          const int di = hr - r;
          if (di >= 0 && di < K) o[r][j] = fmaf(v, wk[di * K + dj], o[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j) o[r][j] = hswish(o[r][j] + bdv);
}

// The SE sums of this CTA's tiles of image n: the 8 warps' partials per
// channel reduced in shared memory, one atomic each.
__device__ __forceinline__ void flush_sums(float csum, float* red,
                                           float* __restrict__ sums, int n,
                                           int E, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous flush's reads are done
  red[warp * 32 + lane] = csum;
  __syncthreads();
  if (warp == 0 && c < E) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < NWARPS; ++w8) s += red[w8 * 32 + lane];
    atomicAdd(&sums[(size_t)n * E + c], s);
  }
}

// xmap: x as make_x_map's map (NHWC x with the tensor-core expand) or
// make_xt_map's (kXBox); unused otherwise.  tbch: kTf32's channels per box
// (tf32_chunk); unused otherwise.
template <typename T, int K, bool EXPAND, bool MMA, int MODE>
__global__ void __launch_bounds__(NTHREADS, MMA ? 2 : 1)
    expand_dw_kernel(const __grid_constant__ CUtensorMap xmap,
                     const T* __restrict__ x, const T* __restrict__ we,
                     const float* __restrict__ wd,
                     const float* __restrict__ be,
                     const float* __restrict__ bd, T* __restrict__ hidden,
                     float* __restrict__ sums, int N, int H, int W, int cin,
                     int E, int pre_act, int tiles_x, int tiles_per_image,
                     int tbch) {
  // The x halo as a TMA box, prefetched for the next tile.
  constexpr bool ASYNC = MMA && ((MODE & kXT) == 0 || (MODE & kXBox) != 0);
  constexpr bool TF = (MODE & kTf32) != 0;
  constexpr int VEC = 16 / (int)sizeof(T);  // values per 16 bytes
  char* smem = smem_base();
  const SmemM<K, EXPAND, MMA, MODE> L(cin, tbch);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  float* buf = reinterpret_cast<float*>(smem);
  T* hs = reinterpret_cast<T*>(smem);  // the tile's hidden, [256][32]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  [[maybe_unused]] float* xs32 = reinterpret_cast<float*>(smem + L.xs);
  // kTf32's box of channels from ch0 (the NHWC one or, with kXBox, the
  // (N, H, C, W) one) and its wait and edge copies.
  constexpr bool XBOX = (MODE & kXBox) != 0;
  [[maybe_unused]] auto stage_tf = [&](int n, int ty0, int tx0, int ch0) {
    stage_x32<K, XBOX>(&xmap, xbar, xs32, XBOX ? L.bch : L.ldxs, n, ty0, tx0,
                       ch0);
  };
  [[maybe_unused]] auto wait_tf = [&](uint32_t parity, int ty0, int tx0) {
    if constexpr (XBOX)
      wait_xt<K>(xbar, parity, xs32, L.bch, H, W, ty0, tx0);
    else
      wait_x<K>(xbar, parity, xs32, L.ldxs, H, W, ty0, tx0);
  };

  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * CE;
  const int c = c0 + lane;
  const bool c_ok = c < E;
  // The CTA's items: every gridDim.x-th, or (kXBox) one contiguous run,
  // whose few tiles at the image's left and right edges (two per row of
  // the shifted grid, with the column copies of wait_xt) fall to every CTA
  // alike (strided, a grid of tiles_x CTAs per chunk gave them all to two).
  constexpr bool RUN = (MODE & kXBox) != 0;
  const int total = N * tiles_per_image;
  const int step = RUN ? 1 : gridDim.x;
  int item = RUN ? (int)((long long)blockIdx.x * total / gridDim.x)
                 : blockIdx.x;
  const int end = RUN ? (int)((long long)(blockIdx.x + 1) * total /
                              gridDim.x)
                      : total;
  if (item >= end) return;

  stage_weights<T, K, EXPAND, MMA>(we, be, smem, L, cin, E, c0);
  float wk[K * K], bdv;
  load_dw<K>(wd, bd, E, c, wk, bdv);
  auto image_of = [&](int it) { return it / tiles_per_image; };
  auto tile_origin = [&](int it, int& ty0, int& tx0) {
    const int t = it % tiles_per_image;
    ty0 = (t / tiles_x) * TH;
    tx0 = (t % tiles_x) * TW + XSHIFT<K, MODE>;
  };
  uint32_t xphase = 0;
  if constexpr (ASYNC) {
    if (threadIdx.x == 0) {
      mbar_init(xbar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    int ty0, tx0;
    tile_origin(item, ty0, tx0);
    if constexpr (TF)
      stage_tf(image_of(item), ty0, tx0, 0);
    else
      stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ldxs, L.bch, H, W, cin,
                          image_of(item), ty0, tx0);
  }
  const bool vec_out = E % VEC == 0 &&
                       (reinterpret_cast<uintptr_t>(hidden) & 15) == 0;
  const int oy0 = dw_row0(), ox0 = dw_col0();
  int n_cur = image_of(item);
  float csum = 0.f;

  for (; item < end; item += step) {
    const int n = image_of(item);
    int ty0, tx0;
    tile_origin(item, ty0, tx0);
    if (n != n_cur) {
      flush_sums(csum, reinterpret_cast<float*>(smem + L.red), sums, n_cur,
                 E, c);
      csum = 0.f;
      n_cur = n;
    }
    const T* xn = x + (size_t)n * H * W * cin;
    if constexpr (!EXPAND) {
      expand_halo_identity<T, K, MODE>(
          xn, smem, reinterpret_cast<const float*>(smem + L.bes), H, W, cin,
          pre_act, ty0, tx0, c0);
    } else {
      if constexpr (ASYNC) {
        if constexpr (TF)
          wait_tf(xphase, ty0, tx0);
        else if constexpr (XBOX)
          wait_xt<K>(xbar, xphase, xs, L.bch, H, W, ty0, tx0);
        else
          wait_x<K>(xbar, xphase, xs, L.ldxs, H, W, ty0, tx0);
        xphase ^= 1;
      } else if constexpr (MMA) {
        stage_x<T, K, MODE>(&xmap, xbar, xn, xs, L.ldxs, L.bch, H, W, cin,
                            n, ty0, tx0);
      }
      if constexpr (TF) {
        // As kCSplit below, in the chunks of tf32_chunk (one where the
        // whole box fits beside two CTAs per SM).
        if (L.bch >= L.cin16) {
          expand_halo<T, K, EXPAND, MMA, MODE>(xn, smem, L, H, W, cin,
                                               pre_act, ty0, tx0);
        } else {
          expand_halo<T, K, EXPAND, MMA, MODE, 1>(xn, smem, L, H, W, cin,
                                                  pre_act, ty0, tx0);
          for (int ch0 = L.bch; ch0 < L.cin16; ch0 += L.bch) {
            stage_tf(n, ty0, tx0, ch0);
            wait_tf(xphase, ty0, tx0);
            xphase ^= 1;
            if (ch0 + L.bch < L.cin16)
              expand_halo<T, K, EXPAND, MMA, MODE, 3>(xn, smem, L, H, W, cin,
                                                      pre_act, ty0, tx0, ch0);
            else
              expand_halo<T, K, EXPAND, MMA, MODE, 2>(xn, smem, L, H, W, cin,
                                                      pre_act, ty0, tx0, ch0);
          }
        }
      } else if constexpr (MMA && (MODE & kXSplit) != 0) {
        // The first channel half's partial sums, then the second half's box
        // (its load not hidden: the price of two CTAs per SM at C_in >= 80).
        expand_halo<T, K, EXPAND, MMA, MODE, 1>(xn, smem, L, H, W, cin,
                                                pre_act, ty0, tx0);
        stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ldxs, L.bch, H, W, cin, n,
                            ty0, tx0, L.bch);
        wait_xt<K>(xbar, xphase, xs, L.bch, H, W, ty0, tx0);
        xphase ^= 1;
        expand_halo<T, K, EXPAND, MMA, MODE, 2>(xn, smem, L, H, W, cin,
                                                pre_act, ty0, tx0, L.bch);
      } else if constexpr (MMA && (MODE & kCSplit) != 0) {
        // Chunk 0's partial sums, then each further chunk's box (its load
        // not hidden), its products added; the last one's epilogue.
        expand_halo<T, K, EXPAND, MMA, MODE, 1>(xn, smem, L, H, W, cin,
                                                pre_act, ty0, tx0);
        for (int ch0 = L.bch; ch0 < L.cin16; ch0 += L.bch) {
          stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ldxs, L.bch, H, W, cin,
                              n, ty0, tx0, ch0);
          wait_x<K>(xbar, xphase, xs, L.ldxs, H, W, ty0, tx0);
          xphase ^= 1;
          if (ch0 + L.bch < L.cin16)
            expand_halo<T, K, EXPAND, MMA, MODE, 3>(xn, smem, L, H, W, cin,
                                                    pre_act, ty0, tx0, ch0);
          else
            expand_halo<T, K, EXPAND, MMA, MODE, 2>(xn, smem, L, H, W, cin,
                                                    pre_act, ty0, tx0, ch0);
        }
      } else {
        expand_halo<T, K, EXPAND, MMA, MODE>(xn, smem, L, H, W, cin, pre_act,
                                             ty0, tx0);
      }
      if constexpr (ASYNC) {
        // The next tile's x halo comes in while this one's depthwise runs.
        const int next = item + step;
        if (next < end) {
          int ny0, nx0;
          tile_origin(next, ny0, nx0);
          if constexpr (TF)
            stage_tf(image_of(next), ny0, nx0, 0);
          else
            stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ldxs, L.bch, H, W, cin,
                                image_of(next), ny0, nx0);
        }
      }
    }
    // kXSplit (k5 C_in 96 spilled 12 B with them live through both
    // passes), kCSplit and kTf32: the depthwise weights come back from L1
    // for each tile.
    if constexpr ((MODE & (kXSplit | kCSplit | kTf32)) != 0)
      load_dw<K>(wd, bd, E, c, wk, bdv);
    float o[DW_ROWS][DW_COLS];
    depthwise_tile<K>(buf, wk, bdv, o);
    // The SE sums (only a tile at the image's lower or right edge masks)
    // and the tile's hidden, staged in buf once every read of it is done.
    constexpr bool STORE = (MODE & kNoHidden) == 0;
    constexpr bool SHIFT = XSHIFT<K, MODE> != 0;  // tiles start left of 0
    const bool full = ty0 + TH <= H && (!SHIFT || tx0 >= 0) && tx0 + TW <= W;
    if constexpr (STORE) __syncthreads();
#pragma unroll
    for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < DW_COLS; ++j) {
        const T hv = from_f32<T>(o[r][j]);
        if (c_ok && (full || (ty0 + oy0 + r < H &&
                              (!SHIFT || tx0 + ox0 + j >= 0) &&
                              tx0 + ox0 + j < W)))
          csum += (MODE & kSumRounded) ? to_f32(hv) : o[r][j];
        if constexpr (STORE) hs[((oy0 + r) * TW + ox0 + j) * CE + lane] = hv;
      }
    if constexpr (STORE) {
      __syncthreads();
      // 16-byte stores: a pixel's 32 channels are CE / VEC vectors.
      constexpr int VPP = CE / VEC;
      for (int idx = threadIdx.x; idx < TH * TW * VPP; idx += NTHREADS) {
        const int p = idx / VPP, cc = (idx % VPP) * VEC;
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        if (gy >= H || (SHIFT && gx < 0) || gx >= W || c0 + cc >= E)
          continue;
        T* dst = hidden + ((size_t)n * H * W + (size_t)gy * W + gx) * E + c0 +
                 cc;
        const T* src = hs + p * CE + cc;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < VEC && c0 + cc + j < E; ++j) dst[j] = src[j];
        }
      }
    }
  }
  flush_sums(csum, reinterpret_cast<float*>(smem + L.red), sums, n_cur, E,
             c);
}

// The dynamic shared memory a CTA may have on this device (an H100:
// 232,448 bytes; common.cuh smem_limits), the one limit every launcher
// here and in flat_s2.cu and fused_2pass.cu checks against.
inline int max_smem() {
  int cta = 0, sm = 0, reserved = 0;
  smem_limits(cta, sm, reserved);
  return cta;
}

// Whether a sweep-1 x box of `ldx` elements per pixel, in a kernel of
// `total` bytes of shared memory, must come in channel chunks: it is wider
// than a TMA box may be, or the kernel with it would not fit in a CTA.
// c_split (here), flat_s2.cu's s2_split and fused_2pass.cu's tile_split
// pass their own layouts' sizes; ops/kernels/limits.py mirrors the rule.
inline bool box_split(int ldx, int total) {
  return ldx > kMaxBox || total > max_smem();
}

// 1 if the last launch of this source's kernels staged x as a TMA box
// (asynchronously), 0 if with plain loads, -1 before any launch.
inline int& last_async() {
  static int v = -1;
  return v;
}

// The boxes per halo of the last launch of this source's kernels: 1 (the
// whole box, or none), 2 (kXSplit's halves), C_in16 / CCH (kCSplit) or
// kTf32's chunks; -1 before any launch.
inline int& last_boxes() {
  static int v = -1;
  return v;
}

// The sweep-1 design of the last launch of this source's kernels: 0 the
// CUDA-core expand (or none: expand==1), 1 the bf16 tensor-core expand, 2
// the 3xTF32 one (kTf32); -1 before any launch.
inline int& last_design() {
  static int v = -1;
  return v;
}

// tbch: kTf32's channels per box (tf32_chunk); unused otherwise.
template <typename T, int K, bool EXPAND, bool MMA, int MODE>
cudaError_t launch(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, void* hidden, void* sums,
                   int n, int h, int w, int cin, int e, int pre_act,
                   cudaStream_t stream, int tbch = 0) {
  constexpr bool ASYNC = MMA && ((MODE & kXT) == 0 || (MODE & kXBox) != 0);
  constexpr bool TF = (MODE & kTf32) != 0;
  const SmemM<K, EXPAND, MMA, MODE> L(cin, tbch);
  auto kernel = expand_dw_kernel<T, K, EXPAND, MMA, MODE>;
  CUtensorMap xmap{};
  if (ASYNC && !((MODE & kXT) != 0
                     ? make_xt_map<K>(&xmap, x, n, h, w, cin, L.bch, TF)
                     : make_x_map(&xmap, x, n, h, w, cin, Halo<K>::HW,
                                  Halo<K>::HH, L.ldxs, TF)))
    return cudaErrorInvalidValue;
  if (L.total > max_smem()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        NTHREADS, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (w - XSHIFT<K, MODE> + TW - 1) / TW;
  const int tiles_per_image = tiles_x * ((h + TH - 1) / TH);
  const int chunks = (e + CE - 1) / CE;
  const long long items = (long long)n * tiles_per_image;
  // Never more CTAs than fit at once: one CTA past that would run alone
  // after all the others, doubling the sweep.
  const int gx = (int)std::min<long long>(
      items, std::max(1, per_sm * sms / chunks));
  dim3 grid(gx, chunks);
  kernel<<<grid, NTHREADS, L.total, stream>>>(
      xmap, static_cast<const T*>(x), static_cast<const T*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<T*>(hidden),
      static_cast<float*>(sums), n, h, w, cin, e, pre_act, tiles_x,
      tiles_per_image, tbch);
  last_async() = ASYNC ? 1 : 0;
  last_boxes() = (MODE & kXSplit) != 0   ? 2
                 : (MODE & kCSplit) != 0 ? L.cin16 / L.bch
                 : TF                    ? (L.cin16 + L.bch - 1) / L.bch
                                         : 1;
  last_design() = TF ? 2 : MMA ? 1 : 0;
  return cudaGetLastError();
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of a
// kernel launched with `smem` bytes, into out[0..2].  Launches nothing.
// Past max_smem() it returns cudaErrorInvalidValue with out[1] = smem, and
// leaves the runtime's last error as it was.
template <typename Kernel>
cudaError_t query(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  out[1] = smem;
  if (smem > max_smem()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        threads, smem);
  out[0] = a.numRegs;
  return err;
}

// Whether kXBox's box comes in two channel halves: at C_in16 >= 64 (the
// model's 80 and 96) the whole box would leave one CTA per SM (k3 C_in 80:
// 117.5 KB; two need at most 115,712 B each), the halves two.
inline bool xt_split(int cin) { return (cin + 15) / 16 * 16 >= 64; }

// Whether NHWC x's box comes in chunks (kCSplit): where the whole box
// would be wider than a TMA box may be, or the kernel with it would need
// more shared memory than a CTA may have (k3: C_in above 240; k5: above
// 192).  ops/kernels/limits.py mirrors this rule and the Smem arithmetic.
template <int K>
bool c_split(int cin) {
  const Smem<K, true, true> whole(cin);
  return box_split(whole.ldx, whole.total);
}

// The channels per x box of a 3xTF32 sweep 1 for `want` CTAs per SM: the
// fewest chunks (ceil(C_in8 / n) channels, a multiple of 8) with which
// that many CTAs share an SM; 0 where none does.  bytes(b, dim): the
// CTA's shared memory with a box of b channels, and in dim the box's
// widest dimension (at most 256 elements).
template <typename Bytes>
int tf32_fit(int cin, int want, Bytes bytes) {
  const int cin8 = (cin + 7) / 8 * 8;
  int cta = 0, sm = 0, reserved = 0;
  smem_limits(cta, sm, reserved);
  for (int chunks = 1; chunks <= cin8 / 8; ++chunks) {
    const int b = ((cin8 + chunks - 1) / chunks + 7) / 8 * 8;
    int dim = 0;
    const int t = bytes(b, dim);
    if (!box_split(dim, t) && want * (t + reserved) <= sm) return b;
  }
  return 0;
}

// The channels per x box of a 3xTF32 sweep 1 (bytes: as tf32_fit's): sized
// for two CTAs per SM where that costs at most one chunk more than one
// CTA's fewest, else for one; 0 where no chunk fits (the CUDA-core expand
// takes the shape).  The rule of kTf32 (tf32_chunk), of kTf32 with kXBox
// and of flat_s2.cu's f32 sweep 1 (s2_tf32_chunk).
template <typename Bytes>
int tf32_sized(int cin, Bytes bytes) {
  const int one = tf32_fit(cin, 1, bytes), two = tf32_fit(cin, 2, bytes);
  const int cin8 = (cin + 7) / 8 * 8;
  const auto chunks = [&](int b) { return (cin8 + b - 1) / b; };
  return two > 0 && chunks(two) <= chunks(one) + 1 ? two : one;
}

// kTf32's channels per x box at this k and C_in (XB 4: NHWC x, the box's
// inner extent bch + 4; XB 5: kXBox's, bch channels of 24 columns):
// tf32_sized's rule.  On an H100 (scripts/sweep_ablation.py --f32, its
// cuts one_cta and two_cta), at k5 C_in 96 two CTAs in 6 chunks took
// 0.789 ms per d4 launch against one CTA's 0.723 in 2, at k3 C_in 80
// 1.538 in 3 against
// 1.452 in 1, while at k5 C_in 40 two in 2 chunks took 3.924 ms per d10
// launch against one's 4.490 in 1.  0 where no chunk fits (the CUDA-core
// expand takes the shape).  At the model's shapes: k3 C_in 16 and 24 the
// whole box, two CTAs; 80 the whole box, 128 two chunks of 64, 256 four
// of 64, one CTA; k5 C_in 40 two chunks of 24, two CTAs; 96 two of 48,
// one.  kXBox's f32 box at the model's shapes: above (the header).
// ops/kernels/limits.py mirrors the rule (tf32_chunk).
template <int K, int XB = 4>
int tf32_chunk(int cin) {
  return tf32_sized(cin, [&](int b, int& dim) {
    dim = XB == 4 ? b + 4 : b;
    return Smem<K, true, true, XB>(cin, b).total;
  });
}

// Whether f32 x takes kTf32 (given a chunk size).  NHWC x: its 16-byte TMA
// rows need C_in % 8 == 0 (as the bf16 design's, so that every k8 step is
// whole) and an aligned x: every NHWC block of the model.  (N, H, C, W) x
// (with kXBox): kXBox's map, W % 8 == 0 and an aligned x (xt_box), any
// C_in (the box's channels past C_in come as zeros): every mega block.
template <typename T, int MODE>
bool use_tf32(const void* x, int cin, int w) {
  if (sizeof(T) != 4) return false;
  if ((MODE & kXT) != 0) return w % 8 == 0 && aligned(x, 16);
  return cin % 8 == 0 && aligned(x, 16);
}

// query() of kTf32's kernel for an f32 block with this k and C_in (kMega:
// with kXBox), its boxes per halo and channels per box into out[3],
// out[4]; cudaErrorInvalidValue where the design does not take the shape.
template <int M>
cudaError_t occupancy_tf32(int k, int cin, int* out) {
  constexpr int MT = (M & kXT) != 0 ? M | kXBox | kTf32 : M | kTf32;
  constexpr int XB = (M & kXT) != 0 ? 5 : 4;
  const int b = (XB == 4 && cin % 8 != 0) ? 0
                : k == 3                  ? tf32_chunk<3, XB>(cin)
                : k == 5                  ? tf32_chunk<5, XB>(cin)
                                          : 0;
  if (b == 0) return cudaErrorInvalidValue;
  out[3] = ((cin + 7) / 8 * 8 + b - 1) / b;
  out[4] = b;
  if (k == 3)
    return query(expand_dw_kernel<float, 3, true, true, MT>, NTHREADS,
                 SmemM<3, true, true, MT>(cin, b).total, out);
  return query(expand_dw_kernel<float, 5, true, true, MT>, NTHREADS,
               SmemM<5, true, true, MT>(cin, b).total, out);
}

// query() of the kernel a bf16 block with this k and C_in launches (the
// tensor-core expand; for kMega the kXBox staging).
template <int M>
cudaError_t query_k(int k, int cin, int* out) {
  using B = __nv_bfloat16;
  if (k == 3)
    return query(expand_dw_kernel<B, 3, true, true, M>, NTHREADS,
                 SmemM<3, true, true, M>(cin).total, out);
  if (k == 5)
    return query(expand_dw_kernel<B, 5, true, true, M>, NTHREADS,
                 SmemM<5, true, true, M>(cin).total, out);
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t occupancy(int k, int cin, int* out) {
  if constexpr ((MODE & kXT) != 0) {
    if (xt_split(cin)) return query_k<MODE | kXBox | kXSplit>(k, cin, out);
    return query_k<MODE | kXBox>(k, cin, out);
  } else {
    if (k == 3 ? c_split<3>(cin) : c_split<5>(cin))
      return query_k<MODE | kCSplit>(k, cin, out);
    return query_k<MODE>(k, cin, out);
  }
}

// Whether the expand runs on the tensor cores: bf16, and for NHWC x the
// 16-byte staging copies need C_in % 8 == 0 and an aligned x.
template <typename T, int MODE>
bool use_mma(const void* x, int cin) {
  return sizeof(T) == 2 &&
         ((MODE & kXT) != 0 || (cin % 8 == 0 && aligned(x, 16)));
}

// Whether (N, H, C, W) x takes the kXBox staging: its map needs 16-byte
// strides (W % 8 == 0) and an aligned x.  Every block of the model at a
// width that is a multiple of 8.
inline bool xt_box(const void* x, int w) {
  return w % 8 == 0 && aligned(x, 16);
}

template <typename T, int K, int MODE>
cudaError_t dispatch_k(const void* x, const void* we, const void* wd,
                       const void* be, const void* bd, void* hidden,
                       void* sums, int n, int h, int w, int cin, int e,
                       int pre_act, cudaStream_t s) {
  constexpr bool BF16 = sizeof(T) == 2;
  if (we == nullptr)
    return launch<T, K, false, false, MODE>(x, we, wd, be, bd, hidden, sums,
                                            n, h, w, cin, e, pre_act, s);
  if constexpr (!BF16 && (MODE & kXT) == 0) {
    const int b = use_tf32<T, MODE>(x, cin, w) ? tf32_chunk<K>(cin) : 0;
    if (b > 0)
      return launch<T, K, true, true, MODE | kTf32>(
          x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s, b);
  }
  if constexpr (!BF16 && (MODE & kXT) != 0) {
    const int b = use_tf32<T, MODE>(x, cin, w) ? tf32_chunk<K, 5>(cin) : 0;
    if (b > 0)
      return launch<T, K, true, true, MODE | kXBox | kTf32>(
          x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s, b);
  }
  if (!use_mma<T, MODE>(x, cin))
    return launch<T, K, true, false, MODE>(x, we, wd, be, bd, hidden, sums,
                                           n, h, w, cin, e, pre_act, s);
  if constexpr (BF16 && (MODE & kXT) != 0) {
    if (xt_box(x, w) && xt_split(cin))
      return launch<T, K, true, true, MODE | kXBox | kXSplit>(
          x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s);
    if (xt_box(x, w))
      return launch<T, K, true, true, MODE | kXBox>(
          x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s);
  }
  if constexpr (BF16 && (MODE & kXT) == 0) {
    if (c_split<K>(cin))
      return launch<T, K, true, true, MODE | kCSplit>(
          x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s);
  }
  return launch<T, K, true, BF16, MODE>(x, we, wd, be, bd, hidden, sums, n,
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
