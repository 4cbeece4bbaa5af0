// The whole stride-1 inverted-residual block on the (N, H, C, W) layout, in
// two launches.
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/megablock.py
// `_mega_kernel_t` (host wrapper `mega_expand_dw_project_t`), the block of the
// "mega" route.  x and y are (N, H, C, W) with W contiguous:
//
//   ex     = hswish(x @ We + be)       (f32, not rounded; expand==1: x + be)
//   hidden = round(hswish(dw_kxk(reflect_pad(ex), Wd) + bd))
//   sums   = sum over H, W of hidden         (f32, of the rounded hidden)
//   gate   = clip(relu((sums / HW) @ D0 + b0) @ D1 + b1, 0, 1)
//   y      = round((hidden * round(gate)) @ Wp [f32 acc] + pb) (+ x)
//
// where round() casts to the I/O dtype, at the TPU kernel's rounding points:
// the expanded values stay f32 as in `_fused_kernel`, the sums are of the
// rounded hidden as in `_flat_kernel`.
//
// On the TPU one grid step owns a whole image and keeps its 50-84 MB hidden
// resident in VMEM (or, past the budget, round-trips it through an HBM
// scratch) across the SE barrier.  What bounds the block on an H100: an SM
// has at most 227 KB of shared memory and the card 50 MB of L2, so at 512px
// the hidden cannot stay on chip (d10: 8 x 240 x 512^2 x 2 B = 1.0 GB per
// call), and the gate is a barrier across every CTA of an image.  The design
// takes the TPU kernel's non-resident mode, as flat_block.cu does, with
// the two parts that only the (N, H, C, W) layout needs:
//   * sweep 1, expand_dw.cuh with kMega: x is read in its own layout.  At
//     W % 8 == 0 (every block of the model; kXBox) each tile's x halo is
//     one TMA box of a (W, C, H, N) map, [halo row][channel][24 columns]
//     from a column that is a multiple of 8 (the tile grid shifted by P - 8:
//     TMA faults on an unaligned innermost coordinate; one more tile per
//     row), prefetched while the previous tile's depthwise runs, its channels
//     past C_in zero outside the tensor, the image's edges reflected by
//     copies in shared memory; the expand reads its A fragments straight
//     from the box with ldmatrix.trans, 16-pixel MMA tiles of two 8-column
//     groups (24/20 of the expand at k5, 24/18 at k3).  f32 x (the stylize
//     CLI's dtype) takes the same box in f32 words, [halo row][bch][24]
//     (96-byte rows), in channel chunks sized as the NHWC f32 design's
//     (tf32_chunk), and expands on the tensor cores as 3xTF32, the
//     arithmetic of every f32 block of the model (expand_mtile_tf32_t: A
//     fragments by conflict-free 32-bit loads from the channel rows, since
//     ldmatrix.trans moves 16-bit elements only; expand_dw.cuh gives the
//     shared memory at each shape).  Other W (off the model's path): the
//     halo is staged synchronously (plain loads, reflected by index; f32 on
//     the CUDA cores).  The hidden is written once (NHWC, the layout sweep
//     2 streams), and the sums of the rounded hidden go by tile to a row of
//     partials that a small kernel adds per image in a fixed order (no
//     atomics);
//   * sweep 2, gate_project.cuh with YT: each image's gate from its sums,
//     then the hidden streamed, gated and projected on the tensor cores,
//     the bias added; where a 128-pixel tile lies in one image row
//     (W % 128 == 0: every mega block) each warp stages its pixels by
//     channel in shared memory and writes y (N, H, C_out, W) as 64-byte
//     channel runs with 16-byte stores, the residual prefetched into L2 and
//     read the same way; other W one value at a time.
// Nothing outside the kernel transposes.  What bounds each sweep is in its
// header: sweep 1 the f32 depthwise and its shared-memory traffic, sweep 2
// the one read of the hidden from HBM.

#include "expand_dw.cuh"
#include "gate_project.cuh"

// x (n, h, cin, w); hidden (n, h, w, e), sums (n, e), part (n,
// part_tiles, e; f32 scratch, expand_dw.cuh SumsOut), gate (n, e; f32
// scratch) and y (n, h, cout, w) must be allocated by the caller, none
// zeroed.  we == nullptr is the
// expand==1 form (e == cin); identity adds x (cin == cout).  d0t is the SE's
// first dense kernel transposed, (s, e); d1k (s, e); wpt the projection
// transposed, (cout, e).  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int mega_block_launch(const void* x, const void* we,
                                 const void* wd, const void* be,
                                 const void* bd, const void* d0t,
                                 const void* d0b, const void* d1k,
                                 const void* d1b, const void* wpt,
                                 const void* pb, void* hidden, void* sums,
                                 void* part, void* gate, void* y, int n,
                                 int h, int w, int cin, int e, int s,
                                 int cout, int k, int pre_act, int identity,
                                 int is_bf16, int part_tiles, void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  const edw::SumsOut so{part, part_tiles, sums};
  if (identity && cin != cout) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* res = identity ? x : nullptr;
  cudaError_t err;
  if (is_bf16) {
    using B = __nv_bfloat16;
    err = edw::dispatch<B, edw::kMega>(x, we, wd, be, bd, hidden, so, n, h,
                                       w, cin, e, k, pre_act, st);
    if (err != cudaSuccess) return (int)err;
    err = gp::launch<B, true>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, res,
                              gate, y, n, h * w, e, s, cout, st, w);
  } else {
    err = edw::dispatch<float, edw::kMega>(x, we, wd, be, bd, hidden, so, n,
                                           h, w, cin, e, k, pre_act, st);
    if (err != cudaSuccess) return (int)err;
    err = gp::launch<float, true>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb,
                                  res, gate, y, n, h * w, e, s, cout, st, w);
  }
  return (int)err;
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of the
// two bf16 sweeps a block of this shape launches at W % 128 == 0 (sweep 1
// with the box staging), sweep 1 into out[0..2] and sweep 2 into
// out[3..5], for measurement.  Launches nothing.
extern "C" int mega_block_occupancy(int k, int cin, int e, int cout,
                                    int identity, int* out) {
  using namespace ast_kernels;
  cudaError_t err = edw::occupancy<edw::kMega>(k, cin, out);
  if (err != cudaSuccess) return (int)err;
  return (int)gp::occupancy<true>(e, cout, identity != 0, out + 3);
}

// expand_dw_f32_occupancy for mega_block's f32 sweep 1 (kMega with kXBox
// and kTf32, W % 8 == 0): registers, shared memory, CTAs per SM, x boxes
// per halo and channels per box into out[0..4].  Launches nothing.
extern "C" int mega_block_f32_occupancy(int k, int cin, int* out) {
  using namespace ast_kernels;
  return (int)edw::occupancy_tf32<edw::kMega>(k, cin, out);
}

// How the last mega_block_launch staged x in sweep 1: 1 as TMA boxes
// (asynchronous), 0 with plain loads, -1 before any launch.
extern "C" int mega_block_last_staging() {
  return ast_kernels::edw::last_async();
}

// The sweep-1 design of the last mega_block_launch: 0 the CUDA-core expand
// (or expand==1), 1 the bf16 tensor-core expand, 2 the f32 3xTF32 one;
// -1 before any launch.
extern "C" int mega_block_last_sweep1() {
  return ast_kernels::edw::last_design();
}

// The x boxes per halo of the last mega_block_launch's sweep 1: 1 the whole
// box (or plain loads), 2 kXSplit's halves, or the 3xTF32 design's
// chunks; -1 before any launch.
extern "C" int mega_block_last_boxes() {
  return ast_kernels::edw::last_boxes();
}

// The design of the last mega_block_launch's sweep 2: 0
// gate_project_generic, 1 gate_project_mma (bf16), 2 gate_project_tf32
// (f32); -1 before any.
extern "C" int mega_block_last_sweep2() {
  return ast_kernels::gp::last_design();
}
