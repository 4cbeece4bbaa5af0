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
// takes the TPU kernel's non-resident mode, as flat_block.cu does:
//   * sweep 1, expand_dw.cuh with kMega: x is read in its (N, H, C, W) layout
//     (the reflection is an index map, C_in padded to the MMA depth in
//     shared memory only), the bf16 hidden is written once (NHWC, the
//     layout sweep 2 streams), and the exact per-image sums of the rounded
//     hidden are added with atomics;
//   * sweep 2, gate_project.cuh with YT: each image's gate from its sums,
//     then the hidden streamed, gated and projected on the tensor cores, the
//     bias and the residual read from x added, and y written in
//     (N, H, C_out, W).
// Nothing outside the kernel transposes.  What bounds each sweep is in its
// header: sweep 1 the f32 depthwise and its shared-memory traffic, sweep 2
// the one read of the hidden from HBM.

#include "expand_dw.cuh"
#include "gate_project.cuh"

// x (n, h, cin, w); hidden (n, h, w, e), sums (n, e), gate (n, e; f32
// scratch) and y (n, h, cout, w) must be allocated by the caller, sums
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
                                 void* gate, void* y, int n, int h, int w,
                                 int cin, int e, int s, int cout, int k,
                                 int pre_act,
                                 int identity, int is_bf16, void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  if (identity && cin != cout) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* res = identity ? x : nullptr;
  cudaError_t err;
  if (is_bf16) {
    using B = __nv_bfloat16;
    err = edw::dispatch<B, edw::kMega>(x, we, wd, be, bd, hidden, sums, n, h,
                                       w, cin, e, k, pre_act, st);
    if (err != cudaSuccess) return (int)err;
    err = gp::launch<B, true>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, res,
                              gate, y, n, h * w, e, s, cout, st, w);
  } else {
    err = edw::dispatch<float, edw::kMega>(x, we, wd, be, bd, hidden, sums, n,
                                           h, w, cin, e, k, pre_act, st);
    if (err != cudaSuccess) return (int)err;
    err = gp::launch<float, true>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb,
                                  res, gate, y, n, h * w, e, s, cout, st, w);
  }
  return (int)err;
}
