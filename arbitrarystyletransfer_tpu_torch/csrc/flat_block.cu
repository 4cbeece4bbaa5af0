// The whole stride-1 inverted-residual block in two launches.
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/flatblock.py
// `_flat_kernel` (host wrappers `flat_expand_dw_project`, `flat_block_apply_f`):
//
//   ex     = round(hswish(x @ We + be))           (expand==1: round(x + be))
//   hidden = round(hswish(dw_kxk(reflect_pad(ex), Wd) + bd))
//   sums   = sum over H, W of hidden               (f32, of the rounded hidden)
//   gate   = clip(relu((sums / HW) @ D0 + b0) @ D1 + b1, 0, 1)
//   y      = round((hidden * round(gate)) @ Wp [f32 acc] + pb) (+ x)
//
// where round() casts to the I/O dtype, at the TPU kernel's rounding points.
//
// On the TPU one grid step owns a whole image: it streams row slabs through
// VMEM, keeps the hidden resident (or spills it to an HBM scratch), takes the
// gate and projects in a second sweep.  On an H100 the 512px hidden cannot
// stay on chip (d10: 8 x 240 x 512^2 x 2 B = 1.0 GB per call against 227 KB
// of shared memory per CTA), and the gate is a barrier across every CTA of an
// image, so the TPU's non-resident mode becomes two launches:
//   * sweep 1, expand_dw.cuh with kFlat: the bf16 hidden is written once and
//     the exact per-image sums are added with atomics;
//   * sweep 2, gate_project.cuh: each image's gate from its sums (a small
//     kernel), then persistent CTAs stream runs of the hidden through a TMA
//     ring, gate and project them on the tensor cores, add the bias and the
//     residual.
// What bounds each sweep, and its design, is in its header.

#include "expand_dw.cuh"
#include "gate_project.cuh"

// hidden (n, h, w, e), sums (n, e), gate (n, e; f32 scratch) and
// y (n, h, w, cout) must be allocated by the caller, sums zeroed.
// we == nullptr is the expand==1 form (e == cin); identity adds x
// (cin == cout).  d0t is the SE's first dense kernel
// transposed, (s, e); d1k (s, e); wpt the projection transposed, (cout, e).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int flat_block_launch(const void* x, const void* we,
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
    err = edw::dispatch<B, edw::kFlat>(x, we, wd, be, bd, hidden, sums, n, h,
                                       w, cin, e, k, pre_act, st);
    if (err != cudaSuccess) return (int)err;
    err = gp::launch<B>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, res, gate,
                        y, n, h * w, e, s, cout, st);
  } else {
    err = edw::dispatch<float, edw::kFlat>(x, we, wd, be, bd, hidden, sums, n,
                                           h, w, cin, e, k, pre_act, st);
    if (err != cudaSuccess) return (int)err;
    err = gp::launch<float>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, res,
                            gate, y, n, h * w, e, s, cout, st);
  }
  return (int)err;
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of the
// two bf16 sweeps a block of this shape launches, sweep 1 into out[0..2]
// and sweep 2 into out[3..5], for measurement.  Launches nothing.
extern "C" int flat_block_occupancy(int k, int cin, int e, int cout,
                                    int identity, int* out) {
  using namespace ast_kernels;
  cudaError_t err = edw::occupancy<edw::kFlat>(k, cin, out);
  if (err != cudaSuccess) return (int)err;
  return (int)gp::occupancy(e, cout, identity != 0, out + 3);
}

// expand_dw_f32_occupancy for flat_block's sweep 1 (kFlat): the f32
// 3xTF32 kernel's registers, shared memory, CTAs per SM, x boxes per halo
// and channels per box into out[0..4].  Launches nothing.
extern "C" int flat_block_f32_occupancy(int k, int cin, int* out) {
  using namespace ast_kernels;
  return (int)edw::occupancy_tf32<edw::kFlat>(k, cin, out);
}

// The sweep-1 design of the last flat_block_launch: 0 the CUDA-core expand
// (or expand==1), 1 the bf16 tensor-core expand, 2 the f32 3xTF32 one;
// -1 before any launch.
extern "C" int flat_block_last_sweep1() {
  return ast_kernels::edw::last_design();
}

// The x boxes per halo of the last flat_block_launch's sweep 1 (as
// expand_dw_last_boxes); -1 before any launch.
extern "C" int flat_block_last_boxes() {
  return ast_kernels::edw::last_boxes();
}

// The design of the last sweep 2 that flat_block_launch or
// gate_project_launch ran: 0 gate_project_generic, 1 gate_project_mma
// (bf16), 2 gate_project_tf32 (f32); -1 before any.
extern "C" int flat_block_last_sweep2() {
  return ast_kernels::gp::last_design();
}

// Sweep 2 alone, for the A/B of its designs: gate_project.cuh's launch with
// flat_block_launch's operands (hidden (n, hw, e) as sweep 1 writes it; res
// may be null), y and res NHWC or, with yt, (n, hw / w, cout, w).  design 0
// takes gate_project_generic at every shape, 1 the designed kernel of the
// dtype where the shape takes one (flat_block_launch's choice).  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int gate_project_launch(int design, const void* hidden,
                                   const void* sums, const void* d0t,
                                   const void* d0b, const void* d1k,
                                   const void* d1b, const void* wpt,
                                   const void* pb, const void* res,
                                   void* gate, void* y, int n, int hw, int e,
                                   int s, int cout, int w, int yt,
                                   int is_bf16, void* stream) {
  using namespace ast_kernels;
  if (design < 0 || design > 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0 || e == 0) return 0;
  if (yt && (w <= 0 || hw % w != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d = design == 1;
  using B = __nv_bfloat16;
#define AST_GP(T, YT)                                                       \
  return (int)gp::launch<T, YT>(hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, \
                                res, gate, y, n, hw, e, s, cout, st,       \
                                YT ? w : 1, d)
  if (is_bf16 && yt) AST_GP(B, true);
  if (is_bf16) AST_GP(B, false);
  if (yt) AST_GP(float, true);
  AST_GP(float, false);
#undef AST_GP
}

// Registers, dynamic shared memory (bytes), resident CTAs per SM and ring
// slots of the sweep-2 kernel of `design` (0 gate_project_generic, 1 the
// designed kernel of the dtype) at this shape, into out[4]; an error where
// the design does not take the shape.  Launches nothing.
extern "C" int gate_project_occupancy(int design, int e, int cout, int res,
                                      int yt, int is_bf16, int* out) {
  using namespace ast_kernels;
  if (yt) return (int)gp::occupancy<true>(design, is_bf16, e, cout, res, out);
  return (int)gp::occupancy<false>(design, is_bf16, e, cout, res, out);
}
