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
