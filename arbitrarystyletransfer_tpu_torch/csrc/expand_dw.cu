// Fused 1x1 expand + k x k depthwise of one stride-1 inverted-residual block.
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/fused_block.py
// `_fused_kernel` in mode "hidden" (host wrapper `fused_expand_dw`):
//
//   h      = hswish(x @ We + be)              (pre_act; f32 accumulation)
//   out    = hswish(dw_kxk(reflect_pad(h)) + bd)
//   hidden = out rounded to x's dtype,  sums[n, c] = sum over H, W of out
//
// Numerics follow the TPU kernel: the depthwise runs in f32 on the unrounded
// expanded values, and the SE sums are taken before the hidden is rounded.
// The device code, what bounds it and its design are in expand_dw.cuh, which
// the flat route's first sweep (flat_block.cu) shares.

#include "expand_dw.cuh"

// hidden (n, h, w, e) and sums (n, e) must be allocated by the caller, sums
// zeroed.  Returns the cudaError_t of the launch (0 on success).
extern "C" int expand_dw_launch(const void* x, const void* we, const void* wd,
                                const void* be, const void* bd, void* hidden,
                                void* sums, int n, int h, int w, int cin,
                                int e, int k, int pre_act, int is_bf16,
                                void* stream) {
  using namespace ast_kernels;
  if (n == 0 || h == 0 || w == 0 || e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)edw::dispatch<__nv_bfloat16, edw::kFused>(
        x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, k, pre_act, s);
  return (int)edw::dispatch<float, edw::kFused>(
      x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, k, pre_act, s);
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of the
// bf16 kernel a block with this k and C_in launches, into out[0..2], for
// measurement.  Launches nothing.
extern "C" int expand_dw_occupancy(int k, int cin, int* out) {
  using namespace ast_kernels;
  return (int)edw::occupancy<edw::kFused>(k, cin, out);
}
