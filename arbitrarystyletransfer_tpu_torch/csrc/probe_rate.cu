// Issue-rate probe: `reps` elementwise operations on a (C, L) tile, issued as
// `par` independent accumulator chains of reps / par dependent steps.
//
// Replaces the TPU probe scripts/probe_vpu_rate.py `kernel` (in `make_case`):
//   accs[i] = a0 * (1 + i 1e-6), i < par   (constants in the tile's type)
//   each step, on every chain, one of
//     fma     a * w + b                     (w = 1.000001, b = 1e-7)
//     roll    roll(a, 1) along L            (then a * w once, at the end)
//     select  where(col == step % L, a * w, a)
//     hswish  a * clip(a + 3, 0, 6) / 6     (a true division)
//     cast    float(bf16(a)) * w            (round to nearest even)
//   out = accs[0] + accs[1] + ... , in the tile's type, as f32.
// The TPU kernel stores only out[0, 0]; nvcc drops every operation whose
// result is not stored, so this kernel writes the whole (C, L) tile (4 MB
// f32 at (256, 4096): ~2.5 us of HBM against ~16 us of f32 FMA at 67
// TFLOP/s).  Element [0, 0] is the TPU kernel's output.
//
// What it measures on an H100, and how:
//   * one CTA per row c; thread t owns the elements t + j * blockDim, j < 4
//     (bf16: pairs of adjacent elements, one __nv_bfloat162 each, so that
//     the packed bf16 FMA is what issues), each with `par` chains in
//     registers: 4 x par independent chains per thread, 1024 threads per CTA
//     at L = 4096 f32;
//   * fma is one fmaf (bf16: __hfma2) per step and chain: one rounding where
//     JAX on the CPU rounds the product and the sum separately, so at f32
//     each step may differ from the plain version by about one ulp;
//   * roll moves every element one place along L through the threads: a
//     warp shuffle per register, the carry between warps (and from the last
//     thread's j - 1 column) through shared memory, so a step costs a
//     shuffle, a shared-memory store and load and one CTA barrier; that
//     barrier, not the ALU, is the rate it measures;
//   * select compares the element's column with the step (an integer
//     compare and a select per element and step, plus the product);
//   * hswish keeps the IEEE division by 6 (nvcc's default -prec-div=true),
//     as JAX divides, not a multiplication by 1/6;
//   * cast is __float2bfloat16_rn and back, then the product.
// Every product other than fma's is __fmul_rn, so that nvcc does not fuse it
// with the next addition (the sum of the chains) into an FMA: those ops round
// as JAX does and agree with the plain version exactly.
// bf16 tiles take the fma case only.

#include "common.cuh"

namespace {

constexpr int NV = 4;  // elements (bf16: pairs) per thread
constexpr int kFma = 0, kRoll = 1, kSelect = 2, kHswish = 3, kCast = 4;

template <int OP, int PAR>
__global__ void __launch_bounds__(1024)
    rate_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int L, int steps) {
  __shared__ float carry[2][PAR][NV][32];
  const int nt = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const size_t base = (size_t)blockIdx.x * L;
  const float w = 1.000001f, b = 1e-7f;
  float a[PAR][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float a0 = x[base + t + j * nt];
#pragma unroll
    for (int i = 0; i < PAR; ++i)
      a[i][j] = __fmul_rn(a0, (float)(1.0 + i * 1e-6));
  }
  for (int s = 0; s < steps; ++s) {
    if constexpr (OP == kFma) {
#pragma unroll
      for (int i = 0; i < PAR; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j) a[i][j] = fmaf(a[i][j], w, b);
    } else if constexpr (OP == kRoll) {
      // new[l] = old[l - 1 mod L], with l = t + j * nt.
      const int buf = s & 1;
      if (lane == 31) {
#pragma unroll
        for (int i = 0; i < PAR; ++i)
#pragma unroll
          for (int j = 0; j < NV; ++j) carry[buf][i][j][warp] = a[i][j];
      }
#pragma unroll
      for (int i = 0; i < PAR; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          a[i][j] = __shfl_up_sync(0xffffffffu, a[i][j], 1);
      __syncthreads();  // the carries of this step are written
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < PAR; ++i)
#pragma unroll
          for (int j = 0; j < NV; ++j)
            a[i][j] = warp > 0 ? carry[buf][i][j][warp - 1]
                               : carry[buf][i][(j + NV - 1) % NV][nwarps - 1];
      }
    } else if constexpr (OP == kSelect) {
      const int target = s % L;
#pragma unroll
      for (int i = 0; i < PAR; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          a[i][j] = (t + j * nt == target) ? __fmul_rn(a[i][j], w) : a[i][j];
    } else if constexpr (OP == kHswish) {
#pragma unroll
      for (int i = 0; i < PAR; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          a[i][j] =
              __fmul_rn(a[i][j], fminf(fmaxf(a[i][j] + 3.f, 0.f), 6.f)) / 6.f;
    } else {
#pragma unroll
      for (int i = 0; i < PAR; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          a[i][j] =
              __fmul_rn(__bfloat162float(__float2bfloat16_rn(a[i][j])), w);
    }
  }
  if constexpr (OP == kRoll) {
#pragma unroll
    for (int i = 0; i < PAR; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j) a[i][j] = __fmul_rn(a[i][j], w);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float o = a[0][j];
#pragma unroll
    for (int i = 1; i < PAR; ++i) o = o + a[i][j];
    out[base + t + j * nt] = o;
  }
}

template <int PAR>
__global__ void __launch_bounds__(1024)
    rate_bf16_fma_kernel(const __nv_bfloat162* __restrict__ x,
                         float2* __restrict__ out, int L2, int steps) {
  const int nt = blockDim.x, t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * L2;
  const __nv_bfloat162 w = __float2bfloat162_rn(1.000001f);  // 1.0 in bf16
  const __nv_bfloat162 b = __float2bfloat162_rn(1e-7f);
  __nv_bfloat162 a[PAR][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const __nv_bfloat162 a0 = x[base + t + j * nt];
#pragma unroll
    for (int i = 0; i < PAR; ++i)
      a[i][j] = __hmul2(a0, __float2bfloat162_rn((float)(1.0 + i * 1e-6)));
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < PAR; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j) a[i][j] = __hfma2(a[i][j], w, b);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    __nv_bfloat162 o = a[0][j];
#pragma unroll
    for (int i = 1; i < PAR; ++i) o = __hadd2(o, a[i][j]);
    out[base + t + j * nt] = __bfloat1622float2(o);
  }
}

template <int OP, int PAR>
cudaError_t launch_f32(const void* x, void* out, int c, int l, int steps,
                       cudaStream_t st) {
  rate_f32_kernel<OP, PAR><<<c, l / NV, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), l, steps);
  return cudaGetLastError();
}

template <int PAR>
cudaError_t launch_bf16_fma(const void* x, void* out, int c, int l, int steps,
                            cudaStream_t st) {
  rate_bf16_fma_kernel<PAR><<<c, l / (2 * NV), 0, st>>>(
      static_cast<const __nv_bfloat162*>(x), static_cast<float2*>(out), l / 2,
      steps);
  return cudaGetLastError();
}

}  // namespace

// x (c, l) f32 or bf16, out (c, l) f32, contiguous; l a multiple of 128 and
// at most 4096; op 0-4 (fma, roll, select, hswish, cast) at the JAX probe's
// par (fma 1 or 8, roll and select 8, hswish and cast 4; bf16: fma at 8), the
// only instances built; steps = reps / par.  Returns the launch's cudaError_t.
extern "C" int probe_rate_launch(const void* x, void* out, int c, int l,
                                 int reps, int op, int par, int is_bf16,
                                 void* stream) {
  if (c == 0) return 0;
  if (l % 128 != 0 || l <= 0 || l > 4096 || reps < par)
    return (int)cudaErrorInvalidValue;
  const int steps = reps / par;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(op == kFma && par == 8
                     ? launch_bf16_fma<8>(x, out, c, l, steps, st)
                     : cudaErrorInvalidValue);
  if (op == kFma && par == 1)
    return (int)launch_f32<kFma, 1>(x, out, c, l, steps, st);
  if (op == kFma && par == 8)
    return (int)launch_f32<kFma, 8>(x, out, c, l, steps, st);
  if (op == kRoll && par == 8)
    return (int)launch_f32<kRoll, 8>(x, out, c, l, steps, st);
  if (op == kSelect && par == 8)
    return (int)launch_f32<kSelect, 8>(x, out, c, l, steps, st);
  if (op == kHswish && par == 4)
    return (int)launch_f32<kHswish, 4>(x, out, c, l, steps, st);
  if (op == kCast && par == 4)
    return (int)launch_f32<kCast, 4>(x, out, c, l, steps, st);
  return (int)cudaErrorInvalidValue;
}
