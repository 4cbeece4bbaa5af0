// Small device helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ast_kernels {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: where the JAX package casts to the I/O dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// x * relu6(x + 3) / 6, multiplied in the JAX package's order.
__device__ __forceinline__ float hswish(float v) {
  return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
}

// Torch ReflectionPad index (-1 -> 1, n -> n - 2).
__device__ __forceinline__ int reflect_idx(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  // Only positions that feed masked outputs of a partial tile can still be
  // out of range here; clamp them to stay inside the image.
  return min(max(i, 0), n - 1);
}

// D += A(16x16, row-major) * B(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi = x rounded to TF32 (to nearest, ties away, on the bits: an integer
// add and a mask, where cvt.rna.tf32.f32 takes a longer sequence), lo =
// x - hi, exact: the operands of a 3xTF32 product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// split_tf32 with hi = x truncated to TF32 (one operation fewer): lo = x -
// hi is exact and at most 2^-10 |x|, so the lo * lo term a 3xTF32 product
// leaves out stays below 2^-20 of the product.  Exact, lo read whole by the
// tensor cores, for a value of tf32_pair_exact's.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x rounded to nearest once to the 22 bits that split_tf32_trunc's two
// parts carry whole: hi = x truncated to TF32, lo = x - hi rounded to TF32,
// ties to even (lo has at most 13 bits, so a quarter of them are ties:
// away from zero, every weight's error would lean with its sign); their
// sum is exact in f32, and split_tf32_trunc of it gives back hi and lo.
__device__ __forceinline__ float tf32_pair_exact(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  const uint32_t lo = __float_as_uint(x - hi);
  return hi + __uint_as_float((lo + 0xfffu + ((lo >> 13) & 1u)) &
                              0xffffe000u);
}

// D(16x8) += A(16x8) B(8x8), TF32 in, f32 accumulate: a0 = A(g, t), a1 =
// A(g + 8, t), a2 = A(g, t + 4), a3 = A(g + 8, t + 4); b0 = B(t, g), b1 =
// B(t + 4, g) (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Row stride (doubles) of the f64 tiles of 128 channels: 130, so that the
// mma fragments' reads of eight rows at four channels take the fewest
// shared-memory wavefronts, and a row pointer plus immediate offsets
// address them.
constexpr int LDD = 130;

// D(16x8, f64) += A(16x4) B(4x8) on the FP64 tensor cores: a0 = A(g, t),
// a1 = A(g + 8, t), b = B(t, g); d = D(g, 2t), D(g, 2t + 1), D(g + 8, 2t),
// D(g + 8, 2t + 1) (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0,
                                            double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The AdaAttN logits of a warp's 16 x 8 NB block, s = a . b over the 128
// channels of f32 rows taken exactly as f64: load_a(c, a0, a1) gives the A
// rows g and g + 8 of the block at channel c + t, load_b(nb, c) the B row
// 8 nb + g at channel c + t (t = lane % 4).  Each logit is ONE chain of
// FP64 tensor-core products over the channel quads 0-3, 4-7, .., 124-127 in
// order, from 0: exact products, f64 sums.  s[nb] is the accumulator
// fragment (rows g, g + 8; columns 8 nb + 2t, 8 nb + 2t + 1).  The f32
// forward and the backward kernels all form their logits here, whatever
// their layout, wherever their operands lie and whichever of q and k is A
// (the products are exact), so they are equal bit for bit and the
// backward's P = exp(s - m) / l sums to 1 against the forward's l
// (adaattn_fwd.cu says why that matters).
template <int NB, typename LoadA, typename LoadB>
__device__ __forceinline__ void adaattn_logits64(LoadA load_a, LoadB load_b,
                                                 double (&s)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.0;
#pragma unroll
  for (int c = 0; c < 128; c += 4) {
    double a0, a1;
    load_a(c, a0, a1);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) dmma_16x8x4(s[nb], a0, a1, load_b(nb, c));
  }
}

// Rows [row0, row0 + rows) of an (n, C) f32 or bf16 matrix into an f64
// tile of row stride LDD, converted exactly; rows past n are zeros.  All
// `nt` threads of the CTA take part.
template <int C, typename T>
__device__ __forceinline__ void stage_f64(double* dst, const T* src, int row0,
                                          int rows, int n, int tid, int nt) {
  for (int idx = tid; idx < rows * (C / 2); idx += nt) {
    const int r = idx / (C / 2), c = 2 * (idx % (C / 2));
    double2 w = make_double2(0.0, 0.0);
    if (row0 + r < n) {
      const T* p = src + (size_t)(row0 + r) * C + c;
      w = make_double2(to_f32(p[0]), to_f32(p[1]));
    }
    *reinterpret_cast<double2*>(&dst[r * LDD + c]) = w;
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The device's shared memory (an H100's: 232,448 bytes per CTA opt-in,
// 233,472 per SM, 1,024 of them reserved per CTA), queried once on the
// host: the limits expand_dw.cuh's and gate_project.cuh's launchers size
// their kernels against.
inline cudaError_t smem_limits(int& max_smem, int& sm_smem, int& reserved) {
  static int v[3] = {0, 0, 0};
  if (v[0] == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &v[1], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &v[2], cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &v[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      v[0] = 0;
      return err;
    }
  }
  max_smem = v[0];
  sm_smem = v[1];
  reserved = v[2];
  return cudaSuccess;
}

}  // namespace ast_kernels
