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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a . b over four channels, summed in this order.
__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The AdaAttN logits s[i][j] = q[ty*4+i] . k[tx+16j] of a 16 x 16 thread
// grid over row-major f32 tiles (C channels, row stride LD).  The f32
// forward kernel and the backward kernels all sum them here, so they are
// equal bit for bit and the backward's P = exp(s - m) / l sums to 1 to
// within rounding (adaattn_fwd.cu says why that matters).
template <int C, int LD>
__device__ __forceinline__ void adaattn_logits(const float* qs,
                                               const float* ks, int ty,
                                               int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < C; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += dot4(a[i], b[j]);
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace ast_kernels
