// Small device helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// x * relu6(x + 3) / 6, multiplied in the JAX package's order.
__device__ __forceinline__ float hswish(float v) {
  return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
}

}  // namespace ast_kernels
