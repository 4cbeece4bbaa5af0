// Depthwise layout probe: one f32 k x k depthwise in two layouts.
//
// Replaces the TPU probes scripts/probe_mega2.py `_dw_t_kernel` (P3, the
// channel-planar (rows, C, W) layout, W in lanes, column taps by lane rolls)
// and `_dw_nhwc_kernel` (P3, NHWC over a pre-padded input, C in lanes).
// They compute different functions, kept as the TPU kernels define them:
//   * dw_t:    x (th + 2p, C, W) -> y (th, C, W),
//              y[r, c, w] = sum_{dj, di} x[r + di, c, (w + dj - p) mod W]
//                                        * wd[di, dj, c]
//     rows valid, W circular (pltpu.roll with the shift taken mod W; the
//     TPU source's negative shift no longer traces);
//   * dw_nhwc: x (th + 2p, W + 2p, C) -> y (th, W, C),
//              y[r, w, c] = sum_{dj, di} x[r + di, w + dj, c] * wd[di, dj, c]
//     a valid convolution over the padded input.
// Both sum each output in the TPU kernels' order, dj outer, di inner, with
// one fmaf per tap.
//
// What bounds them on an H100: bytes, (th + 2p + th) C W x 4 B (22.3 MB at
// k5, C 160, W 512: 6.7 us at 3.35 TB/s) against 2 k^2 th C W f32 FLOP (2.0
// us at 67 TFLOP/s).  The question the probe asks is the layout, which the
// kernels of this port answer differently (mega_block reads x as (N, H, C, W),
// flat_block as NHWC), so both kernels share one schedule and differ only in
// how a warp reads memory:
//   * each thread owns one column (dw_t: one w of one channel; dw_nhwc: four
//     channels of one w, as a float4) and RG = 8 output rows, walks the
//     RG + 2p input rows of each column tap dj and feeds every loaded value to
//     the up-to-k rows it touches (k accumulations per load);
//   * dw_t: the lanes of a warp read 32 consecutive w of one channel row
//     (128 B per load instruction, 4 B a lane; the circular wrap is an index);
//   * dw_nhwc: the lanes read consecutive (w, 4-channel) groups, 16 B a lane
//     (512 B per load instruction); C must be a multiple of 4.
// Loads go through L1; no shared-memory staging in either, so that the two
// differ in the layout alone.

#include "common.cuh"

namespace {

constexpr int RG = 8;  // output rows per thread
constexpr int NTHREADS = 128;

template <int K>
__global__ void __launch_bounds__(NTHREADS)
    dw_t_kernel(const float* __restrict__ x, const float* __restrict__ wd,
                float* __restrict__ y, int th, int C, int W) {
  constexpr int P = (K - 1) / 2;
  const int w = blockIdx.x * NTHREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int r0 = blockIdx.z * RG;
  if (w >= W) return;
  float o[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) o[i] = 0.f;
#pragma unroll
  for (int dj = 0; dj < K; ++dj) {
    float wk[K];
#pragma unroll
    for (int di = 0; di < K; ++di) wk[di] = wd[(di * K + dj) * C + c];
    int col = w + dj - P;
    col = col < 0 ? col + W : (col >= W ? col - W : col);
#pragma unroll
    for (int row = 0; row < RG + 2 * P; ++row) {
      if (r0 + row < th + 2 * P) {
        const float v = x[((size_t)(r0 + row) * C + c) * W + col];
#pragma unroll
        for (int di = 0; di < K; ++di) {
          const int oy = row - di;
          if (oy >= 0 && oy < RG) o[oy] = fmaf(v, wk[di], o[oy]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RG; ++i)
    if (r0 + i < th) y[((size_t)(r0 + i) * C + c) * W + w] = o[i];
}

__device__ __forceinline__ void fma4(float4& o, const float4& v,
                                     const float4& w) {
  o.x = fmaf(v.x, w.x, o.x);
  o.y = fmaf(v.y, w.y, o.y);
  o.z = fmaf(v.z, w.z, o.z);
  o.w = fmaf(v.w, w.w, o.w);
}

template <int K>
__global__ void __launch_bounds__(NTHREADS)
    dw_nhwc_kernel(const float4* __restrict__ x, const float4* __restrict__ wd,
                   float4* __restrict__ y, int th, int W, int C4) {
  constexpr int P = (K - 1) / 2;
  const int idx = blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= W * C4) return;
  const int c4 = idx % C4, w = idx / C4;
  const int r0 = blockIdx.y * RG;
  const int wp = W + 2 * P;
  float4 o[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int dj = 0; dj < K; ++dj) {
    float4 wk[K];
#pragma unroll
    for (int di = 0; di < K; ++di) wk[di] = wd[(di * K + dj) * C4 + c4];
#pragma unroll
    for (int row = 0; row < RG + 2 * P; ++row) {
      if (r0 + row < th + 2 * P) {
        const float4 v = x[((size_t)(r0 + row) * wp + w + dj) * C4 + c4];
#pragma unroll
        for (int di = 0; di < K; ++di) {
          const int oy = row - di;
          if (oy >= 0 && oy < RG) fma4(o[oy], v, wk[di]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RG; ++i)
    if (r0 + i < th) y[((size_t)(r0 + i) * W + w) * C4 + c4] = o[i];
}

}  // namespace

// x (th + 2p, c, w), wd (k, k, c), y (th, c, w), f32 contiguous; k 3 or 5,
// w > p.  Returns the cudaError_t of the launch.
extern "C" int probe_dw_t_launch(const void* x, const void* wd, void* y,
                                 int th, int c, int w, int k, void* stream) {
  if (th == 0 || c == 0 || w == 0) return 0;
  if ((k != 3 && k != 5) || w <= (k - 1) / 2)
    return (int)cudaErrorInvalidValue;
  dim3 grid((w + NTHREADS - 1) / NTHREADS, c, (th + RG - 1) / RG);
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(wd);
  auto yp = static_cast<float*>(y);
  if (k == 3)
    dw_t_kernel<3><<<grid, NTHREADS, 0, st>>>(xp, wp, yp, th, c, w);
  else
    dw_t_kernel<5><<<grid, NTHREADS, 0, st>>>(xp, wp, yp, th, c, w);
  return (int)cudaGetLastError();
}

// x (th + 2p, w + 2p, c), wd (k, k, c), y (th, w, c), f32 contiguous and
// 16-byte aligned; k 3 or 5, c a multiple of 4.
extern "C" int probe_dw_nhwc_launch(const void* x, const void* wd, void* y,
                                    int th, int c, int w, int k,
                                    void* stream) {
  using namespace ast_kernels;
  if (th == 0 || c == 0 || w == 0) return 0;
  if ((k != 3 && k != 5) || c % 4 != 0 || !aligned(x, 16) ||
      !aligned(wd, 16) || !aligned(y, 16))
    return (int)cudaErrorInvalidValue;
  const int c4 = c / 4;
  dim3 grid((w * c4 + NTHREADS - 1) / NTHREADS, (th + RG - 1) / RG);
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float4*>(x);
  auto wp = static_cast<const float4*>(wd);
  auto yp = static_cast<float4*>(y);
  if (k == 3)
    dw_nhwc_kernel<3><<<grid, NTHREADS, 0, st>>>(xp, wp, yp, th, w, c4);
  else
    dw_nhwc_kernel<5><<<grid, NTHREADS, 0, st>>>(xp, wp, yp, th, w, c4);
  return (int)cudaGetLastError();
}
