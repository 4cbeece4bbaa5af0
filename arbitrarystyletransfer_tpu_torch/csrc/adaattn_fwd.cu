// Streaming AdaAttN attention statistics (forward).
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/
// adaattn_kernel.py `_fwd_kernel` (host wrapper `_adaattn_pallas_fwd`):
//
//   A    = softmax(q k^T)            unscaled logits, over the style axis
//   mean = A v,  ev2 = A v^2,  std = sqrt(max(ev2 - mean^2, 0))
//   m, l = the per-row running max and sum of exp (kept for the backward)
//
// in f32 throughout, as the TPU kernel casts q, k, v to f32.  The (Nc, Ns)
// attention matrix never reaches HBM: an online softmax streams over style
// tiles, and one product per tile accumulates A [v, v^2] (2C = 256 columns).
//
// What bounds it on an H100: at 512px batch 8 (B = 16 stacked images,
// Nc = Ns = 4096, C = 128) it is 2 * B * Nc * Ns * 3C = 206 GFLOP against
// ~100 MB of q, k, v and outputs, far above the card's bytes-to-FLOPs line;
// so it is bound by arithmetic, here f32 FMA issue on the CUDA cores
// (tensor-core mma with a stated tolerance is later work).
//
// Design (a first, simple version):
//   * One CTA per (image, 64-query tile), 256 threads as a 16 x 16 grid.
//     It loops over 64-key tiles staged in shared memory (q and k
//     transposed, so both operands of q k^T are read as float4).
//   * Each thread computes a 4 x 4 block of the logits, then the row max and
//     row sum with shuffles across the 16 threads of its row (one half-warp).
//   * The probabilities go to shared memory; each thread then accumulates 4
//     rows x 8 channels of both A v and A v^2 in registers (64 floats).
//   * A ragged style tail is masked with -1e30 as on the TPU; ragged query
//     rows are computed on zeros and not stored.
//   * Shared memory 119,808 B (above the 48 KiB default): one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ast_kernels {
namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // style keys per tile
constexpr int C = 128;         // channels
constexpr int NT = 256;        // threads
constexpr int LDT = BQ + 4;    // padded row of the transposed tiles
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_FLOATS = C * LDT + C * LDT + BK * C + BK * LDT;

template <typename T>
__global__ void __launch_bounds__(NT)
    adaattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ mean_out,
                       T* __restrict__ std_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int nc, int ns) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [C][LDT]
  float* kT = qT + C * LDT;                     // [C][LDT]
  float* vs = kT + C * LDT;                     // [BK][C]
  float* pT = vs + BK * C;                      // [BK][LDT]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // logits: key cols tx*4+j; products: chans tx*8+j
  const int ty = tid >> 4;  // query rows ty*4+i
  const T* qb = q + (size_t)b * nc * C;
  const T* kb = k + (size_t)b * ns * C;
  const T* vb = v + (size_t)b * ns * C;

  for (int idx = tid; idx < BQ * C; idx += NT) {
    const int r = idx / C, d = idx % C;
    qT[d * LDT + r] = (q0 + r < nc) ? to_f32(qb[(size_t)(q0 + r) * C + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc_m[4][8], acc_s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_m[i][j] = acc_s[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < ns; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * C; idx += NT) {
      const int r = idx / C, d = idx % C;
      const bool ok = k0 + r < ns;
      const size_t off = (size_t)(k0 + r) * C + d;
      kT[d * LDT + r] = ok ? to_f32(kb[off]) : 0.f;
      vs[r * C + d] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < C; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * LDT + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&kT[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx * 4 + j >= ns) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are one half-warp (lanes differ in bits 0-3).
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        pT[(tx * 4 + j) * LDT + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc_m[i][j] *= corr;
        acc_s[i][j] *= corr;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pT[kk * LDT + ty * 4]);
      const float4 va = *reinterpret_cast<const float4*>(&vs[kk * C + tx * 8]);
      const float4 vb4 = *reinterpret_cast<const float4*>(&vs[kk * C + tx * 8 + 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vb4.x, vb4.y, vb4.z, vb4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v2 = vv[j] * vv[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_m[i][j] = fmaf(pv[i], vv[j], acc_m[i][j]);
          acc_s[i][j] = fmaf(pv[i], v2, acc_s[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= nc) continue;
    const float inv_l = 1.f / l_i[i];
    const size_t base = ((size_t)b * nc + row) * C + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float mean = acc_m[i][j] * inv_l;
      const float ev2 = acc_s[i][j] * inv_l;
      mean_out[base + j] = from_f32<T>(mean);
      std_out[base + j] = from_f32<T>(sqrtf(fmaxf(ev2 - mean * mean, 0.f)));
    }
    if (tx == 0) {
      m_out[(size_t)b * nc + row] = m_i[i];
      l_out[(size_t)b * nc + row] = l_i[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* mean,
                   void* stdv, void* m, void* l, int b, int nc, int ns,
                   cudaStream_t stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  auto kernel = adaattn_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nc + BQ - 1) / BQ, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(mean), static_cast<T*>(stdv),
      static_cast<float*>(m), static_cast<float*>(l), nc, ns);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ast_kernels

// q (b, nc, c), k and v (b, ns, c); mean, std (b, nc, c) in the input dtype;
// m, l (b, nc) f32.  c must be 128 and ns > 0.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int adaattn_fwd_launch(const void* q, const void* k, const void* v,
                                  void* mean, void* stdv, void* m, void* l,
                                  int b, int nc, int ns, int c, int is_bf16,
                                  void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, mean, stdv, m, l, b, nc, ns, s);
  return (int)launch<float>(q, k, v, mean, stdv, m, l, b, nc, ns, s);
}
