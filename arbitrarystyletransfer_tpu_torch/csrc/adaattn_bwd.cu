// Streaming AdaAttN attention statistics (backward): dq, and dk with dv.
//
// Replaces the TPU kernels arbitrarystyletransfer_tpu/ops/pallas/
// adaattn_kernel.py `_dq_kernel` and `_dkv_kernel` (host wrapper
// `_adaattn_pallas_bwd`).  With O = [M1, M2] = A [v, v^2], A = softmax(q k^T)
// (unscaled logits) and the cotangents folded to dM = [dm1, dm2] outside
// (the sqrt/relu chain is elementwise, in PyTorch):
//
//   P   = exp(q k^T - m) / l          recomputed per tile from the forward's
//                                     row max m and sum of exp l
//   T   = dm1 v^T + dm2 (v^2)^T       one product of depth 2C = 256
//   dS  = P o (T - D)                 D = the row term sum(dM o O)
//   dq  = dS k                        (adaattn_dq: summed over key tiles)
//   dk  = dS^T q                      (adaattn_dkv: summed over query tiles)
//   dv  = P^T dm1 + 2 v o (P^T dm2)   v is fixed per key, so 2 v o (.) is
//                                     applied once after the sum
//
// in f32 throughout, whatever the input dtype, as the TPU kernels cast to
// f32.  Neither P nor dS reaches HBM.
//
// What bounds it on an H100: 20 B Nc Ns C FLOPs for both kernels (8 for dq:
// s, T and dS k; 12 for dkv: s, T, dS^T q, P^T dm1, P^T dm2) against
// ~(6 Nc + 5 Ns) C f32 per image of reads and writes; at (8, 400, 128) that
// is 3.3 GFLOP against ~15 MB, far above the card's bytes-to-FLOPs line, so
// f32 FMA issue on the CUDA cores bounds it (tensor-core mma with a stated
// tolerance is later work).
//
// Design (a first, simple version, the forward kernel's pattern):
//   * adaattn_dq: one CTA per (image, 64-query tile), 256 threads.  q, dm1,
//     dm2 of the tile stay in shared memory; the CTA loops over 64-key tiles
//     of k and v.  adaattn_dkv: one CTA per (image, 64-key tile); k and v
//     stay, the CTA loops over 64-query tiles of q, dm1, dm2, m, l, D.
//   * The logits tile (64 x 64) is split over a 16 x 16 thread grid: thread
//     (ty, tx) owns query rows ty*4+i and keys tx+16j.  All tiles are
//     row-major with a row stride of 132 floats, so both operands are read
//     as float4 along the channel axis without bank conflicts (the four
//     key rows of a quarter-warp start 4 banks apart).
//   * dq accumulates 4 rows x 8 channels per thread in registers (channels
//     tx*4 + 64h + e); dkv 4 keys x 8 channels of dk, P^T dm1 and P^T dm2
//     (96 registers).  P and dS pass through shared memory between the two
//     products of a tile.
//   * Ragged edges are masked as in the forward: key columns past Ns get a
//     logit of -1e30 (P = 0); query rows past Nc are zeros with m = 0, l = 1,
//     D = 0 (dS = 0, P dm = 0) and are not stored.
//   * Shared memory: dq 187,136 B, dkv 204,544 B (of 232,448): one CTA per
//     SM.  At 160px batch 8 a grid has 8 x 7 = 56 CTAs on 132 SMs; a split
//     over style tiles and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ast_kernels {
namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int C = 128;         // channels
constexpr int NT = 256;        // threads
constexpr int LD = C + 4;      // row stride of the q/dm/k/v tiles
constexpr int LDP = BK + 4;    // row stride of the P / dS tiles
constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64 * LD;
constexpr int DQ_SMEM_FLOATS = 5 * TILE + BK * LDP + 3 * BQ;
constexpr int DKV_SMEM_FLOATS = 5 * TILE + 2 * BQ * LDP + 3 * BQ;

static_assert(BQ == 64 && BK == 64 && NT == 256, "16x16 threads, 4x4 each");

// rows [row0, row0 + 64) of a (n, C) matrix into a row-major f32 tile;
// rows past n are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int n, int tid) {
  for (int idx = tid; idx < 64 * C; idx += NT) {
    const int r = idx / C, d = idx % C;
    dst[r * LD + d] =
        (row0 + r < n) ? to_f32(src[(size_t)(row0 + r) * C + d]) : 0.f;
  }
}

// m, l, D of rows [row0, row0 + 64); padded rows get m = 0, l = 1, D = 0.
__device__ __forceinline__ void load_row_terms(float* ms, float* ls, float* ds,
                                               const float* m, const float* l,
                                               const float* d, int row0, int n,
                                               int tid) {
  if (tid < BQ) {
    const bool ok = row0 + tid < n;
    ms[tid] = ok ? m[row0 + tid] : 0.f;
    ls[tid] = ok ? l[row0 + tid] : 1.f;
    ds[tid] = ok ? d[row0 + tid] : 0.f;
  }
}

// For the thread's query rows ty*4+i and keys tx+16j of the resident tiles:
// p = exp(q k^T - m) / l (keys past ns_left masked) and ds = p (T - D), with
// T = dm1 v^T + dm2 (v^2)^T.
__device__ __forceinline__ void p_and_ds(
    const float* qs, const float* d1s, const float* d2s, const float* ks,
    const float* vs, const float* ms, const float* ls, const float* Ds,
    int ty, int tx, int ns_left, float (&p)[4][4], float (&ds)[4][4]) {
  float s[4][4], t[4][4];
  adaattn_logits<C, LD>(qs, ks, ty, tx, s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = 0.f;

#pragma unroll 2
  for (int d = 0; d < C; d += 4) {
    float4 g1[4], g2[4], w[4], w2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g1[i] = *reinterpret_cast<const float4*>(&d1s[(ty * 4 + i) * LD + d]);
      g2[i] = *reinterpret_cast<const float4*>(&d2s[(ty * 4 + i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = *reinterpret_cast<const float4*>(&vs[(tx + 16 * j) * LD + d]);
      w2[j] = make_float4(w[j].x * w[j].x, w[j].y * w[j].y, w[j].z * w[j].z,
                          w[j].w * w[j].w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t[i][j] += dot4(g1[i], w[j]) + dot4(g2[i], w2[j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float mi = ms[r], li = ls[r], di = Ds[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sv = (tx + 16 * j < ns_left) ? s[i][j] : NEG_INF;
      p[i][j] = expf(sv - mi) / li;
      ds[i][j] = p[i][j] * (t[i][j] - di);
    }
  }
}

template <typename T, typename TD>
__global__ void __launch_bounds__(NT)
    adaattn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const TD* __restrict__ dm1,
                      const TD* __restrict__ dm2, const float* __restrict__ m,
                      const float* __restrict__ l, const float* __restrict__ D,
                      T* __restrict__ dq, int nc, int ns) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* d1s = qs + TILE;                       // [BQ][LD]
  float* d2s = d1s + TILE;                      // [BQ][LD]
  float* ks = d2s + TILE;                       // [BK][LD]
  float* vs = ks + TILE;                        // [BK][LD]
  float* dsT = vs + TILE;                       // [BK][LDP], dS transposed
  float* ms = dsT + BK * LDP;
  float* ls = ms + BQ;
  float* Ds = ls + BQ;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t qoff = (size_t)b * nc * C, koff = (size_t)b * ns * C;

  load_rows(qs, q + qoff, q0, nc, tid);
  load_rows(d1s, dm1 + qoff, q0, nc, tid);
  load_rows(d2s, dm2 + qoff, q0, nc, tid);
  load_row_terms(ms, ls, Ds, m + (size_t)b * nc, l + (size_t)b * nc,
                 D + (size_t)b * nc, q0, nc, tid);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < ns; k0 += BK) {
    __syncthreads();  // the previous tile's readers of ks and dsT are done
    load_rows(ks, k + koff, k0, ns, tid);
    load_rows(vs, v + koff, k0, ns, tid);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds(qs, d1s, d2s, ks, vs, ms, ls, Ds, ty, tx, ns - k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dsT[(tx + 16 * j) * LDP + ty * 4 + i] = ds[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 g = *reinterpret_cast<const float4*>(&dsT[kk * LDP + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&ks[kk * LD + tx * 4]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&ks[kk * LD + 64 + tx * 4]);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(gv[i], kv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= nc) continue;
    T* out = dq + qoff + (size_t)row * C;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[(e >> 2) * 64 + tx * 4 + (e & 3)] = from_f32<T>(acc[i][e]);
  }
}

template <typename T, typename TD>
__global__ void __launch_bounds__(NT)
    adaattn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const TD* __restrict__ dm1,
                       const TD* __restrict__ dm2, const float* __restrict__ m,
                       const float* __restrict__ l, const float* __restrict__ D,
                       T* __restrict__ dk, T* __restrict__ dv, int nc, int ns) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* vs = ks + TILE;                        // [BK][LD]
  float* qs = vs + TILE;                        // [BQ][LD]
  float* d1s = qs + TILE;                       // [BQ][LD]
  float* d2s = d1s + TILE;                      // [BQ][LD]
  float* ps = d2s + TILE;                       // [BQ][LDP], P
  float* dss = ps + BQ * LDP;                   // [BQ][LDP], dS
  float* ms = dss + BQ * LDP;
  float* ls = ms + BQ;
  float* Ds = ls + BQ;

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t qoff = (size_t)b * nc * C, koff = (size_t)b * ns * C;

  load_rows(ks, k + koff, k0, ns, tid);
  load_rows(vs, v + koff, k0, ns, tid);

  // Keys ty*4+a, channels tx*4 + 64h + e (index h*4 + e).
  float acc_k[4][8], acc_1[4][8], acc_2[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_k[a][e] = acc_1[a][e] = acc_2[a][e] = 0.f;

  for (int q0 = 0; q0 < nc; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(qs, q + qoff, q0, nc, tid);
    load_rows(d1s, dm1 + qoff, q0, nc, tid);
    load_rows(d2s, dm2 + qoff, q0, nc, tid);
    load_row_terms(ms, ls, Ds, m + (size_t)b * nc, l + (size_t)b * nc,
                   D + (size_t)b * nc, q0, nc, tid);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds(qs, d1s, d2s, ks, vs, ms, ls, Ds, ty, tx, ns - k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty * 4 + i) * LDP + tx + 16 * j] = p[i][j];
        dss[(ty * 4 + i) * LDP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

#pragma unroll 2
    for (int ii = 0; ii < BQ; ++ii) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[ii * LDP + ty * 4]);
      const float4 g4 =
          *reinterpret_cast<const float4*>(&dss[ii * LDP + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      float qv[8], d1v[8], d2v[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = ii * LD + h * 64 + tx * 4;
        const float4 a = *reinterpret_cast<const float4*>(&qs[off]);
        const float4 b1 = *reinterpret_cast<const float4*>(&d1s[off]);
        const float4 b2 = *reinterpret_cast<const float4*>(&d2s[off]);
        qv[h * 4 + 0] = a.x; qv[h * 4 + 1] = a.y;
        qv[h * 4 + 2] = a.z; qv[h * 4 + 3] = a.w;
        d1v[h * 4 + 0] = b1.x; d1v[h * 4 + 1] = b1.y;
        d1v[h * 4 + 2] = b1.z; d1v[h * 4 + 3] = b1.w;
        d2v[h * 4 + 0] = b2.x; d2v[h * 4 + 1] = b2.y;
        d2v[h * 4 + 2] = b2.z; d2v[h * 4 + 3] = b2.w;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc_k[a][e] = fmaf(gv[a], qv[e], acc_k[a][e]);
          acc_1[a][e] = fmaf(pv[a], d1v[e], acc_1[a][e]);
          acc_2[a][e] = fmaf(pv[a], d2v[e], acc_2[a][e]);
        }
    }
  }
  __syncthreads();  // vs is visible even when the query loop did not run

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty * 4 + a;
    if (key >= ns) continue;
    const size_t row = koff + (size_t)key * C;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = (e >> 2) * 64 + tx * 4 + (e & 3);
      const float vv = vs[(ty * 4 + a) * LD + c];
      dk[row + c] = from_f32<T>(acc_k[a][e]);
      dv[row + c] = from_f32<T>(acc_1[a][e] + 2.f * vv * acc_2[a][e]);
    }
  }
}

template <typename T, typename TD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dm1, const void* dm2, const void* m,
                      const void* l, const void* d, void* dq, int b, int nc,
                      int ns, cudaStream_t stream) {
  const int smem = DQ_SMEM_FLOATS * (int)sizeof(float);
  auto kernel = adaattn_dq_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nc + BQ - 1) / BQ, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TD*>(dm1),
      static_cast<const TD*>(dm2), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(d),
      static_cast<T*>(dq), nc, ns);
  return cudaGetLastError();
}

template <typename T, typename TD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dm1, const void* dm2, const void* m,
                       const void* l, const void* d, void* dk, void* dv, int b,
                       int nc, int ns, cudaStream_t stream) {
  const int smem = DKV_SMEM_FLOATS * (int)sizeof(float);
  auto kernel = adaattn_dkv_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((ns + BK - 1) / BK, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TD*>(dm1),
      static_cast<const TD*>(dm2), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(d),
      static_cast<T*>(dk), static_cast<T*>(dv), nc, ns);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ast_kernels

// q (b, nc, c), k and v (b, ns, c) in one dtype (bf16 if is_bf16, else f32);
// dm1, dm2 (b, nc, c) in bf16 if dm_bf16 (then q is bf16 too), else f32;
// m, l, d (b, nc) f32; dq (b, nc, c) in q's dtype.  c must be 128 and
// ns > 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int adaattn_dq_launch(const void* q, const void* k, const void* v,
                                 const void* dm1, const void* dm2,
                                 const void* m, const void* l, const void* d,
                                 void* dq, int b, int nc, int ns, int c,
                                 int is_bf16, int dm_bf16, void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0 || (dm_bf16 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch_dq<float, float>(q, k, v, dm1, dm2, m, l, d, dq, b, nc,
                                        ns, s);
  if (!dm_bf16)
    return (int)launch_dq<__nv_bfloat16, float>(q, k, v, dm1, dm2, m, l, d, dq,
                                                b, nc, ns, s);
  return (int)launch_dq<__nv_bfloat16, __nv_bfloat16>(q, k, v, dm1, dm2, m, l,
                                                      d, dq, b, nc, ns, s);
}

// The same inputs; dk, dv (b, ns, c) in k's dtype.  nc may be 0 (then dk
// and dv are zeros).
extern "C" int adaattn_dkv_launch(const void* q, const void* k, const void* v,
                                  const void* dm1, const void* dm2,
                                  const void* m, const void* l, const void* d,
                                  void* dk, void* dv, int b, int nc, int ns,
                                  int c, int is_bf16, int dm_bf16,
                                  void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0 || (dm_bf16 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch_dkv<float, float>(q, k, v, dm1, dm2, m, l, d, dk, dv, b,
                                         nc, ns, s);
  if (!dm_bf16)
    return (int)launch_dkv<__nv_bfloat16, float>(q, k, v, dm1, dm2, m, l, d,
                                                 dk, dv, b, nc, ns, s);
  return (int)launch_dkv<__nv_bfloat16, __nv_bfloat16>(q, k, v, dm1, dm2, m, l,
                                                       d, dk, dv, b, nc, ns, s);
}
