// Streaming AdaAttN attention statistics (forward).
//
// Replaces the TPU kernel arbitrarystyletransfer_tpu/ops/pallas/
// adaattn_kernel.py `_fwd_kernel` (host wrapper `_adaattn_pallas_fwd`):
//
//   A    = softmax(q k^T)            unscaled logits, over the style axis
//   mean = A v,  ev2 = A v^2,  std = sqrt(max(ev2 - mean^2, 0))
//   m, l = the per-row running max and sum of exp (kept for the backward)
//
// The (Nc, Ns) attention matrix never reaches HBM: an online softmax streams
// over style tiles, and one product per tile accumulates A [v, v^2] (2C = 256
// columns).  A ragged style tail is masked with -1e30 as on the TPU; ragged
// query rows are computed and not stored.
//
// What bounds it on an H100: at 512px batch 8 (B = 16 stacked images,
// Nc = Ns = 4096, C = 128) it is 2 * B * Nc * Ns * 3C = 206 GFLOP against
// ~100 MB of q, k, v and outputs, far above the card's ~295 FLOP/byte
// balance point: it is bound by arithmetic, and only the tensor cores can
// supply it.  Three kernels, by dtype and use:
//
// bfloat16 (the stylize routes): `adaattn_fwd_wgmma_kernel`, on the tensor
// cores through warpgroup MMAs (wgmma), f32 accumulators.
//   * One CTA per (image, 128 query rows): two consumer warpgroups of 64 rows
//     each and a producer warpgroup (16 x 32 = 512 CTAs at the taps shape,
//     ~3.9 waves of one CTA per SM).
//   * Producer warp 0 keeps TMA loads of K and V tiles (64 keys, 128-byte
//     swizzle) in flight in a ring of 2 stages, with mbarriers for "full"
//     and "empty"; Q (64 x 128 per warpgroup) is loaded once.
//   * S = Q K^T on wgmma m64n64k16 (A and B from shared memory, K-major): the
//     bf16 products are exact, so S differs from f32 only in summation order.
//   * Online softmax in registers on the accumulator fragment (each row lives
//     in the 4 threads of a quad), the correction applied to the accumulators;
//     exp through exp2 of pre-scaled logits.
//   * O += P [v, v^2]: P is rounded to bf16 in registers and is the register A
//     operand of wgmma m64n256k16 / m64n128k16; B is the V-side tile read
//     MN-major (the transpose bit).  v^2 of a bf16 v has at most 16
//     significant bits, so it is exactly hi + lo with two bf16 values; P hi
//     and P lo accumulate into the same ev2 accumulators, and the only new
//     rounding is P's (`adaattn_fwd_error_bound` in the wrapper bounds it).
//     Producer warps 1-3 form hi and lo from each arrived V tile in shared
//     memory (at the same swizzled offsets), so no extra HBM traffic, launch
//     or L2 reads are spent on them, on warps that would otherwise idle.
//   * Registers: the 64 x 256 f32 accumulator is 128 per consumer thread;
//     setmaxnreg gives the consumers 232 and the producers 40.
//   * Shared memory: Q 32 KB + 2 stages x (K 16 KB + [v, hi, lo] 48 KB).
// Measured on the H100 and not kept (PERF.md): a third ring stage, and
// [v, v^2] as three m64n128 products (which clears ptxas's C7511 warning
// that the m64n256 and m64n128 products, sharing accumulators, serialize).
//
// float32, training (every call that autograd records: the train, GAN and
// data-parallel steps): `adaattn_fwd_f64_kernel`, with every stage in
// float64: the logits as one chain of FP64 tensor-core products per
// (query, key) over the exact products (`adaattn_logits64`, common.cuh),
// the exponentials, the online rescale and the sums (CUDA cores), rounded
// to f32 once at the end.  Its outputs are then the float64 statistics
// rounded to f32, bit for bit but for ties at ~1e-15 of a value.  That is
// what the training step's gate needs: the step's loss moves by ~1e-5
// under 1-ulp changes of the AdaAttN statistics, so every forward that
// rounds anything to f32 earlier (f32 logits in any order, f32 logits from
// an exact f64 sum, f32 exponentials of exact logits) landed 3-6e-6
// (median) and up to ~3e-4 from the float64 step and failed its 1e-5 loss
// gate on 3-4 of 35 measured batches (PERF.md).
//   * One CTA per (image, 32-query tile), 256 threads, looping over 64-key
//     tiles: q, k and v are staged in shared memory as f64 (exact).
//   * The logits on the FP64 tensor cores (`adaattn_logits64`,
//     common.cuh: each warp a 16 x 16 block), through shared memory to a
//     16 x 16 thread grid: thread (ty, tx) takes rows 2ty, 2ty + 1 and keys
//     tx + 16j, the row max and sum with shuffles across its half-warp, and
//     accumulates A v and A v^2 of rows 2ty, 2ty + 1 at channels
//     2tx + 32e, 2tx + 32e + 1 (v^2 exact in f64) on the CUDA cores.
//   * The backward kernels form their logits with the same routine, so
//     they are equal bit for bit: the backward's P = exp(s - m) / l then
//     sums to 1 to within rounding.  m is returned rounded to f32 and l
//     rescaled to it, so P is exp(s - m) / l with the returned m.
//   * Shared memory 182,784 B: one CTA per SM; the grid is twice the 64-row
//     tiles' (104 CTAs at the training shape (8, 400, 400)).
// float32, serving (`adaattn_fwd_serve_kernel`, every f32 inference path:
// the stylize routes and the graph engine; ops/kernels/adaattn_fwd.py
// chooses it where autograd does not record the call).  The same function
// on the tensor cores in 3xTF32, `mma.sync.m16n8k8` with f32 accumulators,
// its products bounded at a third of the TF32 peak (1.249 ms at the taps
// shape).  What it keeps of f32's accuracy, and how:
//   * The second moment is taken about vbar, the values' per-image,
//     per-channel mean over the keys (the wrapper's): mean = A v, and with
//     vc = v - vbar and mc = mean - vbar, std^2 = A vc^2 - mc^2, so an
//     offset of the values no longer cancels in std.
//   * v and vc^2 (rounded once in f32) are carried EXACTLY, each as three
//     truncated TF32 pieces (`tf32_pieces3`), and P as hi (to nearest) +
//     lo (read as the tensor cores read it): A v is P_hi (x3 + x2 + x1) +
//     P_lo x1, smallest first, the same for vc^2, and l sums P_hi + P_lo,
//     the one P of both products.  So a one-hot row gives mean = v and std
//     = 0 exactly, and ev2 - mean^2 stays the variance of one distribution
//     (two pieces left std ~2^-11 |v| there, and the mean taken as vbar +
//     A vc missed v by an ulp: the CPU emulation of this arithmetic in
//     ops/kernels/adaattn_fwd.py, tests/test_torch_adaattn_f32serve.py).
//   * The logits are q hi k lo + q lo k hi + q hi k hi (`split_tf32`),
//     summed in partials of two k8 steps from zero (the tensor cores add
//     rounding toward zero), each partial added to the logit in f32 to
//     nearest; each k8 step's products with [v, vc^2] are likewise summed
//     from zero and added to the accumulators to nearest.  A chain of
//     truncating adds biased ev2 and mean^2 apart in peaked rows (std ~3x
//     the f32 twin's error in the emulation); per step it is below the
//     twin's.
//   * One CTA per (image, 128 query rows, chunk of the style axis), 8 warps
//     of 16 rows each, looping over 32-key tiles: q (f32, 67.6 KB) and a
//     ring of 3 k and v tiles (cp.async, rows of 132 words: every fragment
//     load is free of bank conflicts) in shared memory, 169.5 KB, one CTA
//     per SM.  S (16 x 32 per warp) becomes P in registers, its
//     accumulator fragment reused as the A fragment of the P [v, vc^2]
//     product by ordering each k8 step's keys 2t, 2t + 1 as t, t + 4 (the
//     v rows are read in that order).  The 16 x 256 accumulators are 128
//     registers per thread.
//   * Grids smaller than the card (the CLI's 320px request: 1 x 1600
//     queries, 13 CTAs) split the style axis over CTAs (`serve_splits` in
//     the wrapper): each writes its unnormalized sums and (m, l), and
//     `adaattn_fwd_serve_combine` merges them and finishes the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ast_kernels {
namespace {

constexpr int C = 128;  // channels
constexpr int NT = 256;  // threads of the float64 kernel

// ---------------------------------------------------------------------------
// float32: every stage in float64 on the CUDA cores.
namespace f64k {

constexpr int BQ = 32;         // query rows per CTA
constexpr int BK = 64;         // style keys per tile
constexpr int LDP = BQ + 2;    // row of the transposed P tile (doubles)
constexpr double NEG_INF = -1e300;
constexpr int SMEM_BYTES = ((BQ + BK) * LDD + BK * C + BK * LDP) * 8;

__global__ void __launch_bounds__(NT, 1)
    adaattn_fwd_f64_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ mean_out,
                           float* __restrict__ std_out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int nc, int ns) {
  extern __shared__ double2 smem2[];
  double* qs = reinterpret_cast<double*>(smem2);  // [BQ][LDD]
  double* ks = qs + BQ * LDD;                     // [BK][LDD]
  double* vs = ks + BK * LDD;                     // [BK][C]
  double* pT = vs + BK * C;                       // [BK][LDP]: s, then P

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // softmax: keys tx+16j; sums: channels 2tx+32e
  const int ty = tid >> 4;  // query rows 2ty, 2ty+1
  // The logits: warp w forms rows 16 (w % 2) .. + 15 and keys
  // 16 (w / 2) .. + 15 of the tile (accumulator fragments).
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int sr = 16 * (warp & 1), sk = 16 * (warp >> 1);
  const float* kb = k + (size_t)b * ns * C;
  const float* vb = v + (size_t)b * ns * C;
  stage_f64<C>(qs, q + (size_t)b * nc * C, q0, BQ, nc, tid, NT);

  double m_i[2], l_i[2], acc_m[2][8], acc_s[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.0;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_m[i][e] = acc_s[i][e] = 0.0;
  }
  const int rows[2] = {2 * ty, 2 * ty + 1};
  const int keys[4] = {tx, tx + 16, tx + 32, tx + 48};

  for (int k0 = 0; k0 < ns; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage_f64<C>(ks, kb, k0, BK, ns, tid, NT);
    for (int idx = tid; idx < BK * (C / 2); idx += NT) {
      const int r = idx / (C / 2), c = 2 * (idx % (C / 2));
      double2 w = make_double2(0.0, 0.0);
      if (k0 + r < ns)
        w = make_double2(vb[(size_t)(k0 + r) * C + c],
                         vb[(size_t)(k0 + r) * C + c + 1]);
      *reinterpret_cast<double2*>(&vs[r * C + c]) = w;
    }
    __syncthreads();

    {
      double sb[2][4];
      const double* ra = qs + (sr + g) * LDD + t;
      const double* rb = ks + (sk + g) * LDD + t;
      adaattn_logits64<2>(
          [&](int c, double& a0, double& a1) {
            a0 = ra[c];
            a1 = ra[8 * LDD + c];
          },
          [&](int nb, int c) { return rb[8 * nb * LDD + c]; }, sb);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pT[(sk + 8 * nb + 2 * t + (e & 1)) * LDP + sr + g + 8 * (e >> 1)] =
              sb[nb][e];
    }
    __syncthreads();
    // Each thread reads the logits it then overwrites with P.
    double s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = pT[keys[j] * LDP + rows[i]];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      double mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + keys[j] >= ns) s[i][j] = NEG_INF;
        mx = fmax(mx, s[i][j]);
      }
      // The 16 threads of a row are one half-warp (lanes differ in bits 0-3).
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const double m_new = fmax(m_i[i], mx);
      const double corr = exp(m_i[i] - m_new);
      double rs = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double p = exp(s[i][j] - m_new);
        rs += p;
        pT[keys[j] * LDP + rows[i]] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc_m[i][e] *= corr;
        acc_s[i][e] *= corr;
      }
    }
    __syncthreads();

    const int kn = min(BK, ns - k0);
#pragma unroll 2
    for (int kk = 0; kk < kn; ++kk) {
      const double2 p2 =
          *reinterpret_cast<const double2*>(&pT[kk * LDP + 2 * ty]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double2 w =
            *reinterpret_cast<const double2*>(&vs[kk * C + 2 * tx + 32 * e]);
        const double w0 = w.x * w.x, w1 = w.y * w.y;  // exact
        acc_m[0][2 * e] = fma(p2.x, w.x, acc_m[0][2 * e]);
        acc_m[0][2 * e + 1] = fma(p2.x, w.y, acc_m[0][2 * e + 1]);
        acc_s[0][2 * e] = fma(p2.x, w0, acc_s[0][2 * e]);
        acc_s[0][2 * e + 1] = fma(p2.x, w1, acc_s[0][2 * e + 1]);
        acc_m[1][2 * e] = fma(p2.y, w.x, acc_m[1][2 * e]);
        acc_m[1][2 * e + 1] = fma(p2.y, w.y, acc_m[1][2 * e + 1]);
        acc_s[1][2 * e] = fma(p2.y, w0, acc_s[1][2 * e]);
        acc_s[1][2 * e + 1] = fma(p2.y, w1, acc_s[1][2 * e + 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rows[i];
    if (row >= nc) continue;
    const size_t base = ((size_t)b * nc + row) * C;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 mo, so;
      const double mean0 = acc_m[i][2 * e] / l_i[i];
      const double mean1 = acc_m[i][2 * e + 1] / l_i[i];
      mo.x = (float)mean0;
      mo.y = (float)mean1;
      so.x = (float)sqrt(fmax(acc_s[i][2 * e] / l_i[i] - mean0 * mean0, 0.0));
      so.y = (float)sqrt(fmax(acc_s[i][2 * e + 1] / l_i[i] - mean1 * mean1,
                              0.0));
      const int c = 2 * tx + 32 * e;
      *reinterpret_cast<float2*>(&mean_out[base + c]) = mo;
      *reinterpret_cast<float2*>(&std_out[base + c]) = so;
    }
    if (tx == 0) {
      // m rounded to f32, and l rescaled to it: the backward forms
      // exp(s - m) / l with these two.
      const float m32 = (float)m_i[i];
      m_out[(size_t)b * nc + row] = m32;
      l_out[(size_t)b * nc + row] =
          (float)(l_i[i] * exp(m_i[i] - (double)m32));
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* mean,
                   void* stdv, void* m, void* l, int b, int nc, int ns,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      adaattn_fwd_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((nc + BQ - 1) / BQ, b);
  adaattn_fwd_f64_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(mean),
      static_cast<float*>(stdv), static_cast<float*>(m),
      static_cast<float*>(l), nc, ns);
  return cudaGetLastError();
}

}  // namespace f64k


// ---------------------------------------------------------------------------
// float32, serving: 3xTF32 on the tensor cores (mma.sync).
namespace sv {

constexpr int BQ = 128;               // query rows per CTA (8 warps of 16)
constexpr int BK = 32;                // style keys per tile
constexpr int NTH = 256;
constexpr int LDW = C + 4;            // row stride (words) of every tile
constexpr int STAGES = 3;             // ring slots of (k, v) tiles
constexpr int TILE = BK * LDW;        // words of one k or v tile
constexpr int SMEM_BYTES = (BQ * LDW + STAGES * 2 * TILE + C) * 4;
constexpr float NEG = -1e30f;
constexpr uint32_t TF_MASK = 0xffffe000u;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of an (n, C) f32 matrix into a tile of row
// stride LDW by 16-byte asynchronous copies; rows at or past `end` are
// zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int end) {
  for (int i = threadIdx.x; i < rows * (C / 4); i += NTH) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    const bool ok = row0 + r < end;
    cp_async16(dst + r * LDW + 4 * c4,
               src + (size_t)(ok ? row0 + r : 0) * C + 4 * c4, ok);
  }
}

// x = w[0] + w[1] + w[2] exactly, each a TF32 value: the top 11
// significant bits, the next 11, the last 2 (truncated splits, so every
// subtraction is exact).
__device__ __forceinline__ void tf32_pieces3(float x, uint32_t (&w)[3]) {
  w[0] = __float_as_uint(x) & TF_MASK;
  const float r = __fsub_rn(x, __uint_as_float(w[0]));
  w[1] = __float_as_uint(r) & TF_MASK;
  w[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(w[1])));
}

// One 8-key step of A x (x: v or vc^2, given as its pieces) into d
// (zeroed first), smallest products first: P_hi x3 + P_hi x2 + P_lo x1 +
// P_hi x1.
__device__ __forceinline__ void pv_step(float (&d)[4], const uint32_t (&ph)[4],
                                        const uint32_t (&pl)[4],
                                        const uint32_t (&w0)[3],
                                        const uint32_t (&w1)[3]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
  mma_tf32(d, ph, w0[2], w1[2]);
  mma_tf32(d, ph, w0[1], w1[1]);
  mma_tf32(d, pl, w0[0], w1[0]);
  mma_tf32(d, ph, w0[0], w1[0]);
}

// mean = A v, std = sqrt(max(A vc^2 - (mean - vbar)^2, 0)) from the
// unnormalized sums; each product and difference rounded once, never
// fused (a one-hot row's (mean - vbar)^2 then equals its A vc^2 bit for
// bit).
__device__ __forceinline__ void finish(float om, float os, float inv_l,
                                       float vb, float& mean, float& sd) {
  mean = __fmul_rn(om, inv_l);
  const float mc = __fsub_rn(mean, vb), e2 = __fmul_rn(os, inv_l);
  sd = sqrtf(fmaxf(__fsub_rn(e2, __fmul_rn(mc, mc)), 0.f));
}

__global__ void __launch_bounds__(NTH, 1)
    adaattn_fwd_serve_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ vbar,
                             float* __restrict__ mean_out,
                             float* __restrict__ std_out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ part, int nc, int ns,
                             int per_split) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LDW]
  float* ring = qs + BQ * LDW;                  // [STAGES][k, v][BK][LDW]
  float* vbs = ring + STAGES * 2 * TILE;        // [C]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kbeg = blockIdx.z * per_split;
  const int kend = min(ns, kbeg + per_split);
  const int ntiles = (kend - kbeg + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const float* kb = k + (size_t)b * ns * C;
  const float* vb = v + (size_t)b * ns * C;

  load_rows(qs, q + (size_t)b * nc * C, q0, BQ, nc);
  if (tid < C) vbs[tid] = vbar[b * C + tid];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) {
      load_rows(ring + s * 2 * TILE, kb, kbeg + s * BK, BK, kend);
      load_rows(ring + s * 2 * TILE + TILE, vb, kbeg + s * BK, BK, kend);
    }
    cp_async_commit();
  }

  // Accumulators: o[0] A v, o[1] A vc^2; [n][e] is row g + 8 (e >> 1),
  // channel 8 n + 2 t + (e & 1) of the warp's 16 rows.
  float o[2][16][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[x][n][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const float* qw = qs + (16 * warp + g) * LDW + t;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j is in, and every warp is done with j - 1
    {
      const int jn = j + STAGES - 1;
      if (jn < ntiles) {
        float* st = ring + (jn % STAGES) * 2 * TILE;
        load_rows(st, kb, kbeg + jn * BK, BK, kend);
        load_rows(st + TILE, vb, kbeg + jn * BK, BK, kend);
      }
      cp_async_commit();
    }
    const float* ks = ring + (j % STAGES) * 2 * TILE;
    const float* vs = ks + TILE;
    const int k0 = kbeg + j * BK;

    // S = Q K^T (16 x 32): lo hi + hi lo + hi hi per k8 step, partials of
    // two steps from zero added to nearest.
    float sc[4][4], sp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += 8) {
      if ((c0 & 8) == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[n][e] = 0.f;
      }
      uint32_t ah[4], al[4];
      split_tf32(qw[c0], ah[0], al[0]);
      split_tf32(qw[8 * LDW + c0], ah[1], al[1]);
      split_tf32(qw[c0 + 4], ah[2], al[2]);
      split_tf32(qw[8 * LDW + c0 + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* kr = ks + (8 * n + g) * LDW + c0 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_tf32(sp[n], al, bh0, bh1);
        mma_tf32(sp[n], ah, bl0, bl1);
        mma_tf32(sp[n], ah, bh0, bh1);
      }
      if (c0 & 8) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = __fadd_rn(sc[n][e], sp[n][e]);
      }
    }

    // The online softmax: sc[n][e] is row g + 8 (e >> 1), key 8 n + 2 t +
    // (e & 1); a row lives in the 4 threads of a quad.
    if (k0 + BK > kend) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + 2 * t + (e & 1) >= kend) sc[n][e] = NEG;
    }
    float mx[2] = {m_r[0], m_r[1]}, corr[2];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] = __fmul_rn(l_r[r], corr[r]);
    }
    // P as hi + lo, in the A fragment order of the P [v, vc^2] product:
    // key 2t of a k8 step is its k index t, key 2t + 1 its t + 4.
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - mx[e >> 1]);
        const uint32_t hi = (__float_as_uint(p) + 0x1000u) & TF_MASK;
        const uint32_t lo =
            __float_as_uint(__fsub_rn(p, __uint_as_float(hi))) & TF_MASK;
        l_r[e >> 1] = __fadd_rn(
            l_r[e >> 1], __fadd_rn(__uint_as_float(hi), __uint_as_float(lo)));
        const int a = 2 * (e & 1) + (e >> 1);
        ph[n][a] = hi;
        pl[n][a] = lo;
      }

#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[x][n][e] = __fmul_rn(o[x][n][e], corr[e >> 1]);
    // O += P [v, vc^2]: channel tile n, key step kk; b0 and b1 are the
    // values of keys 8 kk + 2 t and 8 kk + 2 t + 1 at channel 8 n + g.
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float vbn = vbs[8 * n + g];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vr = vs + (8 * kk + 2 * t) * LDW + 8 * n + g;
        const float x0 = vr[0], x1 = vr[LDW];
        const float c0 = __fsub_rn(x0, vbn), c1 = __fsub_rn(x1, vbn);
        uint32_t w0[3], w1[3];
        float d[4];
        tf32_pieces3(x0, w0);
        tf32_pieces3(x1, w1);
        pv_step(d, ph[kk], pl[kk], w0, w1);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[0][n][e] = __fadd_rn(o[0][n][e], d[e]);
        tf32_pieces3(__fmul_rn(c0, c0), w0);
        tf32_pieces3(__fmul_rn(c1, c1), w1);
        pv_step(d, ph[kk], pl[kk], w0, w1);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[1][n][e] = __fadd_rn(o[1][n][e], d[e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] = __fadd_rn(l_r[r], __shfl_xor_sync(0xffffffffu, l_r[r], 1));
    l_r[r] = __fadd_rn(l_r[r], __shfl_xor_sync(0xffffffffu, l_r[r], 2));
  }
  const int rows = gridDim.y * nc;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= nc) continue;
    const size_t r = (size_t)b * nc + row;
    if (gridDim.z == 1) {
      const float inv_l = 1.f / l_r[h];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = 8 * n + 2 * t;
        float2 mo, so;
        finish(o[0][n][2 * h], o[1][n][2 * h], inv_l, vbs[c], mo.x, so.x);
        finish(o[0][n][2 * h + 1], o[1][n][2 * h + 1], inv_l, vbs[c + 1],
               mo.y, so.y);
        *reinterpret_cast<float2*>(&mean_out[r * C + c]) = mo;
        *reinterpret_cast<float2*>(&std_out[r * C + c]) = so;
      }
      if (t == 0) {
        m_out[r] = m_r[h];
        l_out[r] = l_r[h];
      }
    } else {
      // This chunk's sums ([split][row][2C]) and (m, l) ([split][row][2])
      // for adaattn_fwd_serve_combine.
      float* pr = part + ((size_t)blockIdx.z * rows + r) * 2 * C;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(&pr[c]) =
            make_float2(o[0][n][2 * h], o[0][n][2 * h + 1]);
        *reinterpret_cast<float2*>(&pr[C + c]) =
            make_float2(o[1][n][2 * h], o[1][n][2 * h + 1]);
      }
      if (t == 0) {
        float* ml = part + (size_t)gridDim.z * rows * 2 * C;
        *reinterpret_cast<float2*>(&ml[((size_t)blockIdx.z * rows + r) * 2]) =
            make_float2(m_r[h], l_r[h]);
      }
    }
  }
}

// Merges the chunks of the style axis: m = max m_s, and l and the sums
// as fma chains over the chunks in order, each scaled by exp(m_s - m); then
// finishes the rows as the kernel does.  One warp per row, lane j on
// channels 4 j .. 4 j + 3.
__global__ void __launch_bounds__(256)
    adaattn_fwd_serve_combine(const float* __restrict__ part,
                              const float* __restrict__ vbar,
                              float* __restrict__ mean_out,
                              float* __restrict__ std_out,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out, int rows, int nc,
                              int splits) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int c = 4 * (threadIdx.x & 31);
  const float* ml = part + (size_t)splits * rows * 2 * C;
  float mx = NEG;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, ml[((size_t)s * rows + r) * 2]);
  float l = 0.f, om[4] = {0.f, 0.f, 0.f, 0.f}, os[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float2 mls = *reinterpret_cast<const float2*>(
        &ml[((size_t)s * rows + r) * 2]);
    const float w = expf(mls.x - mx);
    l = fmaf(w, mls.y, l);
    const float* pr = part + ((size_t)s * rows + r) * 2 * C;
    const float4 a = *reinterpret_cast<const float4*>(&pr[c]);
    const float4 a2 = *reinterpret_cast<const float4*>(&pr[C + c]);
    om[0] = fmaf(w, a.x, om[0]);
    om[1] = fmaf(w, a.y, om[1]);
    om[2] = fmaf(w, a.z, om[2]);
    om[3] = fmaf(w, a.w, om[3]);
    os[0] = fmaf(w, a2.x, os[0]);
    os[1] = fmaf(w, a2.y, os[1]);
    os[2] = fmaf(w, a2.z, os[2]);
    os[3] = fmaf(w, a2.w, os[3]);
  }
  const float inv_l = 1.f / l;
  const float* vb = vbar + (size_t)(r / nc) * C + c;
  float4 mo, so;
  finish(om[0], os[0], inv_l, vb[0], mo.x, so.x);
  finish(om[1], os[1], inv_l, vb[1], mo.y, so.y);
  finish(om[2], os[2], inv_l, vb[2], mo.z, so.z);
  finish(om[3], os[3], inv_l, vb[3], mo.w, so.w);
  *reinterpret_cast<float4*>(&mean_out[(size_t)r * C + c]) = mo;
  *reinterpret_cast<float4*>(&std_out[(size_t)r * C + c]) = so;
  if (c == 0) {
    m_out[r] = mx;
    l_out[r] = l;
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* vbar, void* mean, void* stdv, void* m, void* l,
                   void* part, int b, int nc, int ns, int splits,
                   int per_split, cudaStream_t stream) {
  if (per_split <= 0 || per_split % BK != 0 || splits < 1 ||
      (long long)splits * per_split < ns ||
      (long long)(splits - 1) * per_split >= ns ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (!aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      adaattn_fwd_serve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((nc + BQ - 1) / BQ, b, splits);
  adaattn_fwd_serve_kernel<<<grid, NTH, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(vbar),
      static_cast<float*>(mean), static_cast<float*>(stdv),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(part), nc, ns, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int rows = b * nc;
  adaattn_fwd_serve_combine<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(vbar),
      static_cast<float*>(mean), static_cast<float*>(stdv),
      static_cast<float*>(m), static_cast<float*>(l), rows, nc, splits);
  return cudaGetLastError();
}

}  // namespace sv


// ---------------------------------------------------------------------------
// bfloat16: warpgroup MMAs fed by TMA.
namespace tc {

constexpr int BQ = 128;               // query rows per CTA (2 warpgroups)
constexpr int BK = 64;                // style keys per tile
constexpr int BOX = 64 * 64 * 2;      // one TMA box: 64 rows x 64 bf16
constexpr int Q_BYTES = 4 * BOX;      // 2 warpgroups x 2 channel halves
constexpr int STAGE_BYTES = 8 * BOX;  // K (2 boxes), then v, hi, lo (2 each)
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;         // consumer warpgroups 0-1, producer 2
constexpr int HILO_THREADS = 96;      // producer warps 1-3
constexpr float LOG2E = 1.4426950408889634f;

// 1 KB of slack to align the swizzled tiles to 1024 bytes, then barriers.
constexpr int SMEM_BYTES = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 24 * STAGES
                           + 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(v^2), lo = v^2 - hi (exact in bf16) for 8 bf16 values.
__device__ __forceinline__ void split_square(uint4 v, uint4& hi, uint4& lo) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&in[i]));
    const float a = f.x * f.x, b = f.y * f.y;  // exact in f32
    const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(hv);
    h[i] = *reinterpret_cast<const uint32_t*>(&hv);
    l[i] = pack_bf16(a - hf.x, b - hf.y);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    adaattn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ mean_out,
                             __nv_bfloat16* __restrict__ std_out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int nc, int ns) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* ring = smem + Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* vready = full + STAGES;
  uint64_t* empty = vready + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (ns + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&vready[s], HILO_THREADS);
      mbar_init(&empty[s], 256);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: TMA (warp 0, one thread), hi/lo (warps 1-3)
    setmaxnreg_dec<40>();
    const int pt = tid - 256;
    if (pt == 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int g = 0; g < 2; ++g)
        for (int c = 0; c < 2; ++c)
          tma_load_3d(sq + (2 * g + c) * BOX, &qmap, 64 * c, q0 + 64 * g, b,
                      qbar);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        // Slot s last held tile j - STAGES: wait until both consumer
        // warpgroups are done with it.
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], 4 * BOX);
        tma_load_3d(st, &kmap, 0, j * BK, b, &full[s]);
        tma_load_3d(st + BOX, &kmap, 64, j * BK, b, &full[s]);
        tma_load_3d(st + 2 * BOX, &vmap, 0, j * BK, b, &full[s]);
        tma_load_3d(st + 3 * BOX, &vmap, 64, j * BK, b, &full[s]);
      }
    } else if (pt >= 32) {
      const int ht = pt - 32;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&full[s], (j / STAGES) & 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        const uint4* vt = reinterpret_cast<const uint4*>(st + 2 * BOX);
        uint4* hi = reinterpret_cast<uint4*>(st + 4 * BOX);
        uint4* lo = reinterpret_cast<uint4*>(st + 6 * BOX);
        // The swizzle permutes 16-byte chunks inside each 1024-byte atom the
        // same way in every box, so hi and lo sit at v's offsets.
        for (int i = ht; i < 2 * BOX / 16; i += HILO_THREADS) {
          uint4 h, l;
          split_square(vt[i], h, l);
          hi[i] = h;
          lo[i] = l;
        }
        fence_proxy_async();  // the generic writes, before wgmma reads them
        mbar_arrive(&vready[s]);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    setmaxnreg_inc<232>();
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;
    const uint8_t* myq = sq + wg * 2 * BOX;
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    // Each thread holds rows r0 = 16 warp + lane / 4 (half 0) and r0 + 8
    // (half 1) of the accumulators: element i is row half (i >> 1) & 1,
    // column 8 (i >> 2) + 2 (lane & 3) + (i & 1).
    float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      const uint8_t* st = ring + s * STAGE_BYTES;
      mbar_wait(&full[s], ph);

      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int off = (kk >> 2) * BOX + (kk & 3) * 32;
        wgmma_ss_n64(sc, smem_desc(myq + off, 16, 1024),
                     smem_desc(st + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      if ((j + 1) * BK > ns) {  // the ragged tail of the style axis
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (j * BK + col >= ns) sc[i] = -1e30f;
        }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m_r[r] - mx[r]) * LOG2E);
        neg[r] = -mx[r] * LOG2E;
        m_r[r] = mx[r];
        l_r[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], LOG2E, neg[r]));
        l_r[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= corr[(i >> 1) & 1];
      // P as the A fragments of the four 16-key steps.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      mbar_wait(&vready[s], ph);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* vk = st + 2 * BOX + kk * 16 * 128;  // 16 keys down
        wgmma_rs_n256<0>(o, pa[kk], smem_desc(vk, BOX, 1024));  // v, hi
        wgmma_rs_n128<64>(o, pa[kk], smem_desc(vk + 4 * BOX, BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= nc) continue;
      const float inv_l = 1.f / l_r[h];
      const size_t base = ((size_t)b * nc + row) * C + 2 * (lane & 3);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int i = 4 * jj + 2 * h;
        const float mean0 = o[i] * inv_l, mean1 = o[i + 1] * inv_l;
        const float ev0 = o[i + 64] * inv_l, ev1 = o[i + 65] * inv_l;
        const float sd0 = sqrtf(fmaxf(ev0 - mean0 * mean0, 0.f));
        const float sd1 = sqrtf(fmaxf(ev1 - mean1 * mean1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(mean_out + base + 8 * jj) =
            __floats2bfloat162_rn(mean0, mean1);
        *reinterpret_cast<__nv_bfloat162*>(std_out + base + 8 * jj) =
            __floats2bfloat162_rn(sd0, sd1);
      }
      if ((lane & 3) == 0) {
        m_out[(size_t)b * nc + row] = m_r[h];
        l_out[(size_t)b * nc + row] = l_r[h];
      }
    }
  }
}

// (b, rows, 128) bf16 as a 3-d map of 64 x 64 boxes (channels innermost),
// 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* base, int rows, int b) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)rows * C * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const void* q, const void* k, const void* v, void* mean,
                   void* stdv, void* m, void* l, int b, int nc, int ns,
                   cudaStream_t stream) {
  if (!aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16))
    return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, nc, b) || !make_map(&kmap, k, ns, b) ||
      !make_map(&vmap, v, ns, b))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      adaattn_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((nc + BQ - 1) / BQ, b);
  adaattn_fwd_wgmma_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(mean),
      static_cast<__nv_bfloat16*>(stdv), static_cast<float*>(m),
      static_cast<float*>(l), nc, ns);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
}  // namespace ast_kernels

// q (b, nc, c), k and v (b, ns, c); mean, std (b, nc, c) in the input dtype;
// m, l (b, nc) f32.  c must be 128 and ns > 0.  bf16 takes the tensor-core
// kernel, f32 the float64 one (the training step's).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int adaattn_fwd_launch(const void* q, const void* k, const void* v,
                                  void* mean, void* stdv, void* m, void* l,
                                  int b, int nc, int ns, int c, int is_bf16,
                                  void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tc::launch(q, k, v, mean, stdv, m, l, b, nc, ns, s);
  return (int)f64k::launch(q, k, v, mean, stdv, m, l, b, nc, ns, s);
}

// The f32 serving form: q (b, nc, c), k and v (b, ns, c), vbar (b, c) the
// values' mean over the keys, all f32; mean, std (b, nc, c), m, l (b, nc)
// f32.  The style axis in `splits` chunks of `per_split` keys (a multiple
// of 32; the last chunk holds the rest); with more than one chunk, part is
// f32 scratch of splits * b * nc * (2c + 2) values.
extern "C" int adaattn_fwd_serve_launch(const void* q, const void* k,
                                        const void* v, const void* vbar,
                                        void* mean, void* stdv, void* m,
                                        void* l, void* part, int b, int nc,
                                        int ns, int c, int splits,
                                        int per_split, void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || nc == 0) return 0;
  return (int)sv::launch(q, k, v, vbar, mean, stdv, m, l, part, b, nc, ns,
                         splits, per_split, static_cast<cudaStream_t>(stream));
}
