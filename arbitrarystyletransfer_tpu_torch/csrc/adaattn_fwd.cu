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
// supply it.  Two kernels, by input dtype:
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
// float32 (the training step): `adaattn_fwd_kernel<float>`, on the CUDA
// cores.  The training gates hold the step through this kernel against
// the plain twins and a float64 reference; TF32 or bf16 products would
// move them, so f32 inputs stay off the tensor cores.
//   * One CTA per (image, 64-query tile), 256 threads as a 16 x 16 grid,
//     looping over 64-key tiles staged in shared memory.
//   * Each thread computes a 4 x 4 block of the logits (rows ty*4+i, keys
//     tx+16j), the row max and sum with shuffles across the 16 threads of
//     its row (one half-warp), and accumulates 4 rows x 8 channels of A v
//     and A v^2 (64 sums).
//   * The logits are summed by `adaattn_logits` (common.cuh), as the
//     backward kernels sum them, so they are equal bit for bit: the
//     backward's P = exp(s - m) / l then sums to 1 to within rounding.  Otherwise each row's P is off by the two orders' rounding
//     of s, and the backward's row term D = sum(dm1 mean + dm2 ev2), which
//     P (dm1 v + dm2 v^2) must cancel, carries that error times
//     (mean / std)^2.
//   * At f32 the sums (A v, A v^2 and the row's sum of exp) accumulate in
//     f64, from exact f64 products of the f32 probabilities and values.
//     std^2 = ev2 - mean^2 cancels, so the sums' rounding reaches std
//     multiplied by (mean / std)^2, which reaches ~1e4 where a row's style
//     values lie close together, as on the training step's batches.
//     Accumulated in f32, the step's AdaAttN gradients landed ~26 times as
//     far from a float64 reference as the plain twin's (PERF.md).  The
//     logits, exp and row max stay f32.  The bf16 instantiation (only the
//     A/B entry below runs it) accumulates in f32, as it did.
//   * Shared memory 117,760 B: one CTA per SM.
// `adaattn_fwd_simt_launch` runs this kernel at bf16 too: the earlier bf16
// kernel, kept for the A/B of `chip_smoke.py`; no path calls it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace ast_kernels {
namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // style keys per tile
constexpr int C = 128;         // channels
constexpr int NT = 256;        // threads
constexpr int LD = C + 4;      // padded row of the q and k tiles
constexpr int LDT = BQ + 4;    // padded row of the transposed P tile
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_FLOATS = BQ * LD + BK * LD + BK * C + BK * LDT;

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float sqrt_pos(float x) {
  return sqrtf(fmaxf(x, 0.f));
}
__device__ __forceinline__ double sqrt_pos(double x) {
  return sqrt(fmax(x, 0.0));
}

template <typename T>
__global__ void __launch_bounds__(NT)
    adaattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ mean_out,
                       T* __restrict__ std_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int nc, int ns) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* ks = qs + BQ * LD;                     // [BK][LD]
  float* vs = ks + BK * LD;                     // [BK][C]
  float* pT = vs + BK * C;                      // [BK][LDT]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // logits: key cols tx+16j; products: chans tx*8+j
  const int ty = tid >> 4;  // query rows ty*4+i
  const T* qb = q + (size_t)b * nc * C;
  const T* kb = k + (size_t)b * ns * C;
  const T* vb = v + (size_t)b * ns * C;

  for (int idx = tid; idx < BQ * C; idx += NT) {
    const int r = idx / C, d = idx % C;
    qs[r * LD + d] = (q0 + r < nc) ? to_f32(qb[(size_t)(q0 + r) * C + d]) : 0.f;
  }

  // The sums' type: f64 for f32 inputs, f32 for bf16.
  using Acc = typename std::conditional<std::is_same<T, float>::value,
                                        double, float>::type;
  float m_i[4];
  Acc l_i[4], acc_m[4][8], acc_s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_m[i][j] = acc_s[i][j] = 0;
  }

  for (int k0 = 0; k0 < ns; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * C; idx += NT) {
      const int r = idx / C, d = idx % C;
      const bool ok = k0 + r < ns;
      const size_t off = (size_t)(k0 + r) * C + d;
      ks[r * LD + d] = ok ? to_f32(kb[off]) : 0.f;
      vs[r * C + d] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
    adaattn_logits<C, LD>(qs, ks, ty, tx, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= ns) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are one half-warp (lanes differ in bits 0-3).
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      Acc rs = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        pT[(tx + 16 * j) * LDT + ty * 4 + i] = p;
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
        const Acc vj = vv[j], v2 = vj * vj;  // exact in f64
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_m[i][j] = fma_acc(Acc(pv[i]), vj, acc_m[i][j]);
          acc_s[i][j] = fma_acc(Acc(pv[i]), v2, acc_s[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= nc) continue;
    const Acc inv_l = Acc(1) / l_i[i];
    const size_t base = ((size_t)b * nc + row) * C + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const Acc mean = acc_m[i][j] * inv_l;
      const Acc ev2 = acc_s[i][j] * inv_l;
      mean_out[base + j] = from_f32<T>((float)mean);
      std_out[base + j] = from_f32<T>((float)sqrt_pos(ev2 - mean * mean));
    }
    if (tx == 0) {
      m_out[(size_t)b * nc + row] = m_i[i];
      l_out[(size_t)b * nc + row] = (float)l_i[i];
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
// kernel, f32 the CUDA-core one.  Returns the cudaError_t of the launch (0
// on success).
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
  return (int)launch<float>(q, k, v, mean, stdv, m, l, b, nc, ns, s);
}

// The same function through the CUDA-core kernel at either dtype: the bf16
// kernel before the tensor-core one, for A/B timing only.
extern "C" int adaattn_fwd_simt_launch(const void* q, const void* k,
                                       const void* v, void* mean, void* stdv,
                                       void* m, void* l, int b, int nc, int ns,
                                       int c, int is_bf16, void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, mean, stdv, m, l, b, nc, ns, s);
  return (int)launch<float>(q, k, v, mean, stdv, m, l, b, nc, ns, s);
}
