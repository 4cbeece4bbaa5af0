// Streaming AdaAttN attention statistics (backward): dq, and dk with dv.
//
// Replaces the TPU kernels arbitrarystyletransfer_tpu/ops/pallas/
// adaattn_kernel.py `_dq_kernel` and `_dkv_kernel` (host wrapper
// `_adaattn_pallas_bwd`).  With O = [M1, M2] = A [v, v^2], A = softmax(q k^T)
// (unscaled logits) and the cotangents folded outside (the sqrt/relu chain is
// elementwise, in PyTorch: `fold_cotangents`), the backward is computed on
// the style values centred by their mean over the keys, vbar (per image and
// channel):
//
//   vc  = v - vbar                    subtracted here, as the tiles are read
//   dm1 = dmean - 2 (mean - vbar) g2,  dm2 = g2 = dstd / (2 std)
//   D   = sum_c dm1 (mean - vbar) + g2 (std^2 + (mean - vbar)^2)   (f64)
//   P   = exp(s - m) / l               s = q k^T recomputed per tile; m, l
//                                      the forward's row max and sum of exp
//   T   = dm1 vc^T + dm2 (vc^2)^T
//   dS  = P o (T - D)
//   dq  = dS k                         (adaattn_dq: summed over key tiles)
//   dk  = dS^T q                       (adaattn_dkv: summed over query tiles)
//   dv  = P^T dm1 + 2 vc o (P^T dm2)   vc is fixed per key: applied once
//
// The gradients are those of the JAX kernels' uncentred form.  For the keys
// that carry P, T - D is of the size of g2 std^2, while T and D are each of
// the size of g2 (mean^2 + spread^2): they cancel by up to (mean / std)^2
// uncentred (the mean's offset) and by the square of the style values'
// spread over their attention-weighted std after centring, up to ~1e4 on
// the training step's batches.  So T and D are formed in float64 from the
// f32 inputs: in f32, T - D carried their rounding amplified by that
// factor, 1e-3-scale errors in dq and dk on such batches in the twins and
// the kernels alike (PERF.md).  The centring keeps dv = P^T dm1 + 2 vc o
// (P^T dm2) from cancelling by |mean| / std, but its two terms still cancel
// by |vc| / std, ~1e4 on the most ill-conditioned training batches
// ((mean / std)^2 ~1e8): so dv's two products and their sum are float64
// too, from the exact f32 P and dm, rounded once per chunk of queries
// (in f32 its error reached 1.4e-3 of dv's largest value).  Everything
// else is f32 whatever the input dtype, as the TPU kernels cast to f32;
// neither P nor dS reaches HBM.
//
// What bounds it on an H100: per (query, key, channel) 2 f64 FLOPs of logits
// and 4 of T (both kernels), then 2 f32 FLOPs of dS k (dq), or 2 of dS^T q
// and 4 f64 FLOPs of P^T dm1, P^T dm2 (dkv), against ~(6 Nc + 5 Ns) C f32
// per image of reads and writes: operations bound it, at the f64 peak for
// the float64 products and a third of the TF32 peak for the others
// (3xTF32).
//
// Design (both kernels: 256 threads = 8 warps, one CTA per SM):
//   * The logits are formed as in the f32 forward kernel, by
//     `adaattn_logits64` (common.cuh): one chain of FP64 tensor-core
//     products (`mma.sync.m16n8k4.f64`) per (query, key) over the exact
//     products.  The backward's s is then the forward's bit for bit and P
//     sums to 1 against the forward's l.  T takes the same FP64 tensor
//     cores, one accumulator fragment per product and 8-column block.  An
//     f64 accumulator fragment has the TF32 one's layout (rows g, g + 8;
//     columns 2t, 2t + 1 of each 8-column block), so P and dS stay in
//     registers.
//   * dS k and dS^T q run on `mma.sync.m16n8k8` TF32 with
//     the 3xTF32 split (hi = x rounded to TF32, lo = x - hi; a b ~ hi hi +
//     hi lo + lo hi; f32 accumulators).  An accumulator fragment feeds the next
//     product as its A fragment without moving: its columns 2t, 2t + 1 are
//     taken as the A fragment's k-indices t, t + 4, and the B fragment reads
//     the rows 2t, 2t + 1 of the other operand to match.
//   * adaattn_dq: one CTA per (image, 32-query tile, key chunk); q, dm1 and
//     dm2 stay resident as f64 (landed by TMA, converted once); k and v
//     stream as 64-key tiles through a two-stage TMA ring (a full and an
//     empty mbarrier per stage: the next tile's copy in flight under the
//     current tile's products, no CTA-wide barrier per tile).  Warp w takes
//     query rows 16 (w % 2) .. + 15 and keys 16 (w / 2) .. + 15 of each
//     tile; the four key quarters' dq are added in shared memory at the
//     end, in order.
//   * adaattn_dkv: one CTA per (image, 64-key tile, query chunk); warps 0-3
//     form dk (s, T, dS^T q) and warps 4-7 dv (s, P^T dm1, P^T dm2), each
//     for keys 16 (w % 4) .. + 15 and all 32 queries of each tile, so a warp
//     holds 64 f32 (dk) or 64 f64 (dv) accumulators, and every SM runs both
//     kinds of work (as separate CTAs the dk ones set the pace).  The two
//     roles run separate code paths, so the two kinds of accumulators never
//     share the 255 registers.  A dv warp forms each tile's P^T dm1 and
//     P^T dm2 on the FP64 tensor cores (m16n8k4, P's f32 accumulator
//     fragment taken as the A fragment, as for TF32 below) two 8-channel
//     blocks at a time and adds P^T dm1 + 2 vc o P^T dm2 into its f64
//     accumulators at once, so the two products never need 128 more.  The dv warps
//     form s and hand it to the dk warps of the same keys through shared
//     memory (a named barrier per warp pair for full, one for free), which
//     evens out the two groups' work; P and dS are formed in registers.
//     k (as f64) and v stay resident (landed by TMA like dq's); q, dm1, dm2
//     stream as 32-query tiles through the ring; m, l, D are loaded at a
//     tile's start and first used after its logits.
//   * The streamed f32 operands are converted to f64 where they are read
//     (each value once per warp that reads it), the resident ones once.
//   * The reduction axis (keys for dq, queries for dkv) is cut into chunks
//     of whole tiles where that takes fewer waves of CTAs (`choose_splits`:
//     dkv's queries in two at the training shape (8, 400, 400), 112 CTAs;
//     none for dq there, nor at (16, 4096, 4096)).  Each chunk writes f32
//     partial sums to a scratch the wrapper allocates, and `reduce_splits`
//     adds them in chunk order: deterministic, no atomics.
//   * Tiles are TMA boxes of 128-byte rows with the 128-byte swizzle, so
//     the fragment reads are free of bank conflicts; the f64 tiles have
//     rows of 130 doubles (LDD).  Warps whose 16 rows (queries or keys) lie
//     wholly past Nc or Ns skip the work; key columns past Ns and query
//     columns past Nc have P = 0; query rows past Nc have m = 0, l = 1,
//     D = 0 and are not stored.
//   * Shared memory: dq 230,952 B, dkv 215,080 B (+1 KB to align the
//     boxes): one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace ast_kernels {
namespace {

constexpr int C = 128;   // channels
constexpr int NT = 256;  // threads: 8 warps
constexpr int STAGES = 2;

// Parts cut out for the ablation of `adaattn_bwd_cut_launch` (timing only;
// the results are wrong): the tensor-core products (their operands are
// still formed), the ring's prefetch (each tile copied and awaited in
// turn), the f64 logits, dkv's f64 dv products (their epilogue kept).
enum Cut { kNone = 0, kNoMma = 1, kSyncStage = 2, kNoLogits = 3, kNoDv = 4 };

// Element (r, c) of a tile of R rows x 128 channels that TMA staged as
// boxes of 128-byte rows (32 f32 or 64 bf16 channels, box b at
// b * R * 128 bytes) with the 128-byte swizzle (16-byte chunk k of row r at
// k ^ (r & 7)).  The tile starts 1024-byte aligned.
template <typename E, int R>
__device__ __forceinline__ float tld(const E* t, int r, int c) {
  constexpr int PER = 128 / sizeof(E), CH = 16 / sizeof(E);
  const int bx = c / PER, cc = c % PER;
  return to_f32(t[bx * R * PER + r * PER + ((((cc / CH) ^ (r & 7)) * CH) |
                                            (cc % CH))]);
}

// tld with the row's swizzle key r & 7 given: the hot loops pass a key
// they computed once (rows 8 k + x share x & 7).
template <typename E, int R>
__device__ __forceinline__ float tldk(const E* t, int r, int c, int key) {
  constexpr int PER = 128 / sizeof(E), CH = 16 / sizeof(E);
  const int bx = c / PER, cc = c % PER;
  return to_f32(
      t[bx * R * PER + r * PER + ((((cc / CH) ^ key) * CH) | (cc % CH))]);
}

// The same layout, written by threads (f32 only).
template <int R>
__device__ __forceinline__ void tst(float* t, int r, int c, float x) {
  const int bx = c / 32, cc = c % 32;
  t[bx * R * 32 + r * 32 + ((((cc / 4) ^ (r & 7)) * 4) | (cc % 4))] = x;
}

template <typename E, int R>
__host__ __device__ constexpr int tile_bytes() {
  return R * C * (int)sizeof(E);
}

// Issues the TMA boxes of rows [row0, row0 + R) of image b of `map` (a 3-d
// map of 128-channel rows, built by make_tile_map) into `dst`.
template <typename E, int R>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         int row0, int b, uint64_t* bar) {
  constexpr int PER = 128 / sizeof(E);
#pragma unroll
  for (int bx = 0; bx < C / PER; ++bx)
    tma_load_3d(dst + bx * R * 128, map, bx * PER, row0, b, bar);
}

// -- 3xTF32 tensor-core products ----------------------------------------------

// split_tf32 and mma_tf32 are common.cuh's.

// An m16n8k8 A fragment (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4)) split into its TF32 parts.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// D += A B at f32 accuracy with B's elements b0 = (t, g), b1 = (t + 4, g):
// three TF32 products, the small terms first.
template <int CUT>
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  if (CUT == kNoMma) {
    // Keeps the operands alive at a few ALU operations.
    const uint32_t x = a.hi[0] ^ a.hi[1] ^ a.hi[2] ^ a.hi[3] ^ a.lo[0] ^
                       a.lo[1] ^ a.lo[2] ^ a.lo[3] ^ h0 ^ l0 ^ h1 ^ l1;
    d[0] += 0.f * __uint_as_float(x & 0x3f800000u);
    return;
  }
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// The A fragment of the next product from an accumulator fragment c of
// rows g, g + 8 and columns 2t, 2t + 1: k-index t is column 2t, k-index
// t + 4 column 2t + 1.
__device__ __forceinline__ void afrag_from_acc(AFrag& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
}

// The producer's side of the ring: thread 0 waits until every warp has
// released slot s's previous tile (use n - 1), then the caller issues.
__device__ __forceinline__ void wait_slot(uint64_t* empty, int n) {
  if (n > 0) mbar_wait(empty, (n - 1) & 1);
}

// Barrier `id` over a pair of warps (64 threads): the consumer waits, the
// producer only arrives.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// A consumer warp is done with a slot.
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// A TMA tile of R rows x 128 channels (tld's layout) into an f64 tile of
// row stride LDD, converted exactly by all threads.
template <typename E, int R>
__device__ __forceinline__ void tile_to_f64(double* dst, const E* src,
                                            int tid) {
  for (int idx = tid; idx < R * C / 2; idx += NT) {
    const int r = idx / (C / 2), c = 2 * (idx % (C / 2));
    *reinterpret_cast<double2*>(&dst[r * LDD + c]) =
        make_double2(tld<E, R>(src, r, c), tld<E, R>(src, r, c + 1));
  }
}

// =============================================================================
// adaattn_dq
namespace dq {

constexpr int BQ = 32;  // query rows per CTA (2 warps of 16)
constexpr int BK = 64;  // keys per tile (4 quarters of 16)

template <typename T, typename TD>
struct Smem {
  static constexpr int KV = tile_bytes<T, BK>();  // k or v of one tile
  static constexpr int STAGE = 2 * KV;
  static constexpr int Q64 = STAGES * STAGE;       // resident q, dm1, dm2
  static constexpr int D164 = Q64 + BQ * LDD * 8;  // as f64 (LDD rows)
  static constexpr int D264 = D164 + BQ * LDD * 8;
  static constexpr int BAR = D264 + BQ * LDD * 8;  // full, empty, resident
  static constexpr int BYTES = BAR + 16 * STAGES + 8;
  static constexpr int ALLOC = BYTES + 1024;  // to align the boxes
  static constexpr int LDR = C + 4;
  static_assert(STAGES * STAGE >= 3 * BQ * LDR * 4, "reduction buffer");
  static_assert(STAGES * STAGE >=
                    tile_bytes<T, BQ>() + 2 * tile_bytes<TD, BQ>(),
                "resident tiles' landing");
};

template <typename T, typename TD, int CUT>
__global__ void __launch_bounds__(NT, 1)
    adaattn_dq_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap d1map,
                      const __grid_constant__ CUtensorMap d2map,
                      const float* __restrict__ vbar,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const double* __restrict__ D, T* __restrict__ dq,
                      float* __restrict__ part, int nc, int ns, int nqt,
                      int splits) {
  using S = Smem<T, TD>;
  constexpr int AHEAD = CUT == kSyncStage ? 0 : STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  double* q64 = reinterpret_cast<double*>(sm + S::Q64);
  double* d164 = reinterpret_cast<double*>(sm + S::D164);
  double* d264 = reinterpret_cast<double*>(sm + S::D264);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* resbar = empty + STAGES;

  const int b = blockIdx.y;
  const int qt = blockIdx.x % nqt, sp = blockIdx.x / nqt;
  const int q0 = qt * BQ;
  const int nkt = (ns + BK - 1) / BK;
  const int t0 = sp * nkt / splits, t1 = (sp + 1) * nkt / splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 1);   // this warp's rows in the tile
  const int kc = 16 * (warp >> 1);  // and its keys in each key tile
  const float* vb = vbar + (size_t)b * C;

  auto issue = [&](int j) {
    const int s = (j - t0) % STAGES;
    uint8_t* st = sm + s * S::STAGE;
    mbar_expect_tx(&full[s], S::STAGE);
    tma_tile<T, BK>(st, &kmap, j * BK, b, &full[s]);
    tma_tile<T, BK>(st + S::KV, &vmap, j * BK, b, &full[s]);
  };
  // The resident q, dm1, dm2 land by TMA in the ring's space and are
  // converted to f64; then the ring starts.
  constexpr int QB = tile_bytes<T, BQ>(), DB = tile_bytes<TD, BQ>();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    mbar_init(resbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(resbar, QB + 2 * DB);
    tma_tile<T, BQ>(sm, &qmap, q0, b, resbar);
    tma_tile<TD, BQ>(sm + QB, &d1map, q0, b, resbar);
    tma_tile<TD, BQ>(sm + QB + DB, &d2map, q0, b, resbar);
  }
  float mr[2], lr[2];
  double dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    const bool ok = row < nc;
    mr[h] = ok ? m[(size_t)b * nc + row] : 0.f;
    lr[h] = ok ? l[(size_t)b * nc + row] : 1.f;
    dr[h] = ok ? D[(size_t)b * nc + row] : 0.0;
  }
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool rows_live = q0 + r0 < nc;
  mbar_wait(resbar, 0);  // rows past nc arrive as zeros
  tile_to_f64<T, BQ>(q64, reinterpret_cast<const T*>(sm), tid);
  tile_to_f64<TD, BQ>(d164, reinterpret_cast<const TD*>(sm + QB), tid);
  tile_to_f64<TD, BQ>(d264, reinterpret_cast<const TD*>(sm + QB + DB), tid);
  __syncthreads();  // the resident f64 tiles; the ring's space is free
  if (tid == 0)
    for (int j = t0; j < min(t1, t0 + AHEAD); ++j) issue(j);

  for (int j = t0; j < t1; ++j) {
    const int s = (j - t0) % STAGES, use = (j - t0) / STAGES;
    const uint8_t* st = sm + s * S::STAGE;
    const T* ks = reinterpret_cast<const T*>(st);
    const T* vs = reinterpret_cast<const T*>(st + S::KV);
    if (CUT == kSyncStage && tid == 0) {
      wait_slot(&empty[s], use);
      issue(j);
    }
    mbar_wait(&full[s], use & 1);

    const int k0 = j * BK;
    if (rows_live && k0 + kc < ns) {
      // s: A = q (rows r0 + g, + 8), B = k (keys kc + 8 nb + g).
      double sl[2][4];
      if (CUT == kNoLogits) {
#pragma unroll
        for (int i = 0; i < 8; ++i) (&sl[0][0])[i] = 0.0;
      } else {
        const double* ra = q64 + (r0 + g) * LDD + t;
        adaattn_logits64<2>(
            [&](int c, double& a0, double& a1) {
              a0 = ra[c];
              a1 = ra[8 * LDD + c];
            },
            [&](int nb, int c) {
              return (double)tldk<T, BK>(ks, kc + 8 * nb + g, c + t, g);
            },
            sl);
      }
      // T - D in f64 on the FP64 tensor cores: T = dm1 vc^T + dm2 (vc^2)^T,
      // one accumulator fragment per product and 8-key block.
      double ta[2][2][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) (&ta[0][0][0])[i] = 0.0;
      const double* r1 = d164 + (r0 + g) * LDD + t;
      const double* r2 = d264 + (r0 + g) * LDD + t;
#pragma unroll 8
      for (int c = 0; c < C; c += 4) {
        const double vbc = (double)__ldg(&vb[c + t]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const double w =
              (double)tldk<T, BK>(vs, kc + 8 * nb + g, c + t, g) - vbc;
          if (CUT != kNoMma) {
            dmma_16x8x4(ta[0][nb], r1[c], r1[8 * LDD + c], w);
            dmma_16x8x4(ta[1][nb], r2[c], r2[8 * LDD + c], w * w);
          } else {
            ta[0][nb][0] += r1[c] * w + r2[8 * LDD + c] * w * w;
          }
        }
      }
      // P and dS in the accumulator layout: (g, 2t), (g, 2t+1), (g+8, 2t),
      // (g+8, 2t+1) of keys kc + 8 nb ..
      float ds[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool live = k0 + kc + 8 * nb + 2 * t + (e & 1) < ns;
          const float p =
              live ? expf((float)(sl[nb][e] - (double)mr[h])) / lr[h] : 0.f;
          ds[nb][e] = p * (float)((ta[0][nb][e] + ta[1][nb][e]) - dr[h]);
        }
      // dq += dS k: the k-steps are the two 8-key blocks.
      const int x0 = (2 * t) & 7, x1 = (2 * t + 1) & 7;
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        AFrag a;
        afrag_from_acc(a, ds[kb]);
        const int key = kc + 8 * kb + 2 * t;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          mma3<CUT>(acc[n], a, tldk<T, BK>(ks, key, 8 * n + g, x0),
                    tldk<T, BK>(ks, key + 1, 8 * n + g, x1));
      }
    }
    release_slot(&empty[s], lane);
    if (AHEAD && tid == 0 && j + AHEAD < t1) {
      wait_slot(&empty[s], use + 1);
      issue(j + AHEAD);
    }
  }

  // The four key quarters' dq, added in shared memory in order.
  __syncthreads();  // every warp is done with the ring
  constexpr int LDR = S::LDR;
  float* red = reinterpret_cast<float*>(sm);  // [3][BQ][LDR], over the ring
  const int kq = warp >> 1;
  if (kq > 0) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((kq - 1) * BQ + r0 + g + 8 * (e >> 1)) * LDR + 8 * n + 2 * t +
            (e & 1)] = acc[n][e];
  }
  __syncthreads();
  if (kq > 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + g + 8 * h, row = q0 + rr;
    if (row >= nc) continue;
    const size_t base = ((size_t)b * nc + row) * C;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = 8 * n + 2 * t;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[e] = acc[n][2 * h + e];
#pragma unroll
        for (int w = 0; w < 3; ++w) x[e] += red[(w * BQ + rr) * LDR + c + e];
      }
      if (splits > 1) {
        *reinterpret_cast<float2*>(
            &part[(size_t)sp * gridDim.y * nc * C + base + c]) =
            make_float2(x[0], x[1]);
      } else {
        dq[base + c] = from_f32<T>(x[0]);
        dq[base + c + 1] = from_f32<T>(x[1]);
      }
    }
  }
}

}  // namespace dq

// =============================================================================
// adaattn_dkv
namespace dkv {

constexpr int BK = 64;  // keys per CTA (4 warps of 16 per role)
constexpr int BQ = 32;  // queries per tile

template <typename T, typename TD>
struct Smem {
  static constexpr int QT = tile_bytes<T, BQ>();
  static constexpr int DM = tile_bytes<TD, BQ>();
  static constexpr int STAGE = QT + 2 * DM;  // q, dm1, dm2 of one tile
  static constexpr int K64 = STAGES * STAGE;  // resident k as f64
  static constexpr int VR = K64 + BK * LDD * 8;  // resident v (f32 boxes)
  // The logits, from the dv warps to the dk warps of the same keys: per
  // key group one buffer of 16 x 32 doubles (one fragment per lane).
  static constexpr int SX = VR + tile_bytes<float, BK>();
  static constexpr int VB64 = SX + 4 * 512 * 8;  // vbar as f64
  static constexpr int BAR = VB64 + C * 8;  // full, empty, resident
  static constexpr int BYTES = BAR + 16 * STAGES + 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(STAGE % 1024 == 0, "1024-byte aligned boxes");
  static_assert(STAGES * STAGE >= 2 * tile_bytes<T, BK>(),
                "resident tiles' landing");
};

template <typename T, typename TD, int CUT>
__global__ void __launch_bounds__(NT, 1)
    adaattn_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap d1map,
                       const __grid_constant__ CUtensorMap d2map,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const float* __restrict__ vbar,
                       const float* __restrict__ m, const float* __restrict__ l,
                       const double* __restrict__ D, T* __restrict__ dk,
                       T* __restrict__ dv, float* __restrict__ part, int nc,
                       int ns, int nkt, int splits) {
  using S = Smem<T, TD>;
  constexpr int AHEAD = CUT == kSyncStage ? 0 : STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  double* k64 = reinterpret_cast<double*>(sm + S::K64);
  float* vr = reinterpret_cast<float*>(sm + S::VR);
  double* sx = reinterpret_cast<double*>(sm + S::SX);
  double* vb64 = reinterpret_cast<double*>(sm + S::VB64);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* resbar = empty + STAGES;

  const int b = blockIdx.y;
  const int kt = blockIdx.x % nkt, sp = blockIdx.x / nkt;
  const int k0 = kt * BK;
  const int nqt = (nc + BQ - 1) / BQ;
  const int t0 = sp * nqt / splits, t1 = (sp + 1) * nqt / splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);  // this warp's keys in the tile
  const int role = warp >> 2;      // 0: dk, 1: dv
  const float* vb = vbar + (size_t)b * C;

  auto issue = [&](int j) {
    const int s = (j - t0) % STAGES;
    uint8_t* st = sm + s * S::STAGE;
    mbar_expect_tx(&full[s], S::STAGE);
    tma_tile<T, BQ>(st, &qmap, j * BQ, b, &full[s]);
    tma_tile<TD, BQ>(st + S::QT, &d1map, j * BQ, b, &full[s]);
    tma_tile<TD, BQ>(st + S::QT + S::DM, &d2map, j * BQ, b, &full[s]);
  };
  // The resident k and v land by TMA in the ring's space; k is converted
  // to f64, v kept as f32; then the ring starts.
  constexpr int KB = tile_bytes<T, BK>();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    mbar_init(resbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(resbar, 2 * KB);
    tma_tile<T, BK>(sm, &kmap, k0, b, resbar);
    tma_tile<T, BK>(sm + KB, &vmap, k0, b, resbar);
  }
  mbar_wait(resbar, 0);  // keys past ns arrive as zeros
  tile_to_f64<T, BK>(k64, reinterpret_cast<const T*>(sm), tid);
  for (int idx = tid; idx < BK * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    tst<BK>(vr, r, c, tld<T, BK>(reinterpret_cast<const T*>(sm + KB), r, c));
  }
  if (tid < C) vb64[tid] = (double)vb[tid];
  __syncthreads();  // the resident tiles; the ring's space is free
  if (tid == 0)
    for (int j = t0; j < min(t1, t0 + AHEAD); ++j) issue(j);
  const bool keys_live = k0 + r0 < ns;
  const int x0 = (2 * t) & 7, x1 = (2 * t + 1) & 7;  // rows 8 k + 2t (+1)

  // The tile loop of one role, with its accumulators: dk (role 0) in f32,
  // 16 keys x 128 channels; dv (role 1) in f64, the same 16 x 128.  Two
  // code paths, so that the two kinds of accumulators are never live at
  // once (dv's 128 registers beside dk's 64 would not fit in 255).
  auto run = [&](auto role_c) {
    constexpr int ROLE = decltype(role_c)::value;
    using Acc = std::conditional_t<ROLE == 0, float, double>;
    Acc acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0;

    for (int j = t0; j < t1; ++j) {
      const int s = (j - t0) % STAGES, use = (j - t0) / STAGES;
      const uint8_t* st = sm + s * S::STAGE;
      const T* qs = reinterpret_cast<const T*>(st);
      const TD* d1s = reinterpret_cast<const TD*>(st + S::QT);
      const TD* d2s = reinterpret_cast<const TD*>(st + S::QT + S::DM);
      // m, l (and D) of this thread's query columns 8 nb + 2t + e, loaded
      // now and first used after the logits.
      float cm[4][2], cl[4][2];
      double cd[4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * BQ + 8 * nb + 2 * t + e;
          const bool ok = col < nc;
          cm[nb][e] = ok ? m[(size_t)b * nc + col] : 0.f;
          cl[nb][e] = ok ? l[(size_t)b * nc + col] : 1.f;
          cd[nb][e] = ok && ROLE == 0 ? D[(size_t)b * nc + col] : 0.0;
        }
      if (CUT == kSyncStage && tid == 0) {
        wait_slot(&empty[s], use);
        issue(j);
      }
      mbar_wait(&full[s], use & 1);

      if (keys_live) {
        // s^T: A = k (keys r0 + g, + 8), B = q (the tile's 32 queries),
        // formed by the dv warp and handed to the dk warp of the same keys
        // (named barriers 1 + kg: the buffer is full, 5 + kg: it is free).
        double sl[4][4];
        double* xb = sx + (warp & 3) * 512 + lane;
        if constexpr (ROLE == 1) {
          if (CUT == kNoLogits) {
#pragma unroll
            for (int i = 0; i < 16; ++i) (&sl[0][0])[i] = 0.0;
          } else {
            const double* ra = k64 + (r0 + g) * LDD + t;
            adaattn_logits64<4>(
                [&](int c, double& a0, double& a1) {
                  a0 = ra[c];
                  a1 = ra[8 * LDD + c];
                },
                [&](int nb, int c) {
                  return (double)tldk<T, BQ>(qs, 8 * nb + g, c + t, g);
                },
                sl);
          }
          if (j > t0) pair_sync(5 + (warp & 3));  // the buffer is free
#pragma unroll
          for (int i = 0; i < 16; ++i) xb[32 * i] = (&sl[0][0])[i];
          pair_arrive(1 + (warp & 3));
        } else {
          pair_sync(1 + (warp & 3));
#pragma unroll
          for (int i = 0; i < 16; ++i) (&sl[0][0])[i] = xb[32 * i];
          if (j + 1 < t1) pair_arrive(5 + (warp & 3));
        }
        // P^T in the accumulator layout: rows keys r0 + g (+8), columns the
        // queries 8 nb + 2t + e.
        float pd[4][4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = j * BQ + 8 * nb + 2 * t + (e & 1) < nc;
            pd[nb][e] = live ? expf((float)(sl[nb][e] -
                                            (double)cm[nb][e & 1])) /
                                   cl[nb][e & 1]
                             : 0.f;
          }
        if constexpr (ROLE == 0) {
          // T^T - D in f64 on the FP64 tensor cores: T^T = vc dm1^T +
          // vc^2 dm2^T, one accumulator fragment per product and 8-query
          // block; then dS^T = P^T o (T^T - D).
          double ta[2][4][4];
#pragma unroll
          for (int i = 0; i < 32; ++i) (&ta[0][0][0])[i] = 0.0;
#pragma unroll 4
          for (int c = 0; c < C; c += 4) {
            const double vbc = vb64[c + t];
            const double w0 =
                (double)tldk<float, BK>(vr, r0 + g, c + t, g) - vbc;
            const double w1 =
                (double)tldk<float, BK>(vr, r0 + g + 8, c + t, g) - vbc;
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              const int qr = 8 * nb + g;
              const double b1 = (double)tldk<TD, BQ>(d1s, qr, c + t, g);
              const double b2 = (double)tldk<TD, BQ>(d2s, qr, c + t, g);
              if (CUT != kNoMma) {
                dmma_16x8x4(ta[0][nb], w0, w1, b1);
                dmma_16x8x4(ta[1][nb], w0 * w0, w1 * w1, b2);
              } else {
                ta[0][nb][0] += w0 * b1 + w1 * w1 * b2;
              }
            }
          }
          float ds[4][4];
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ds[nb][e] = pd[nb][e] * (float)((ta[0][nb][e] + ta[1][nb][e]) -
                                              cd[nb][e & 1]);
          // dk += dS^T q: the k-steps are the four 8-query blocks.
#pragma unroll
          for (int kb = 0; kb < 4; ++kb) {
            AFrag a;
            afrag_from_acc(a, ds[kb]);
            const int qr = 8 * kb + 2 * t;
#pragma unroll
            for (int n = 0; n < 16; ++n)
              mma3<CUT>(acc[n], a, tldk<T, BQ>(qs, qr, 8 * n + g, x0),
                        tldk<T, BQ>(qs, qr + 1, 8 * n + g, x1));
          }
        } else {
          // dv += P^T dm1 + 2 vc o (P^T dm2), the two products on the FP64
          // tensor cores from the exact f32 P and dm (k-step 2 nb + par:
          // queries 8 nb + 2t + par, the accumulator's columns taken as
          // k-indices), summed with vc in f64 for the tile: the two terms
          // cancel by up to |vc| / std, which f32 sums did not survive on
          // ill-conditioned batches (PERF.md).
          double a0[8], a1[8];
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int par = 0; par < 2; ++par) {
              a0[2 * nb + par] = pd[nb][par];
              a1[2 * nb + par] = pd[nb][2 + par];
            }
          constexpr int NP = 2;  // 8-channel blocks at a time: 4 chains
#pragma unroll
          for (int n0 = 0; n0 < 16; n0 += NP) {
            double p1[NP][4], p2[NP][4];
#pragma unroll
            for (int i = 0; i < NP; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) p1[i][e] = p2[i][e] = 0.0;
            if (CUT != kNoDv) {
#pragma unroll
              for (int ks = 0; ks < 8; ++ks) {
                const int qr = 4 * (ks & ~1) + 2 * t + (ks & 1);
                const int key = (ks & 1) ? x1 : x0;
#pragma unroll
                for (int i = 0; i < NP; ++i) {
                  const int ch = 8 * (n0 + i) + g;
                  const double b1 = (double)tldk<TD, BQ>(d1s, qr, ch, key);
                  const double b2 = (double)tldk<TD, BQ>(d2s, qr, ch, key);
                  if (CUT != kNoMma) {
                    dmma_16x8x4(p1[i], a0[ks], a1[ks], b1);
                    dmma_16x8x4(p2[i], a0[ks], a1[ks], b2);
                  } else {
                    p1[i][0] += a0[ks] * b1 + a1[ks] * b2;
                  }
                }
              }
            }
#pragma unroll
            for (int i = 0; i < NP; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 8 * (n0 + i) + 2 * t + (e & 1);
                const double vc =
                    (double)tldk<float, BK>(vr, r0 + g + 8 * (e >> 1), c, g) -
                    vb64[c];
                acc[n0 + i][e] += p1[i][e] + 2.0 * vc * p2[i][e];
              }
          }
        }
      }
      release_slot(&empty[s], lane);
      if (AHEAD && tid == 0 && j + AHEAD < t1) {
        wait_slot(&empty[s], use + 1);
        issue(j + AHEAD);
      }
    }

    // dk, or dv, each rounded once (to the f32 partial of a chunk, or to T).
    T* out = ROLE == 0 ? dk : dv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + g + 8 * h, key = k0 + rr;
      if (key >= ns) continue;
      const size_t base = ((size_t)b * ns + key) * C;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float x[2] = {(float)acc[n][2 * h], (float)acc[n][2 * h + 1]};
        const int c = 8 * n + 2 * t;
        if (splits > 1) {
          // part is (2, splits, b, ns, C): dk's chunks, then dv's.
          *reinterpret_cast<float2*>(
              &part[((size_t)ROLE * splits + sp) * gridDim.y * ns * C + base +
                    c]) = make_float2(x[0], x[1]);
        } else {
          out[base + c] = from_f32<T>(x[0]);
          out[base + c + 1] = from_f32<T>(x[1]);
        }
      }
    }
  };
  if (role == 0)
    run(std::integral_constant<int, 0>{});
  else
    run(std::integral_constant<int, 1>{});
}

}  // namespace dkv

// out[i] = sum over the splits s of part[s n + i], in order of s.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ part, int splits,
                              size_t n, T* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float x = part[i];
    for (int s = 1; s < splits; ++s) x += part[(size_t)s * n + i];
    out[i] = from_f32<T>(x);
  }
}

template <typename T>
cudaError_t reduce(const float* part, int splits, size_t n, void* out,
                   cudaStream_t stream) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  reduce_splits<T><<<blocks, 256, 0, stream>>>(part, splits, n,
                                               static_cast<T*>(out));
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Chunks of the reduction axis's `tiles` for a grid of `ctas` CTAs per
// chunk (one CTA per SM): the fewest (waves x (tiles per chunk + 2)), the
// + 2 for each CTA's own staging of its resident tiles; ties to fewer
// chunks.  A grid of one wave (112 CTAs at (8, 400, 400)) beat grids of
// 2 x the SMs there, whose CTAs each stage their resident tiles for a tile
// or two of work (PERF.md).
int choose_splits(int ctas, int tiles) {
  const int sms = sm_count();
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= tiles; ++s) {
    const long waves = ((long)ctas * s + sms - 1) / sms;
    const long cost = waves * ((tiles + s - 1) / s + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// (b, rows, 128) f32 or bf16 as a 3-d map of boxes of `box_rows` rows x 128
// bytes, 128-byte swizzle, zeros outside.
bool make_tile_map(CUtensorMap* map, const void* base, bool bf16, int rows,
                   int b, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || !aligned(base, 16)) return false;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[2] = {C * es, (cuuint64_t)rows * C * es};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr bool is_bf16_t() {
  return sizeof(T) == 2;
}

int dq_splits(int b, int nc, int ns) {
  return choose_splits(b * ((nc + dq::BQ - 1) / dq::BQ),
                       (ns + dq::BK - 1) / dq::BK);
}
int dkv_splits(int b, int nc, int ns) {
  return choose_splits(b * ((ns + dkv::BK - 1) / dkv::BK),
                       (nc + dkv::BQ - 1) / dkv::BQ);
}

template <typename T, typename TD, int CUT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* vbar, const void* dm1, const void* dm2,
                      const void* m, const void* l, const void* d, void* dq,
                      void* part, int b, int nc, int ns, int splits,
                      cudaStream_t stream) {
  using S = dq::Smem<T, TD>;
  CUtensorMap kmap, vmap, qmap, d1map, d2map;
  if (!make_tile_map(&kmap, k, is_bf16_t<T>(), ns, b, dq::BK) ||
      !make_tile_map(&vmap, v, is_bf16_t<T>(), ns, b, dq::BK) ||
      !make_tile_map(&qmap, q, is_bf16_t<T>(), nc, b, dq::BQ) ||
      !make_tile_map(&d1map, dm1, is_bf16_t<TD>(), nc, b, dq::BQ) ||
      !make_tile_map(&d2map, dm2, is_bf16_t<TD>(), nc, b, dq::BQ))
    return cudaErrorInvalidValue;
  auto kernel = dq::adaattn_dq_kernel<T, TD, CUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
  if (err != cudaSuccess) return err;
  const int nqt = (nc + dq::BQ - 1) / dq::BQ;
  dim3 grid(nqt * splits, b);
  kernel<<<grid, NT, S::ALLOC, stream>>>(
      kmap, vmap, qmap, d1map, d2map, static_cast<const float*>(vbar),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const double*>(d), static_cast<T*>(dq),
      static_cast<float*>(part), nc, ns, nqt, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce<T>(static_cast<const float*>(part), splits,
                   (size_t)b * nc * C, dq, stream);
}

template <typename T, typename TD, int CUT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* vbar, const void* dm1, const void* dm2,
                       const void* m, const void* l, const void* d, void* dk,
                       void* dv, void* part, int b, int nc, int ns, int splits,
                       cudaStream_t stream) {
  using S = dkv::Smem<T, TD>;
  CUtensorMap qmap, d1map, d2map, kmap, vmap;
  if (!make_tile_map(&qmap, q, is_bf16_t<T>(), nc, b, dkv::BQ) ||
      !make_tile_map(&d1map, dm1, is_bf16_t<TD>(), nc, b, dkv::BQ) ||
      !make_tile_map(&d2map, dm2, is_bf16_t<TD>(), nc, b, dkv::BQ) ||
      !make_tile_map(&kmap, k, is_bf16_t<T>(), ns, b, dkv::BK) ||
      !make_tile_map(&vmap, v, is_bf16_t<T>(), ns, b, dkv::BK))
    return cudaErrorInvalidValue;
  auto kernel = dkv::adaattn_dkv_kernel<T, TD, CUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
  if (err != cudaSuccess) return err;
  const int nkt = (ns + dkv::BK - 1) / dkv::BK;
  dim3 grid(nkt * splits, b);
  kernel<<<grid, NT, S::ALLOC, stream>>>(
      qmap, d1map, d2map, kmap, vmap, static_cast<const float*>(vbar),
      static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const double*>(d),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(part), nc,
      ns, nkt, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)b * ns * C;
  const float* p = static_cast<const float*>(part);
  err = reduce<T>(p, splits, n, dk, stream);
  if (err != cudaSuccess) return err;
  return reduce<T>(p + (size_t)splits * n, splits, n, dv, stream);
}

}  // namespace
}  // namespace ast_kernels

// The key chunks of adaattn_dq's grid (the query chunks of adaattn_dkv's)
// for this shape: the wrapper's `splits` unless it forces another, and the
// size of the scratch (splits x b x nc x c, resp. 2 x splits x b x ns x c
// f32) where it is above 1.
extern "C" int adaattn_dq_splits(int b, int nc, int ns) {
  return ast_kernels::dq_splits(b, nc, ns);
}
extern "C" int adaattn_dkv_splits(int b, int nc, int ns) {
  return ast_kernels::dkv_splits(b, nc, ns);
}

// q (b, nc, c), k and v (b, ns, c) in one dtype (bf16 if is_bf16, else f32);
// vbar (b, c) f32, v's mean over the keys; dm1, dm2 (b, nc, c), centred
// (the header), in bf16 if dm_bf16 (then q is bf16 too), else f32; m, l, d
// (b, nc) f32; dq (b, nc, c) in q's dtype; part the f32 scratch of
// `splits` > 1 key chunks (unused at 1).  c must be 128, ns > 0 and every
// pointer 16-byte aligned.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int adaattn_dq_launch(const void* q, const void* k, const void* v,
                                 const void* vbar, const void* dm1,
                                 const void* dm2, const void* m, const void* l,
                                 const void* d, void* dq, void* part, int b,
                                 int nc, int ns, int c, int splits,
                                 int is_bf16, int dm_bf16, void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0 || splits < 1 || (dm_bf16 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || nc == 0) return 0;
  splits = std::min(splits, (ns + dq::BK - 1) / dq::BK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch_dq<float, float, kNone>(q, k, v, vbar, dm1, dm2, m, l,
                                                d, dq, part, b, nc, ns, splits,
                                                s);
  if (!dm_bf16)
    return (int)launch_dq<__nv_bfloat16, float, kNone>(
        q, k, v, vbar, dm1, dm2, m, l, d, dq, part, b, nc, ns, splits, s);
  return (int)launch_dq<__nv_bfloat16, __nv_bfloat16, kNone>(
      q, k, v, vbar, dm1, dm2, m, l, d, dq, part, b, nc, ns, splits, s);
}

// The same inputs; dk, dv (b, ns, c) in k's dtype; `splits` query chunks.
// nc may be 0 (then dk and dv are zeros).
extern "C" int adaattn_dkv_launch(const void* q, const void* k, const void* v,
                                  const void* vbar, const void* dm1,
                                  const void* dm2, const void* m,
                                  const void* l, const void* d, void* dk,
                                  void* dv, void* part, int b, int nc, int ns,
                                  int c, int splits, int is_bf16, int dm_bf16,
                                  void* stream) {
  using namespace ast_kernels;
  if (c != C || ns <= 0 || splits < 1 || (dm_bf16 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 0) {
    const size_t bytes = (size_t)b * ns * C * (is_bf16 ? 2 : 4);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(dv, 0, bytes, s);
  }
  splits = std::min(splits, (nc + dkv::BQ - 1) / dkv::BQ);
  if (!is_bf16)
    return (int)launch_dkv<float, float, kNone>(q, k, v, vbar, dm1, dm2, m, l,
                                                 d, dk, dv, part, b, nc, ns,
                                                 splits, s);
  if (!dm_bf16)
    return (int)launch_dkv<__nv_bfloat16, float, kNone>(
        q, k, v, vbar, dm1, dm2, m, l, d, dk, dv, part, b, nc, ns, splits, s);
  return (int)launch_dkv<__nv_bfloat16, __nv_bfloat16, kNone>(
      q, k, v, vbar, dm1, dm2, m, l, d, dk, dv, part, b, nc, ns, splits, s);
}

// f32 inputs through a kernel with one part cut out (`cut`: 1 the
// tensor-core products, 2 the ring's prefetch, 3 the f64 logits, 4 (dkv
// only) the f64 dv products), for the ablation's timing only: its results
// are wrong.  which 0: adaattn_dq
// (out1 = dq), 1: adaattn_dkv (out1 = dk, out2 = dv).
extern "C" int adaattn_bwd_cut_launch(int which, int cut, const void* q,
                                      const void* k, const void* v,
                                      const void* vbar, const void* dm1,
                                      const void* dm2, const void* m,
                                      const void* l, const void* d,
                                      void* out1, void* out2, void* part,
                                      int b, int nc, int ns, int splits,
                                      void* stream) {
  using namespace ast_kernels;
  if (ns <= 0 || nc <= 0 || b <= 0 || splits < 1 || cut < 1 || cut > 4 ||
      (cut == kNoDv && which == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AST_CUT(CUT)                                                         \
  return which == 0                                                          \
             ? (int)launch_dq<float, float, CUT>(q, k, v, vbar, dm1, dm2, m, \
                                                 l, d, out1, part, b, nc, ns, \
                                                 splits, s)                  \
             : (int)launch_dkv<float, float, CUT>(q, k, v, vbar, dm1, dm2, m, \
                                                  l, d, out1, out2, part, b,  \
                                                  nc, ns, splits, s)
  if (cut == kNoMma) AST_CUT(kNoMma);
  if (cut == kSyncStage) AST_CUT(kSyncStage);
  if (cut == kNoLogits) AST_CUT(kNoLogits);
  return (int)launch_dkv<float, float, kNoDv>(q, k, v, vbar, dm1, dm2, m, l,
                                              d, out1, out2, part, b, nc, ns,
                                              splits, s);
#undef AST_CUT
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs per
// SM of the f32 kernel (which 0: adaattn_dq, 1: adaattn_dkv) into out[3].
extern "C" int adaattn_bwd_occupancy(int which, int* out) {
  using namespace ast_kernels;
  const void* fn =
      which == 0
          ? reinterpret_cast<const void*>(
                dq::adaattn_dq_kernel<float, float, kNone>)
          : reinterpret_cast<const void*>(
                dkv::adaattn_dkv_kernel<float, float, kNone>);
  const int smem = which == 0 ? dq::Smem<float, float>::ALLOC
                              : dkv::Smem<float, float>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = smem;
  out[2] = blocks;
  return 0;
}
