// In-kernel product probe: y[r, e, w] = sum_c x[r, c, w] * w[c, e], bf16 in,
// f32 accumulation, y rounded to bf16.
//
// Replaces the TPU probes scripts/probe_mega2.py `_einsum_kernel` (P2a, one
// batched einsum('rcw,ce->rew') over the resident block) and
// `_rowloop_kernel` (P2b, the same contraction one row r at a time, the
// weight loaded once).  Here they are two schedules of one kernel:
//   * probe_mm_einsum_launch: one CTA per (row r, 64-pixel tile of W), so one
//     launch tiles every (r, w) together; each CTA stages the weight itself;
//   * probe_mm_rowloop_launch: one CTA per (4 rows, 64-pixel tile); it stages
//     the weight once and walks its rows, the next row's x tile loading
//     (cp.async) while the current one is multiplied.
//
// What bounds it on an H100: at the probe's shapes (R = 32, W = 512; C = 40,
// E = 160 or C = 240, E = 24) ~0.2 GFLOP against 6.6 or 8.7 MB, so bytes
// (~2-3 us at 3.35 TB/s); at that size the launch and one wave of CTAs are
// most of the time.  The product runs on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate: the products are exact in f32, as in
// the TPU's bf16 matmul with f32 accumulation), as M = pixels (w), N = E,
// K = C:
//   * x's contiguous axis is W, so the x tile is staged as [c][w] and the A
//     fragments (rows w, depth c) come from ldmatrix.trans; the weight is
//     staged as [c][e] and its B fragments also come from ldmatrix.trans;
//   * C = 40 is not a multiple of the MMA depth 16: K is padded with zeros in
//     shared memory only (cp.async with a zero source size), never in HBM;
//   * each warp owns 16 pixels and walks E in chunks of 64 (8 n-tiles of 8;
//     E must be a multiple of 8); the f32 sums are rounded to bf16 into a
//     [e][w] staging tile and stored as 16-byte rows of y.

#include "common.cuh"

namespace {

constexpr int WT = 64;          // pixels (w) per tile: 4 warps x 16
constexpr int NTHREADS = 128;
constexpr int X_LD = WT + 8;    // bf16 row of the x and y tiles: 144 B
constexpr int EC = 64;          // E columns per accumulator pass
constexpr int ROWLOOP_ROWS = 4;

using bf16 = __nv_bfloat16;

// A row stride (in bf16) >= e + 8 whose 16-byte count is odd, so that the
// 8 rows an ldmatrix reads fall in distinct banks.
__host__ __device__ inline int weight_ld(int e) {
  int ld = e + 8;
  if ((ld / 8) % 2 == 0) ld += 8;
  return ld;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Stage x[r, :, w0:w0+WT] as xs[cp][X_LD] (rows c >= C and columns w >= W
// zero).
__device__ __forceinline__ void load_x(bf16* xs, const bf16* __restrict__ x,
                                       int r, int w0, int C, int W, int cp) {
  for (int idx = threadIdx.x; idx < cp * (WT / 8); idx += NTHREADS) {
    const int c = idx / (WT / 8), seg = idx % (WT / 8);
    const int w = w0 + seg * 8;
    const bool ok = c < C && w < W;
    const bf16* src = ok ? x + ((size_t)r * C + c) * W + w : x;
    cp16(xs + c * X_LD + seg * 8, src, ok);
  }
}

// rows r0 .. r0 + rows - 1 (clipped to R) of the w-tile blockIdx.x.
__global__ void __launch_bounds__(NTHREADS)
    probe_mm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                    bf16* __restrict__ y, int R, int C, int E, int W,
                    int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cp = (C + 15) / 16 * 16;
  const int eld = weight_ld(E);
  bf16* ws = reinterpret_cast<bf16*>(smem);  // [cp][eld]
  bf16* xs = ws + cp * eld;                  // [2][cp][X_LD]
  bf16* ys = xs + 2 * cp * X_LD;             // [E][X_LD]

  const int w0 = blockIdx.x * WT;
  const int r0 = blockIdx.y * rows;
  const int nrows = min(rows, R - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  for (int idx = threadIdx.x; idx < cp * (E / 8); idx += NTHREADS) {
    const int c = idx / (E / 8), seg = idx % (E / 8);
    const bool ok = c < C;
    cp16(ws + c * eld + seg * 8, ok ? wt + (size_t)c * E + seg * 8 : wt, ok);
  }
  load_x(xs, x, r0, w0, C, W, cp);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int i = 0; i < nrows; ++i) {
    const bf16* xb = xs + (i & 1) * cp * X_LD;
    if (i + 1 < nrows) {
      // The other buffer's readers finished before the last barrier.
      load_x(xs + ((i + 1) & 1) * cp * X_LD, x, r0 + i + 1, w0, C, W, cp);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // row i staged; the previous row's y is stored

    // ldmatrix addresses: A = xs^T (rows w, depth c), four 8x8 matrices
    // (w 0-7 | 8-15) x (c 0-7 | 8-15); B = ws (depth c, columns e), two.
    const int mj = lane >> 3, mr = lane & 7;
    const bf16* a_base =
        xb + ((mj >> 1) * 8 + mr) * X_LD + warp * 16 + (mj & 1) * 8;
    const bf16* b_base = ws + ((mj & 1) * 8 + mr) * eld;
    for (int e0 = 0; e0 < E; e0 += EC) {
      float acc[EC / 8][4];
#pragma unroll
      for (int nt = 0; nt < EC / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
      for (int ks = 0; ks < cp; ks += 16) {
        uint32_t a[4];
        ldsm_x4_t(a, a_base + ks * X_LD);
#pragma unroll
        for (int nt = 0; nt < EC / 8; ++nt) {
          if (e0 + nt * 8 < E) {
            uint32_t b[2];
            ldsm_x2_t(b, b_base + ks * eld + e0 + nt * 8);
            ast_kernels::mma_bf16(acc[nt], a, b);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < EC / 8; ++nt) {
        if (e0 + nt * 8 < E) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = warp * 16 + g + (q >= 2 ? 8 : 0);
            const int e = e0 + nt * 8 + tig * 2 + (q & 1);
            ys[e * X_LD + m] = __float2bfloat16_rn(acc[nt][q]);
          }
        }
      }
    }
    __syncthreads();  // the y tile is complete
    const int r = r0 + i;
    for (int idx = threadIdx.x; idx < E * (WT / 8); idx += NTHREADS) {
      const int e = idx / (WT / 8), seg = idx % (WT / 8);
      const int w = w0 + seg * 8;
      if (w < W)
        *reinterpret_cast<uint4*>(y + ((size_t)r * E + e) * W + w) =
            *reinterpret_cast<const uint4*>(ys + e * X_LD + seg * 8);
    }
  }
}

int launch(const void* x, const void* w, void* y, int r, int c, int e,
           int width, int rows, void* stream) {
  using namespace ast_kernels;
  if (r == 0 || width == 0 || e == 0) return 0;
  if (c <= 0 || e % 8 != 0 || width % 8 != 0 || !aligned(x, 16) ||
      !aligned(w, 16) || !aligned(y, 16))
    return (int)cudaErrorInvalidValue;
  const int cp = (c + 15) / 16 * 16;
  const int smem =
      (cp * weight_ld(e) + 2 * cp * X_LD + e * X_LD) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      probe_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((width + WT - 1) / WT, (r + rows - 1) / rows);
  probe_mm_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), r, c, e, width, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x (r, c, width), w (c, e), y (r, e, width), all bf16 and contiguous;
// e and width multiples of 8.  Return the cudaError_t of the launch.
extern "C" int probe_mm_einsum_launch(const void* x, const void* w, void* y,
                                      int r, int c, int e, int width,
                                      void* stream) {
  return launch(x, w, y, r, c, e, width, 1, stream);
}

extern "C" int probe_mm_rowloop_launch(const void* x, const void* w, void* y,
                                       int r, int c, int e, int width,
                                       void* stream) {
  return launch(x, w, y, r, c, e, width, ROWLOOP_ROWS, stream);
}
