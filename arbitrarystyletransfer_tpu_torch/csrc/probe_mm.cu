// In-kernel product probe: y[r, e, w] = sum_c x[r, c, w] * w[c, e], bf16 in,
// f32 accumulation, y rounded once to bf16.
//
// Replaces the TPU probes scripts/probe_mega2.py `_einsum_kernel` (P2a, one
// batched einsum('rcw,ce->rew') over the resident block) and
// `_rowloop_kernel` (P2b, the same contraction one row r at a time, the
// weight loaded once).  Here they are two schedules of one kernel, which
// differ only in which items a CTA walks; an item is a (row r, 64-pixel
// tile of W) pair, and the grid is min(items, CTAs per SM x SMs) from the
// runtime's occupancy for both:
//   * probe_mm_einsum_launch: items r-major across the card, CTA b taking
//     items b, b + grid, ...;
//   * probe_mm_rowloop_launch: each CTA a contiguous run of items ordered
//     row fastest within a W tile, so it walks consecutive rows of one
//     tile with the weight staged once, as the TPU's row loop does.
//
// What bounds it on an H100: bytes.  At the probe's shapes (R = 32, W =
// 512; C = 40, E = 160 or C = 240, E = 24) it moves 6.6 or 8.7 MB, 2.0 or
// 2.6 us at 3.35 TB/s, for 0.1 GFLOP (about 32 or 6 FLOP a byte against the
// card's ~295): the tensor cores are not the limit; the latency of a
// 2-3 us kernel is (its launch, one load, the product, one store), and the
// shared-memory traffic of the product.  The design:
//   * persistent CTAs of 128 threads (4 warps of 16 pixels) walk their
//     items; the grid never exceeds the items and, while there are enough
//     items, is at least the SMs; where one wave holds every item, no SM
//     takes more than its share of CTAs;
//   * the weight is staged once per CTA by one bulk copy of the contiguous
//     (C, E) array, completing on an mbarrier (a TMA box or a bulk copy per
//     row of C would be C narrow requests from every CTA, which at C = 240
//     took longer than the rest of the kernel); where E / 8 is even the
//     copy lands in the y staging tiles (or, where they cannot hold it, at
//     the end of the weight's own area) and its rows are moved to a stride
//     of E + 8, so that the rows an ldmatrix reads fall in distinct banks,
//     and the weight takes no shared memory beyond its staged rows;
//   * x is staged by TMA from a (W, C, R) map, a box of 64 pixels x kc rows
//     of C x 1 row r (kc = C rounded up to 16, in two boxes where that
//     exceeds the 256 elements a box dimension takes), into a ring of
//     slots with one full mbarrier each; the ring is as deep as the most
//     items a CTA walks (up to MAX_SLOTS), so every item's load is issued
//     at the start and a CTA pays one latency, not one per item;
//   * TMA writes zeros for out-of-range elements, so the K padding (rows C
//     .. kc - 1 of dimension C, never row r + 1's data) and a ragged W edge
//     need no masking; x and y tiles use the 128-byte swizzle (a row of 64
//     bf16 is 128 bytes), so their ldmatrix and stmatrix rows fall in
//     distinct banks;
//   * the product runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     f32 accumulate: the products are exact in f32, as in the TPU's bf16
//     matmul with f32 accumulation), M = pixels, N = E, K = C: A fragments
//     from the [c][w] x tile by ldmatrix.trans, B fragments from the [c][e]
//     weight by ldmatrix.trans; each warp walks E in passes of 64 columns,
//     each pass compiled for its count of 8-column tiles, with 32-bit shared
//     addresses formed once (a generic-to-shared conversion per ldmatrix,
//     and a branch per tile, each cost more than the ldmatrix itself);
//   * the f32 sums are rounded to bf16 and written transposed by
//     stmatrix.trans into a swizzled [e][w] staging tile, stored as one TMA
//     box of a (W, E, R) map (two where E > 256), committed as a bulk
//     group: the store overlaps the next item's product and is waited for
//     only before its staging slot is written again; TMA drops the elements
//     past W;
//   * each launch is a programmatic dependent of the previous kernel in the
//     stream (cudaLaunchKernelEx): its prologue in shared memory overlaps
//     that kernel's end, and griddepcontrol.wait precedes its first global
//     read or write, so a y buffer the allocator hands on is never raced.
// The launch geometry of a shape (ring depth, occupancy, grid) is worked
// out at its first launch and kept.  probe_mm_cut_launch times the schedule
// with one part cut out (the product, or the asynchronous staging);
// probe_mm_occupancy reports what a shape launches.

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ast_kernels;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;         // threads a CTA: 4 warps of 16 pixels
constexpr int WT = 64;          // pixels an item: a 128-byte row of bf16
constexpr int ROWB = 2 * WT;    // bytes of a staged row (x, weight, y)
constexpr int EC = 64;          // E columns an accumulator pass
constexpr int BOX = 256;        // the most elements a box dimension takes
constexpr int MAX_SLOTS = 4;    // the x ring's slots at most

enum { kEinsum = 0, kRowloop = 1 };
enum { kCutNone = 0, kCutMma = 1, kCutAsync = 2 };

struct Args {
  const bf16* x;
  const bf16* wt;
  int r, c, e, w;    // x (r, c, w), weight (c, e), y (r, e, w)
  int ntw, items;    // W tiles; items = r * ntw
  int kc, nkb, kp;   // rows of C a box, boxes along C, kp = nkb * kc
  int c16;           // C rounded up to 16: the weight's staged rows
  int ld;            // the staged weight's row stride (bf16)
  int ye, nyb;       // rows of E a y box, y boxes along E
  int slots, yslots; // x ring slots, y staging slots
  int schedule;
};

// The staged weight's row stride: E where its 16-byte count is odd, so
// that the 8 rows an ldmatrix reads fall in distinct banks, else E + 8.
__host__ __device__ inline int weight_ld(int e) {
  return (e / 8) % 2 ? e : e + 8;
}

// Bytes of the staged weight, [c16][ld], rounded up so that the swizzled
// tiles after it stay 1024-byte aligned.
__host__ __device__ inline int weight_bytes(const Args& a) {
  return (a.c16 * a.ld * 2 + 1023) / 1024 * 1024;
}

__host__ __device__ inline int y_rows(const Args& a) { return a.nyb * a.ye; }

// Where the weight's bulk copy lands, in elements from the weight's area:
//   * where ld == E, the area itself;
//   * else in the y staging tiles where they hold it (the first item's
//     product writes them, after restage() has moved the rows to stride
//     ld);
//   * else packed at the end of the area, from where restage() moves the
//     rows forward in place.  The area holds c16 * ld >= C * (E + 8)
//     elements, so the copy starts at least 8 C elements in.
__host__ __device__ inline int weight_landing(const Args& a) {
  if (a.ld == a.e) return 0;
  if (a.c * a.e <= a.yslots * y_rows(a) * WT)
    return weight_bytes(a) / 2 + a.slots * a.kp * WT;
  return a.c16 * a.ld - a.c * a.e;
}

__host__ inline int smem_bytes(const Args& a) {
  return weight_bytes(a) + (a.slots * a.kp + a.yslots * y_rows(a)) * ROWB +
         1024;  // slack to align the tiles to 1024 bytes
}

// Element (row, 8-column chunk q) of a 128-byte-swizzled tile whose base is
// 1024-byte aligned: the chunk is stored at q ^ (row % 8).
__device__ __forceinline__ int swz(int row, int q) {
  return row * WT + ((q ^ (row & 7)) << 3);
}

__device__ __forceinline__ void item_of(const Args& a, int t, int& r,
                                        int& w0) {
  if (a.schedule == kRowloop) {
    r = t % a.r;
    w0 = t / a.r * WT;
  } else {
    r = t / a.ntw;
    w0 = t % a.ntw * WT;
  }
}

// ldmatrix and stmatrix at 32-bit shared addresses: the product forms
// each address as a base plus constant offsets, with no generic-to-shared
// conversion in its loop.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// The transposes of four (two) 8x8 bf16 matrices held in the mma.sync
// fragment layout, to shared memory: lane l gives the address of row l % 8
// of stored matrix l / 8.
__device__ __forceinline__ void stsm_x4_t(uint32_t addr, uint32_t r0,
                                          uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ void stsm_x2_t(uint32_t addr, uint32_t r0,
                                          uint32_t r1) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};" ::"r"(
          addr),
      "r"(r0), "r"(r1)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One box of a 3-d tensor map from shared memory, in the current bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Item t's x tile into `slot` by TMA, completing on `bar` (one thread).
__device__ __forceinline__ void issue_x(const CUtensorMap* map, const Args& a,
                                        int t, bf16* slot, uint64_t* bar) {
  int r, w0;
  item_of(a, t, r, w0);
  mbar_expect_tx(bar, (uint32_t)(a.kp * ROWB));
  for (int kb = 0; kb < a.nkb; ++kb)
    tma_load_3d(slot + kb * a.kc * WT, map, w0, kb * a.kc, r, bar);
}

// x's tile of item (r, w0), or the weight (x == false), by plain 16-byte
// loads of every thread, zeros where the map fills zeros.
__device__ __forceinline__ void stage_sync(const Args& a, bf16* dst, int r,
                                           int w0, bool x) {
  const int chunks = x ? 8 : a.e / 8;
  for (int i = threadIdx.x; i < (x ? a.kp : a.c) * chunks; i += NT) {
    const int row = i / chunks, q = i % chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (x) {
      const int w = w0 + q * 8;
      if (row < a.c && w < a.w)
        v = *reinterpret_cast<const uint4*>(
            a.x + ((size_t)r * a.c + row) * a.w + w);
      *reinterpret_cast<uint4*>(dst + swz(row, q)) = v;
    } else {
      v = *reinterpret_cast<const uint4*>(a.wt + (size_t)row * a.e + q * 8);
      *reinterpret_cast<uint4*>(dst + row * a.ld + q * 8) = v;
    }
  }
}

// The weight's K padding, rows C .. c16 - 1, as zeros.
__device__ __forceinline__ void zero_k_pad(const Args& a, bf16* ws) {
  for (int i = threadIdx.x; i < (a.c16 - a.c) * a.ld / 8; i += NT)
    reinterpret_cast<uint4*>(ws + a.c * a.ld)[i] = make_uint4(0, 0, 0, 0);
}

// Whether the weight's bulk copy lands in its own area and moves in place.
__host__ __device__ inline bool moves_in_place(const Args& a) {
  return a.ld != a.e && weight_landing(a) < a.c16 * a.ld;
}

// The weight's rows, landed packed at weight_landing(a), moved to stride
// ld.  From the y staging tiles, by one loop.  In place, 16-byte chunk q of
// row c moves from landing + 8 q to 8 q + 8 c: its new place ends before
// chunk q + 1's old place begins (8 c < 8 C <= landing), so chunks moved in
// order, each batch read whole into registers before any of it is written,
// never overwrite a chunk not yet read; the K padding, which the copy
// overwrote, is zeroed after.  (The batches' syncs cost more than the one
// loop, so the y staging tiles take the copy wherever they hold it.)
__device__ __forceinline__ void restage(const Args& a, bf16* ws) {
  constexpr int RB = 4;  // chunks a thread holds in a batch
  const int n = a.c * a.e / 8, per_row = a.e / 8;
  const uint4* src = reinterpret_cast<const uint4*>(ws + weight_landing(a));
  auto put = [&](int q, uint4 v) {
    *reinterpret_cast<uint4*>(ws + q / per_row * a.ld + q % per_row * 8) = v;
  };
  if (!moves_in_place(a)) {
    for (int q = threadIdx.x; q < n; q += NT) put(q, src[q]);
    return;
  }
  for (int q0 = 0; q0 < n; q0 += RB * NT) {
    uint4 v[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int q = q0 + k * NT + threadIdx.x;
      if (q < n) v[k] = src[q];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int q = q0 + k * NT + threadIdx.x;
      if (q < n) put(q, v[k]);
    }
  }
  __syncthreads();
  zero_k_pad(a, ws);
}

// One pass of NTS n-tiles (8 E columns each) from column e0: the sums in
// f32 over k-steps of 16 rows of C in order, rounded to bf16 and stored
// transposed into the [e][w] y tile (MMA false: zeros, the product cut
// out).  The fragments of k-step k + 1 are loaded before the products of
// k-step k are issued, so the ldmatrix latency overlaps the tensor cores;
// the last load is repeated rather than branched around.  a_at, b_at, y_at:
// this lane's ldmatrix / stmatrix addresses at k-step 0, column 0.
template <int NTS, bool MMA>
__device__ __forceinline__ void pass(const Args& a, uint32_t a_at,
                                     uint32_t b_at, uint32_t y_at, int e0) {
  float acc[NTS][4];
#pragma unroll
  for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  if constexpr (MMA) {
    auto load = [&](int k, uint32_t(&af)[4], uint32_t(&bf)[NTS][2]) {
      ldsm_x4_t(af, a_at + k * 16 * ROWB);
      const uint32_t at = b_at + (k * 16 * a.ld + e0) * 2;
#pragma unroll
      for (int nt = 0; nt < NTS; nt += 2) {
        if (nt + 1 < NTS) {
          uint32_t b[4];
          ldsm_x4_t(b, at + nt * 16);
          bf[nt][0] = b[0], bf[nt][1] = b[1];
          bf[nt + 1 < NTS ? nt + 1 : nt][0] = b[2];  // (nt + 1 when taken)
          bf[nt + 1 < NTS ? nt + 1 : nt][1] = b[3];
        } else {
          ldsm_x2_t(bf[nt], at + nt * 16);
        }
      }
    };
    auto mmas = [&](const uint32_t(&af)[4], const uint32_t(&bf)[NTS][2]) {
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt) mma_bf16(acc[nt], af, bf[nt]);
    };
    const int nk = a.c16 / 16;
    uint32_t a0[4], b0[NTS][2], a1[4], b1[NTS][2];
    load(0, a0, b0);
    for (int k = 0; k < nk; k += 2) {
      load(min(k + 1, nk - 1), a1, b1);
      mmas(a0, b0);
      if (k + 1 == nk) break;
      load(min(k + 2, nk - 1), a0, b0);
      mmas(a1, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NTS; nt += 2) {
    const uint32_t at = y_at + (e0 + nt * 8) * ROWB;
    if (nt + 1 < NTS)
      stsm_x4_t(at, pack_bf16(acc[nt][0], acc[nt][1]),
                pack_bf16(acc[nt][2], acc[nt][3]),
                pack_bf16(acc[nt + 1 < NTS ? nt + 1 : nt][0],
                          acc[nt + 1 < NTS ? nt + 1 : nt][1]),
                pack_bf16(acc[nt + 1 < NTS ? nt + 1 : nt][2],
                          acc[nt + 1 < NTS ? nt + 1 : nt][3]));
    else
      stsm_x2_t(at, pack_bf16(acc[nt][0], acc[nt][1]),
                pack_bf16(acc[nt][2], acc[nt][3]));
  }
}

// The item's y tile, [e][w] in `yb`, from the x tile `xb` and the weight
// `ws`: each warp owns 16 pixels and walks E in passes of EC columns.  Lane
// l addresses row l % 8 of matrix l / 8; every row it reads or writes is a
// multiple of 8 away from l % 8, so its swizzled 16-byte chunk is
// q ^ (l % 8) throughout.  A = the x tile transposed (rows w, depth c):
// matrices (w 0-7 | 8-15 of the warp's 16) x (c 0-7 | 8-15); B = the
// weight (depth c, columns e): matrices (c 0-7 | 8-15) x (n-tile nt |
// nt + 1); stored y: matrices (e of n-tile nt | nt + 1) x (w 0-7 | 8-15).
template <bool MMA>
__device__ __forceinline__ void product(const Args& a, const bf16* xb,
                                        const bf16* ws, bf16* yb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane >> 3, i8 = lane & 7;
  const uint32_t chunk = ((warp * 2 + (j & 1)) ^ i8) * 16;
  const uint32_t a_at = smem_addr(xb) + ((j >> 1) * 8 + i8) * ROWB + chunk;
  const uint32_t b_at =
      smem_addr(ws) + (((j & 1) * 8 + i8) * a.ld + (j >> 1) * 8) * 2;
  const uint32_t y_at = smem_addr(yb) + ((j >> 1) * 8 + i8) * ROWB + chunk;
  for (int e0 = 0; e0 < a.e; e0 += EC) {
    switch (min(EC, a.e - e0) / 8) {
      case 1: pass<1, MMA>(a, a_at, b_at, y_at, e0); break;
      case 2: pass<2, MMA>(a, a_at, b_at, y_at, e0); break;
      case 3: pass<3, MMA>(a, a_at, b_at, y_at, e0); break;
      case 4: pass<4, MMA>(a, a_at, b_at, y_at, e0); break;
      case 5: pass<5, MMA>(a, a_at, b_at, y_at, e0); break;
      case 6: pass<6, MMA>(a, a_at, b_at, y_at, e0); break;
      case 7: pass<7, MMA>(a, a_at, b_at, y_at, e0); break;
      default: pass<8, MMA>(a, a_at, b_at, y_at, e0); break;
    }
  }
}

template <bool ASYNC, bool MMA>
__global__ void __launch_bounds__(NT)
    mm_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap ymap, const Args a) {
  extern __shared__ float4 smem4[];
  bf16* ws = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem4) +
      ((1024 - (smem_addr(smem4) & 1023)) & 1023));
  bf16* xs = ws + weight_bytes(a) / 2;
  bf16* ys = xs + a.slots * a.kp * WT;
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  __shared__ __align__(8) uint64_t wbar;
  const int tid = threadIdx.x, grid = gridDim.x, b = blockIdx.x;

  // This CTA's items: first, first + stride, ... (n of them).
  int first, stride, n;
  if (a.schedule == kRowloop) {
    first = (int)((long long)b * a.items / grid);
    n = (int)((long long)(b + 1) * a.items / grid) - first;
    stride = 1;
  } else {
    first = b;
    n = (a.items - b + grid - 1) / grid;
    stride = grid;
  }

  // The K padding, where the bulk copy does not land on it; else restage()
  // zeroes it once the rows have moved.
  if (!ASYNC || !moves_in_place(a)) zero_k_pad(a, ws);
  if (ASYNC && tid == 0) {
    for (int s = 0; s < a.slots; ++s) mbar_init(&full[s], 1);
    mbar_init(&wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // Launched as a programmatic dependent of the previous kernel in the
  // stream: the prologue above may overlap its end, and every global read
  // or write below waits for it to complete.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (ASYNC) {
    if (tid == 0) {
      // The weight as one bulk copy, (C, E) being contiguous: a copy of
      // one row per request would be C narrow requests from every CTA.
      mbar_expect_tx(&wbar, (uint32_t)(a.c * a.e * 2));
      bulk_load(ws + weight_landing(a), a.wt, (uint32_t)(a.c * a.e * 2),
                &wbar);
      for (int i = 0; i < min(a.slots, n); ++i)
        issue_x(&xmap, a, first + i * stride, xs + i * a.kp * WT, &full[i]);
    }
  } else {
    stage_sync(a, ws, 0, 0, false);
  }

  for (int i = 0; i < n; ++i) {
    const int t = first + i * stride;
    int r, w0;
    item_of(a, t, r, w0);
    const int s = i % a.slots;
    bf16* xb = xs + s * a.kp * WT;
    bf16* yb = ys + i % a.yslots * y_rows(a) * WT;
    if (ASYNC) {
      if (i == 0) {
        mbar_wait(&wbar, 0);
        if (a.ld != a.e) {
          restage(a, ws);
          __syncthreads();
        }
      }
      mbar_wait(&full[s], (i / a.slots) & 1);
    } else {
      stage_sync(a, xb, r, w0, true);  // slot 0: the ring has one slot
      __syncthreads();
    }
    product<MMA>(a, xb, ws, yb);
    fence_proxy_async();  // the y tile's writes, before the TMA reads them
    __syncthreads();      // slot s is read, the y tile written
    if (tid == 0) {
      for (int yb_i = 0; yb_i < a.nyb; ++yb_i)
        tma_store_3d(&ymap, yb + yb_i * a.ye * WT, w0, yb_i * a.ye, r);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (ASYNC && i + a.slots < n)
        issue_x(&xmap, a, first + (i + a.slots) * stride, xb, &full[s]);
      // The staging slot the next item writes has been read.
      if (a.yslots == 2)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      else
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    __syncthreads();
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A (d0, d1, d2) bf16 tensor, d0 innermost, as a map of (64, box1, 1)
// boxes with the 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* p, int d0, int d1, int d2,
              int box1) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2,
                                 (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)WT, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int g_last_staging[2] = {-1, -1};  // per schedule: 1 async, 0 sync

// A shape's launch geometry: its sizes (no pointers), the dynamic shared
// memory a CTA asks for, the CTAs per SM that leaves and the grid.
struct Plan {
  Args a;
  int smem, per_sm, grid;
};

// The geometry of the kernel at this shape, worked out at its first launch
// on the device and kept: the ring as deep as the most items a CTA walks,
// where it fits, deepened with the occupancy (hence the grid) it leaves
// until the two agree.  Where one wave holds every item, an SM is given no
// more CTAs than ceil(items / SMs): the launch asks for more shared memory
// than the CTA uses until no more fit, since the card does not spread a
// grid of one partial wave evenly (at (R, C, E, W) = (32, 40, 160, 512),
// 256 CTAs took longer at 3 a SM than at 2; scripts/mm_variants.py).
template <bool ASYNC, bool MMA>
cudaError_t plan(int schedule, int r, int c, int e, int width, Plan& p) {
  static std::mutex mu;
  static std::map<std::array<int, 6>, Plan> plans;
  auto kernel = mm_kernel<ASYNC, MMA>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<int, 6> key{dev, schedule, r, c, e, width};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    p = it->second;
    return cudaSuccess;
  }
  // The dynamic shared memory a CTA may have: the device's opt-in limit
  // less the kernel's static mbarriers.
  int limit = 0;
  cudaFuncAttributes fa;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  limit -= (int)fa.sharedSizeBytes;
  Args& a = p.a;
  a = Args{};
  a.r = r, a.c = c, a.e = e, a.w = width, a.schedule = schedule;
  a.ntw = (width + WT - 1) / WT;
  a.items = r * a.ntw;
  a.c16 = (c + 15) / 16 * 16;
  a.nkb = (a.c16 + BOX - 1) / BOX;
  a.kc = ((a.c16 + a.nkb - 1) / a.nkb + 15) / 16 * 16;
  a.kp = a.nkb * a.kc;
  a.ld = weight_ld(e);
  a.nyb = (e + BOX - 1) / BOX;
  a.ye = ((e + a.nyb - 1) / a.nyb + 7) / 8 * 8;
  a.slots = 1;
  a.yslots = 2;
  if (smem_bytes(a) > limit) a.yslots = 1;
  if (smem_bytes(a) > limit) return cudaErrorInvalidValue;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  for (;;) {
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel,
                                                          NT, smem_bytes(a));
    if (err != cudaSuccess) return err;
    if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
    p.grid = std::min(a.items, p.per_sm * sms);
    const int need = (a.items + p.grid - 1) / p.grid;
    if (!ASYNC || need <= a.slots || a.slots == MAX_SLOTS) break;
    Args deeper = a;
    deeper.slots = std::min(need, MAX_SLOTS);
    if (smem_bytes(deeper) > limit) break;
    a = deeper;
  }
  p.smem = smem_bytes(a);
  const int want = (a.items + sms - 1) / sms;
  while (p.per_sm > want && p.smem + 1024 <= limit) {
    p.smem += 1024;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel, NT,
                                                        p.smem);
    if (err != cudaSuccess) return err;
  }
  plans.emplace(key, p);
  return cudaSuccess;
}

// Launches the schedule's kernel, or with `info` fills info[0..6]
// (registers, local bytes a thread, shared memory a CTA asks for, CTAs per
// SM, items, grid, ring slots) and launches nothing.
template <bool ASYNC, bool MMA>
cudaError_t launch(int schedule, const void* x, const void* wt, void* y,
                   int r, int c, int e, int width, cudaStream_t stream,
                   int* info) {
  auto kernel = mm_kernel<ASYNC, MMA>;
  Plan p;
  cudaError_t err = plan<ASYNC, MMA>(schedule, r, c, e, width, p);
  if (err != cudaSuccess) return err;
  Args a = p.a;
  if (info != nullptr) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    info[0] = fa.numRegs;
    info[1] = (int)fa.localSizeBytes;
    info[2] = p.smem;
    info[3] = p.per_sm;
    info[4] = a.items;
    info[5] = p.grid;
    info[6] = a.slots;
    return err;
  }
  a.x = static_cast<const bf16*>(x);
  a.wt = static_cast<const bf16*>(wt);
  CUtensorMap xmap{}, ymap{};
  if (!(make_map(&xmap, x, width, c, r, a.kc) &&
        make_map(&ymap, y, width, e, r, a.ye)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, ymap, a);
  if (err != cudaSuccess) return err;
  g_last_staging[schedule] = ASYNC ? 1 : 0;
  return cudaGetLastError();
}

int dispatch(int schedule, int cut, const void* x, const void* wt, void* y,
             int r, int c, int e, int width, void* stream, int* info) {
  if (r == 0 || width == 0 || e == 0) return 0;
  if ((schedule != kEinsum && schedule != kRowloop) || cut < 0 ||
      cut > kCutAsync || c <= 0 || e % 8 != 0 || width % 8 != 0 ||
      !aligned(x, 16) || !aligned(wt, 16) || !aligned(y, 16))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cut == kCutMma)
    err = launch<true, false>(schedule, x, wt, y, r, c, e, width, st, info);
  else if (cut == kCutAsync)
    err = launch<false, true>(schedule, x, wt, y, r, c, e, width, st, info);
  else
    err = launch<true, true>(schedule, x, wt, y, r, c, e, width, st, info);
  return (int)err;
}

}  // namespace

// x (r, c, width), w (c, e), y (r, e, width), all bf16, contiguous and
// 16-byte aligned; e and width multiples of 8.  Return the cudaError_t of
// the launch.
extern "C" int probe_mm_einsum_launch(const void* x, const void* w, void* y,
                                      int r, int c, int e, int width,
                                      void* stream) {
  return dispatch(kEinsum, kCutNone, x, w, y, r, c, e, width, stream,
                  nullptr);
}

extern "C" int probe_mm_rowloop_launch(const void* x, const void* w, void* y,
                                       int r, int c, int e, int width,
                                       void* stream) {
  return dispatch(kRowloop, kCutNone, x, w, y, r, c, e, width, stream,
                  nullptr);
}

// schedule 0 einsum, 1 rowloop; cut 0 none, 1 the product (y = 0), 2 the
// asynchronous staging (x and the weight by plain loads): timing only.
extern "C" int probe_mm_cut_launch(int schedule, int cut, const void* x,
                                   const void* w, void* y, int r, int c,
                                   int e, int width, void* stream) {
  return dispatch(schedule, cut, x, w, y, r, c, e, width, stream, nullptr);
}

// out[7]: registers, local (spill) bytes a thread, shared memory a CTA,
// CTAs per SM, items, grid and ring slots of the schedule's kernel for this
// shape (no launch; pointers taken as aligned).
extern "C" int probe_mm_occupancy(int schedule, int r, int c, int e,
                                  int width, int* out) {
  const bf16* p = reinterpret_cast<const bf16*>(256);  // 16-byte aligned
  return dispatch(schedule, kCutNone, p, p, const_cast<bf16*>(p), r, c, e,
                  width, nullptr, out);
}

// How the schedule's last launch staged x and the weight: 1 asynchronously
// (TMA boxes), 0 by plain loads (the "async" cut), -1 none yet.
extern "C" int probe_mm_last_staging(int schedule) {
  return schedule == kEinsum || schedule == kRowloop
             ? g_last_staging[schedule]
             : -1;
}
