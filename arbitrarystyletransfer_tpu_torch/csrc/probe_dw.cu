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
// flat_block as NHWC), so both kernels share one schedule, the one sweep 1
// of the block kernels uses (expand_dw.cuh), and differ only in how a tile
// lies in memory and in shared memory:
//   * persistent CTAs of 128 threads walk a list of tiles, every grid-th
//     one; a tile is RG output rows (RG + 2p input rows; RG = 8 at k5, 4 at
//     k3, which then runs seven CTAs per SM, three at k5) of a column
//     segment of one channel (dw_t: 512 columns) or of 32 channels
//     (dw_nhwc: 16 columns); the list runs row group fastest, so the tiles
//     that share halo rows run in one wave and the second read of a halo row
//     comes from L2;
//   * the halo of a tile is staged in shared memory asynchronously, into a
//     ring of two slots with one full mbarrier each: the load of the CTA's
//     tile i + 1 is in flight while tile i computes, and tile i + 2's is
//     started as soon as every thread holds tile i's window in registers;
//   * dw_t stages each input row of a tile as one bulk copy (cp.async.bulk,
//     the copy probe's instruction), so the circular wrap is an index into
//     shared memory: where a tile is whole rows (W <= 512) the first and
//     last strips read their wrap columns from the row itself; where W
//     takes more segments, two more copies stage 4 columns (16 bytes) past
//     each side, taken mod W (two copies of 16 bytes a row, which a tile of
//     whole rows saves); bulk copies need W % 4 == 0 and 16-byte aligned x
//     and y, and any other W stages each tile with plain loads (`sync`),
//     pads included;
//   * dw_nhwc stages a TMA box (32 channels, 16 + 2p columns, RG + 2p rows)
//     of a tensor map over the padded x; the box's innermost coordinate, the
//     channel, is a multiple of 32 floats, and the map fills zeros past
//     the ragged edges;
//   * each thread owns a strip of CW = 4 columns x RG rows of one channel
//     (dw_t: the threads of a CTA side by side along W; dw_nhwc: a lane per
//     channel, a warp per strip), reads its (RG + 2p) x (CW + 2p) window
//     from shared memory once (dw_t: three float4 per row; dw_nhwc: one
//     float per value, 32 consecutive channels a warp), and feeds every
//     value to all its taps in registers: 96 values for 32 outputs at k5
//     where the previous design loaded 7.5 per output through L1;
//   * y is stored from registers as whole lines: dw_t a float4 of
//     consecutive w per thread, 512 B per warp and row; dw_nhwc 32
//     consecutive channels of one pixel per warp.
// probe_dw_cut_launch times the schedule with one part cut out (the FMAs,
// or the asynchronous staging); probe_dw_occupancy reports registers,
// spill, shared memory, CTAs per SM, tiles and grid for a shape.

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ast_kernels;

constexpr int NT = 128;            // threads per CTA
constexpr int CW = 4;              // output columns per thread
constexpr int SLOTS = 2;           // the ring's slots per CTA
constexpr int LOOKAHEAD = 2;       // tiles staged ahead of the one computed
constexpr int PADT = 4;            // dw_t: staged columns past each side
constexpr int TWT = NT * CW;       // dw_t: columns per tile (512)
constexpr int CB = 32;             // dw_nhwc: channels per tile, one a lane
constexpr int TWN = NT / 32 * CW;  // dw_nhwc: columns per tile (16)

enum { kT = 0, kNhwc = 1 };
enum { kCutNone = 0, kCutFma = 1, kCutAsync = 2 };

template <int L, int K>
struct Geo {
  static constexpr int P = (K - 1) / 2;
  static constexpr int RG = K == 5 ? 8 : 4;  // output rows a tile and thread
  static constexpr int HR = RG + 2 * P;  // staged rows
  // staged columns: dw_t 4 + 512 + 4 floats, dw_nhwc 16 + 2p pixels
  static constexpr int HC = L == kT ? TWT + 2 * PADT : TWN + 2 * P;
  static constexpr int ROW = L == kT ? HC : HC * CB;  // floats a staged row
  static constexpr int SLOT = HR * ROW;               // floats a slot
  static constexpr int SMEM = SLOTS * SLOT * 4 + 128;
  static_assert((SLOT * 4) % 128 == 0 || L == kT, "TMA slots: 128 B");
  static_assert((ROW * 4) % 16 == 0, "bulk copies: 16 B");
  static_assert(LOOKAHEAD >= 1 && LOOKAHEAD <= SLOTS, "ring");
};

struct Args {
  const float* x;
  const float* wd;
  float* y;
  int th, c, w;  // output rows, channels, output columns
  int ng, ns;    // row groups, column segments
  int tiles;
  int vec;    // dw_t: W % 4 == 0 and y 16-byte aligned (float4 stores)
  int whole;  // dw_t: a tile is whole rows (W <= 512), W % 4 == 0
};

struct Tile {
  int r0, w0, c0;  // first output row (= first input row), column, channel
};

// Tile t of the list: row group fastest, then column segment, then channel
// (dw_t) or channel block (dw_nhwc).
template <int L, int K>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int rest = t / a.ng;
  return {t % a.ng * Geo<L, K>::RG, rest % a.ns * (L == kT ? TWT : TWN),
          rest / a.ns * (L == kT ? 1 : CB)};
}

// The tile's halo into `slot`, asynchronously, completing on `bar`; run by
// the CTA's first warp.  dw_t: staged column j of row r is input column
// (w0 - 4 + j) mod W, for 4 <= j < tw + 4 and, where W takes more than one
// segment, also for the 4 columns past each side (lane r copies row r; a
// tile of whole rows reads its wrap from the row itself, load_window);
// dw_nhwc: the box at (c0, w0, r0) of the padded input.
template <int L, int K>
__device__ __forceinline__ void stage_async(const CUtensorMap* map,
                                            const Args& a, const Tile& t,
                                            float* slot, uint64_t* bar) {
  using G = Geo<L, K>;
  const int lane = threadIdx.x;
  if constexpr (L == kT) {
    const int rows = min(G::HR, a.th + 2 * G::P - t.r0);
    const int tw = min(TWT, a.w - t.w0);
    const bool pads = !a.whole;
    if (lane == 0)
      mbar_expect_tx(bar, 4u * rows * (tw + (pads ? 2 * PADT : 0)));
    __syncwarp();
    if (lane < rows) {
      const float* src = a.x + ((size_t)(t.r0 + lane) * a.c + t.c0) * a.w;
      float* dst = slot + lane * G::ROW;
      bulk_load(dst + PADT, src + t.w0, 4 * tw, bar);
      if (pads) {
        bulk_load(dst, src + (t.w0 - PADT + a.w) % a.w, 4 * PADT, bar);
        bulk_load(dst + PADT + tw, src + (t.w0 + tw) % a.w, 4 * PADT, bar);
      }
    }
  } else if (lane == 0) {
    mbar_expect_tx(bar, 4u * G::SLOT);
    tma_load_3d(slot, map, t.c0, t.w0, t.r0, bar);
  }
}

// The same halo with plain loads by every thread (zeros where the async
// staging leaves a slot unwritten or the map fills zeros).
template <int L, int K>
__device__ __forceinline__ void stage_sync(const Args& a, const Tile& t,
                                           float* slot) {
  using G = Geo<L, K>;
  const int rows = a.th + 2 * G::P;
  for (int i = threadIdx.x; i < G::SLOT; i += NT) {
    const int r = t.r0 + i / G::ROW, j = i % G::ROW;
    float v = 0.f;
    if constexpr (L == kT) {
      const int col = ((t.w0 - PADT + j) % a.w + a.w) % a.w;
      if (r < rows && j < min(TWT, a.w - t.w0) + 2 * PADT)
        v = a.x[((size_t)r * a.c + t.c0) * a.w + col];
    } else {
      const int col = t.w0 + j / CB, ch = t.c0 + j % CB;
      if (r < rows && col < a.w + 2 * G::P && ch < a.c)
        v = a.x[((size_t)r * (a.w + 2 * G::P) + col) * a.c + ch];
    }
    slot[i] = v;
  }
}

// This thread's window, v[r][j] = the input at staged row r, column
// x0 - p + j of the tile (dw_t: x0 is the thread's first column; dw_nhwc:
// x0 is its warp's first output column, the lane its channel).  `whole`:
// the dw_t tile is whole rows of W columns (W % 4 == 0), whose
// asynchronous staging copies no pads.
template <int L, int K>
__device__ __forceinline__ void load_window(
    const float* slot, int x0, int lane, int w, bool whole,
    float (&v)[Geo<L, K>::HR][CW + K - 1]) {
  using G = Geo<L, K>;
  // dw_t: the three float4 of tile columns x0 - 4 .. x0 + 7, at staged
  // column x0, x0 + 4, x0 + 8; in a tile of whole rows the first strip
  // takes columns W - 4 .. W - 1 (staged at W) and the last columns 0 .. 3
  // (staged at 4) for its wrap.
  const int at[3] = {whole && x0 == 0 ? w : x0, x0 + 4,
                     whole && x0 + CW >= w ? PADT : x0 + 8};
#pragma unroll
  for (int r = 0; r < G::HR; ++r) {
    if constexpr (L == kT) {
      const float* row = slot + r * G::ROW;
      float buf[12];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(row + at[q]);
        buf[4 * q] = f.x;
        buf[4 * q + 1] = f.y;
        buf[4 * q + 2] = f.z;
        buf[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < CW + K - 1; ++j) v[r][j] = buf[PADT - G::P + j];
    } else {
#pragma unroll
      for (int j = 0; j < CW + K - 1; ++j)
        v[r][j] = slot[(r * G::HC + x0 + j) * CB + lane];
    }
  }
}

template <int L, int K, bool ASYNC, bool NOFMA>
__global__ void __launch_bounds__(NT, K == 5 ? 3 : 7)
    dw_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  using G = Geo<L, K>;
  constexpr int P = G::P, RG = G::RG;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) +
      ((128 - (smem_addr(smem4) & 127)) & 127));
  __shared__ __align__(8) uint64_t full[SLOTS];
  const int tid = threadIdx.x, lane = tid % 32, grid = gridDim.x;
  const int n = (a.tiles - (int)blockIdx.x + grid - 1) / grid;
  if (ASYNC && tid == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (ASYNC && tid < 32)
    for (int i = 0; i < min(LOOKAHEAD, n); ++i)
      stage_async<L, K>(&map, a, tile_of<L, K>(a, blockIdx.x + i * grid),
                        ring + i * G::SLOT, &full[i]);
  const int x0 = L == kT ? tid * CW : tid / 32 * CW;

  for (int i = 0; i < n; ++i) {
    const Tile t = tile_of<L, K>(a, blockIdx.x + i * grid);
    const int s = ASYNC ? i % SLOTS : 0;
    const int c = L == kT ? t.c0 : t.c0 + lane;
    float wk[K * K];
#pragma unroll
    for (int q = 0; q < K * K; ++q)
      wk[q] = c < a.c ? __ldg(a.wd + q * a.c + c) : 0.f;
    if (ASYNC) {
      mbar_wait(&full[s], (i / SLOTS) & 1);
    } else {
      __syncthreads();  // the previous tile's windows are in registers
      stage_sync<L, K>(a, t, ring);
      __syncthreads();
    }
    float v[G::HR][CW + K - 1];
    load_window<L, K>(ring + s * G::SLOT, x0, lane, a.w, a.whole, v);
    if (ASYNC) {
      // Every window is in registers: slot s is free, and so is the slot
      // of tile i + LOOKAHEAD (last read by tile i + LOOKAHEAD - SLOTS).
      __syncthreads();
      const int next = i + LOOKAHEAD;
      if (tid < 32 && next < n)
        stage_async<L, K>(&map, a, tile_of<L, K>(a, blockIdx.x + next * grid),
                          ring + next % SLOTS * G::SLOT, &full[next % SLOTS]);
    }

    float o[RG][CW];
#pragma unroll
    for (int oy = 0; oy < RG; ++oy)
#pragma unroll
      for (int cw = 0; cw < CW; ++cw)
        o[oy][cw] = NOFMA ? v[oy + P][cw + P] : 0.f;
    if constexpr (!NOFMA) {
#pragma unroll
      for (int dj = 0; dj < K; ++dj)
#pragma unroll
        for (int di = 0; di < K; ++di)
#pragma unroll
          for (int oy = 0; oy < RG; ++oy)
#pragma unroll
            for (int cw = 0; cw < CW; ++cw)
              o[oy][cw] = fmaf(v[oy + di][cw + dj], wk[di * K + dj],
                               o[oy][cw]);
    }

#pragma unroll
    for (int oy = 0; oy < RG; ++oy) {
      const int r = t.r0 + oy;
      if (r >= a.th) break;
      if constexpr (L == kT) {
        const int w = t.w0 + x0;
        float* dst = a.y + ((size_t)r * a.c + c) * a.w + w;
        if (a.vec) {
          if (w < a.w)
            *reinterpret_cast<float4*>(dst) =
                make_float4(o[oy][0], o[oy][1], o[oy][2], o[oy][3]);
        } else {
#pragma unroll
          for (int cw = 0; cw < CW; ++cw)
            if (w + cw < a.w) dst[cw] = o[oy][cw];
        }
      } else if (c < a.c) {
#pragma unroll
        for (int cw = 0; cw < CW; ++cw) {
          const int w = t.w0 + x0 + cw;
          if (w < a.w) a.y[((size_t)r * a.w + w) * a.c + c] = o[oy][cw];
        }
      }
    }
  }
}

// x (rows, wp, c) f32 as the map of dw_nhwc's boxes.
bool make_nhwc_map(CUtensorMap* map, const void* x, int rows, int wp, int c,
                   int box_w, int box_r) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)wp,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 4, (cuuint64_t)wp * c * 4};
  const cuuint32_t box[3] = {CB, (cuuint32_t)box_w, (cuuint32_t)box_r};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int g_last_staging[2] = {-1, -1};  // per layout: 1 async, 0 sync

// Launches the kernel, or with `info` fills info[0..5] (registers, local
// bytes a thread, shared memory a CTA, CTAs per SM, tiles, grid) and
// launches nothing.
template <int L, int K, bool ASYNC, bool NOFMA>
cudaError_t launch(const void* x, const void* wd, void* y, int th, int c,
                   int w, cudaStream_t stream, int* info) {
  using G = Geo<L, K>;
  auto kernel = dw_kernel<L, K, ASYNC, NOFMA>;
  Args a{static_cast<const float*>(x), static_cast<const float*>(wd),
         static_cast<float*>(y), th, c, w, 0, 0, 0, 0, 0};
  a.ng = (th + G::RG - 1) / G::RG;
  a.ns = (w + (L == kT ? TWT : TWN) - 1) / (L == kT ? TWT : TWN);
  a.tiles = a.ng * a.ns * (L == kT ? c : (c + CB - 1) / CB);
  a.vec = L == kT && w % 4 == 0 && aligned(y, 16);
  a.whole = L == kT && a.ns == 1 && w % 4 == 0;
  CUtensorMap map{};
  if (ASYNC && L == kNhwc && info == nullptr &&
      !make_nhwc_map(&map, x, th + 2 * G::P, w + 2 * G::P, c, G::HC, G::HR))
    return cudaErrorInvalidValue;
  // The cut without the ring keeps the ring's shared memory, so that it
  // runs as many CTAs per SM.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        G::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(a.tiles, per_sm * sms);
  if (info != nullptr) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    info[0] = fa.numRegs;
    info[1] = (int)fa.localSizeBytes;
    info[2] = G::SMEM;
    info[3] = per_sm;
    info[4] = a.tiles;
    info[5] = grid;
    return err;
  }
  kernel<<<grid, NT, G::SMEM, stream>>>(map, a);
  g_last_staging[L] = ASYNC ? 1 : 0;
  return cudaGetLastError();
}

// One launch of layout L with `cut` (kCutNone: the entry's kernel, staged
// asynchronously where the layout allows; kCutFma: no FMAs, y = the centre
// tap; kCutAsync: every tile staged by plain loads).
template <int L, int K>
cudaError_t dispatch_k(int cut, const void* x, const void* wd, void* y,
                       int th, int c, int w, cudaStream_t st, int* info) {
  const bool async_ok =
      L == kNhwc || (w % 4 == 0 && aligned(x, 16) && aligned(y, 16));
  if (cut == kCutFma)
    return async_ok ? launch<L, K, true, true>(x, wd, y, th, c, w, st, info)
                    : cudaErrorInvalidValue;
  if (cut == kCutNone && async_ok)
    return launch<L, K, true, false>(x, wd, y, th, c, w, st, info);
  return launch<L, K, false, false>(x, wd, y, th, c, w, st, info);
}

int dispatch(int layout, int cut, const void* x, const void* wd, void* y,
             int th, int c, int w, int k, void* stream, int* info) {
  if (th == 0 || c == 0 || w == 0) return 0;
  if ((k != 3 && k != 5) || (layout != kT && layout != kNhwc) || cut < 0 ||
      cut > kCutAsync)
    return (int)cudaErrorInvalidValue;
  if (layout == kT ? w <= (k - 1) / 2
                   : c % 4 != 0 || !aligned(x, 16))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (layout == kT)
    err = k == 3 ? dispatch_k<kT, 3>(cut, x, wd, y, th, c, w, st, info)
                 : dispatch_k<kT, 5>(cut, x, wd, y, th, c, w, st, info);
  else
    err = k == 3 ? dispatch_k<kNhwc, 3>(cut, x, wd, y, th, c, w, st, info)
                 : dispatch_k<kNhwc, 5>(cut, x, wd, y, th, c, w, st, info);
  return (int)err;
}

}  // namespace

// x (th + 2p, c, w), wd (k, k, c), y (th, c, w), f32 contiguous; k 3 or 5,
// w > p.  Returns the cudaError_t of the launch.
extern "C" int probe_dw_t_launch(const void* x, const void* wd, void* y,
                                 int th, int c, int w, int k, void* stream) {
  return dispatch(kT, kCutNone, x, wd, y, th, c, w, k, stream, nullptr);
}

// x (th + 2p, w + 2p, c), wd (k, k, c), y (th, w, c), f32 contiguous, x
// 16-byte aligned; k 3 or 5, c a multiple of 4.
extern "C" int probe_dw_nhwc_launch(const void* x, const void* wd, void* y,
                                    int th, int c, int w, int k,
                                    void* stream) {
  return dispatch(kNhwc, kCutNone, x, wd, y, th, c, w, k, stream, nullptr);
}

// layout 0 dw_t, 1 dw_nhwc; cut 0 none, 1 the FMAs (y = the centre tap), 2
// the asynchronous staging (plain loads of each tile): timing only.
extern "C" int probe_dw_cut_launch(int layout, int cut, const void* x,
                                   const void* wd, void* y, int th, int c,
                                   int w, int k, void* stream) {
  return dispatch(layout, cut, x, wd, y, th, c, w, k, stream, nullptr);
}

// out[6]: registers, local (spill) bytes a thread, shared memory a CTA,
// CTAs per SM, tiles and grid of the entry's kernel for this shape, staged
// asynchronously where it would be (no launch; pointers taken as aligned).
extern "C" int probe_dw_occupancy(int layout, int th, int c, int w, int k,
                                  int* out) {
  const float* p = reinterpret_cast<const float*>(256);  // 16-byte aligned
  return dispatch(layout, kCutNone, p, p, const_cast<float*>(p), th, c, w, k,
                  nullptr, out);
}

// How the layout's last launch staged its tiles: 1 asynchronously (bulk
// copies or a TMA box), 0 by plain loads, -1 none yet.
extern "C" int probe_dw_last_staging(int layout) {
  return layout == kT || layout == kNhwc ? g_last_staging[layout] : -1;
}
