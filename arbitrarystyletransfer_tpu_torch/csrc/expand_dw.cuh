// Fused 1x1 expand + k x k depthwise of one stride-1 inverted-residual block:
// the device code behind expand_dw.cu (the fused route), the first sweep of
// flat_block.cu (the flat route) and mega_block.cu (the mega route), and the
// two passes of fused_2pass.cu.
//
//   h      = hswish(x @ We + be)              (pre_act; f32 accumulation)
//   out    = hswish(dw_kxk(reflect_pad(h)) + bd)
//   hidden = out rounded to x's dtype,  sums[n, c] = sum over H, W
//
// MODE says where the values are rounded to the I/O dtype, after the TPU
// kernel each route ports, which layout x has and what is written:
//   * kRoundEx: the expanded values are rounded before the depthwise
//     (flatblock._flat_kernel); otherwise the depthwise runs in f32 on the
//     unrounded expanded values (fused_block._fused_kernel,
//     megablock._mega_kernel_t);
//   * kSumRounded: the SE sums are taken of the rounded hidden (_flat_kernel,
//     _mega_kernel_t); otherwise of `out` before it is rounded
//     (_fused_kernel);
//   * kXT: x is (N, H, C, W) with W contiguous (_mega_kernel_t); otherwise
//     NHWC.  The hidden is NHWC either way;
//   * kNoHidden: only the sums are written (_fused_kernel "sums").
// At f32 the rounding bits change nothing.
//
// What bounds it on an H100: at the 512px decoder tail (d8-d10: k5, C_in 40,
// E 160-240, 8 x 512 x 512 pixels) the arithmetic is k*k f32 MACs per hidden
// value for the depthwise (d10: 12.6 G, 0.38 ms at the 67 TFLOP/s f32 peak)
// plus the 1x1 expand, ~1.5x the block's C_in*E MACs per pixel once the
// halo is recomputed, on the tensor cores for bf16 (mma.sync m16n8k16, bf16
// in, f32 accumulate: the products are exact in f32, as in the TPU's bf16
// matmul with f32 accumulation); the only large memory traffic is the one
// write of the hidden (d10: 1.0 GB, 0.30 ms at 3.35 TB/s).  So the design
// aims at the f32 FMA rate of the depthwise, and keeps everything else
// (the x halo's loads, the expand, the hidden's stores) off its way.
//
// Design:
//   * Persistent CTAs of 256 threads: grid (about two per SM, E / 32); a CTA
//     keeps one 32-channel chunk of E and walks (image, 16x16 output tile)
//     items, so the chunk's expand and depthwise weights and biases are
//     staged once per CTA (coalesced), the depthwise weights of the lane's
//     channel held in registers.  The SE sums are kept per thread across the
//     CTA's tiles of one image and added with one atomic per (CTA, image,
//     channel) into a zeroed (N, E) buffer; the order of those adds varies
//     from run to run (a few f32 ulps of the sum).
//   * The x halo ((16+2p)^2 pixels x all of C_in, reflect-indexed: the
//     reflection is an index map, valid because expand and hswish are per
//     pixel; channels past C_in zero, so K is padded to 16 in shared memory,
//     never in HBM) is staged as bf16 rows padded to conflict-free fragment
//     loads.  For NHWC x (C_in % 8 == 0, 16-byte aligned: every NHWC block
//     of the model) the next tile's halo is one TMA box, issued by one
//     thread while this tile's depthwise runs; the box is zero outside the
//     image, and the few halo rows and columns that reflection takes from
//     inside it are copied in shared memory (wait_x), so the reflection
//     stays an index map.  For (N, H, C, W) x it is staged synchronously by
//     a thread per (channel, halo row), 16-byte loads of the interior.
//   * Expand: each warp runs mma.sync on 16-row tiles of the halo x all 32
//     channels over the whole C_in, one tile at a time (the tiles left over
//     after whole rounds of 8 split by 8-channel column), and writes the
//     hswish'd values to the f32 halo buffer with 8-byte stores.  The halo
//     buffer is [pixel][32 channels] with the channel index XOR-swizzled by
//     8 * (pixel % 4), so those stores are conflict-free, and the
//     depthwise's reads (lane = channel, 32 consecutive words of a pixel)
//     stay so.  (f32 x, or other channel counts: a CUDA-core expand, x
//     staged as f32 in 32-channel steps into the halo buffer.)
//   * Depthwise (depthwise_tile): each thread owns one channel (lane) and a
//     8-row x 4-column block of the tile (the 8 warps cover 16 x 16), 32
//     independent accumulators; every value read from shared memory feeds
//     up to 4 * k FMAs (k5: 800 FMAs per 96 reads; k3: 288 per 60).  The
//     swizzle of each read is known at compile time.
//   * The tile's hidden is staged as [pixel][32] in the halo buffer, then
//     written with 16-byte stores (64 contiguous bytes per pixel and chunk).
//   * Shared memory: the f32 halo, (16+2p)^2 * 128 B (51,200 B at k5), the
//     bf16 x halo, 16 * ceil((16+2p)^2 / 16) * (C_in16 + 8) * 2 B (44,800 B
//     at k5, C_in 40), the weights and 1.2 KB: ~100 KB at the k5 decoder
//     shapes: two CTAs per SM, and __launch_bounds__ asks for two, i.e. at
//     most 128 registers (three, at most 85, spilled at k3, gained 3-5%
//     at C_in <= 24 and lost 4% at C_in 80 on an H100; the CUDA-core
//     expand, off the path, asks for one to keep its 50 accumulators at
//     k5 in registers).  The launcher sizes the grid
//     from the occupancy the runtime reports for the shape, never above it.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace ast_kernels {
namespace edw {
// Internal linkage: every source that includes this header gets its own
// copy of the kernels, so no two objects of the library share a symbol.
namespace {

constexpr int TH = 16;        // output tile rows
constexpr int TW = 16;        // output tile columns
constexpr int CE = 32;        // hidden channels per CTA: one per lane
constexpr int CK = 32;        // input channels per step (CUDA-core expand)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DW_ROWS = 8;    // depthwise outputs per thread: rows
constexpr int DW_COLS = 4;    //   and columns
static_assert((TH / DW_ROWS) * (TW / DW_COLS) == NWARPS,
              "the warps' depthwise blocks cover the tile");

// MODE bits (see the top of this file).
constexpr int kRoundEx = 1;
constexpr int kSumRounded = 2;
constexpr int kXT = 4;
constexpr int kNoHidden = 8;
constexpr int kFused = 0;                      // _fused_kernel "hidden"
constexpr int kFlat = kRoundEx | kSumRounded;  // _flat_kernel
constexpr int kMega = kSumRounded | kXT;       // _mega_kernel_t
constexpr int kSums = kNoHidden;               // _fused_kernel "sums"

template <int K>
struct Halo {
  static constexpr int P = (K - 1) / 2;
  static constexpr int HH = TH + 2 * P;      // halo rows
  static constexpr int HW = TW + 2 * P;      // halo columns
  static constexpr int HP = HH * HW;         // halo pixels
  static constexpr int MT = (HP + 15) / 16;  // 16-row MMA tiles
  // The depthwise blocks start at pixels that are multiples of 4, so the
  // swizzle of each of their reads is a compile-time constant.
  static_assert((DW_ROWS * HW) % 4 == 0 && DW_COLS % 4 == 0, "swizzle");
};

// Where a pixel's 32 channels sit in the f32 halo buffer: channel c of
// pixel p at p * 32 + (c ^ swz(p)).
__host__ __device__ constexpr int swz(int p) { return (p & 3) << 3; }

// Byte offsets of the shared memory of expand_halo and the kernel:
//   buf  f32 [HP][32], swizzled: the expanded halo; also the CUDA-core
//        expand's f32 x staging and the tile's hidden before its stores;
//   xs   bf16 [MT * 16][ldx] (MMA only): the x halo, C_in padded to cin16;
//   ws   the chunk's expand weights: bf16 [32][ldx] (MMA), f32 [cin4][32];
//   red  f32 [NWARPS][32]: the SE sums' reduction;
//   bes  f32 [32]: the chunk's expand bias (0 past E);
//   bar  the mbarrier of xs's TMA box;
// from a 128-byte aligned base (smem_base), which `total` leaves room for.
template <int K, bool EXPAND, bool MMA>
struct Smem {
  int cin16, ldx, xs, ws, red, bes, bar, total;
  __host__ __device__ explicit Smem(int cin) {
    cin16 = (cin + 15) / 16 * 16;
    ldx = cin16 + 8;  // 16-byte multiple; rows 4 banks apart: conflict-free
    xs = Halo<K>::HP * CE * 4;
    ws = xs + (MMA ? Halo<K>::MT * 16 * ldx * 2 : 0);
    const int wbytes = MMA ? CE * ldx * 2
                           : (EXPAND ? (cin + 3) / 4 * 4 * CE * 4 : 0);
    red = ws + (wbytes + 15) / 16 * 16;
    bes = red + NWARPS * 32 * 4;
    bar = bes + CE * 4;
    total = bar + 8 + 128;
  }
};

// The dynamic shared memory, aligned to 128 bytes (TMA's destination).
__device__ __forceinline__ char* smem_base() {
  extern __shared__ float4 smem4[];
  char* raw = reinterpret_cast<char*>(smem4);
  return raw + ((128 - (smem_addr(raw) & 127)) & 127);
}

// x (n, h, w, cin) bf16 as the 4-d map of stage_x's boxes (ldx channels,
// 16 + 2p columns, 16 + 2p rows, 1 image), zeros outside; cin % 8 == 0.
template <int K>
bool make_x_map(CUtensorMap* map, const void* x, int n, int h, int w,
                int cin) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int ldx = (cin + 15) / 16 * 16 + 8;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2,
                                 (cuuint64_t)h * w * cin * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ldx, (cuuint32_t)Halo<K>::HW,
                             (cuuint32_t)Halo<K>::HH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x[n] at row gy, column gx, channel ci; xn is image n's base.
template <typename T, bool XT>
__device__ __forceinline__ T x_at(const T* __restrict__ xn, int gy, int gx,
                                  int ci, int W, int cin) {
  return XT ? xn[((size_t)gy * cin + ci) * W + gx]
            : xn[((size_t)gy * W + gx) * cin + ci];
}

// The expand weights of channels [c0, c0 + 32) into ws, the expand bias
// into bes.  The caller's next barrier publishes them.
template <typename T, int K, bool EXPAND, bool MMA>
__device__ __forceinline__ void stage_weights(
    const T* __restrict__ we, const float* __restrict__ be, char* smem,
    const Smem<K, EXPAND, MMA>& L, int cin, int E, int c0) {
  if constexpr (MMA) {
    __nv_bfloat16* wsT = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
    // Lanes on consecutive output channels: coalesced 64-byte reads.
    for (int idx = threadIdx.x; idx < CE * L.cin16; idx += NTHREADS) {
      const int cc = idx % CE, ci = idx / CE;
      T v = from_f32<T>(0.f);
      if (ci < cin && c0 + cc < E) v = we[(size_t)ci * E + c0 + cc];
      wsT[cc * L.ldx + ci] = v;
    }
  } else if constexpr (EXPAND) {
    float* ws = reinterpret_cast<float*>(smem + L.ws);
    const int cin4 = (cin + 3) / 4 * 4;
    for (int idx = threadIdx.x; idx < cin4 * CE; idx += NTHREADS) {
      const int cc = idx % CE, ci = idx / CE;
      float v = 0.f;
      if (ci < cin && c0 + cc < E) v = to_f32(we[(size_t)ci * E + c0 + cc]);
      ws[idx] = v;
    }
  }
  float* bes = reinterpret_cast<float*>(smem + L.bes);
  if (threadIdx.x < CE)
    bes[threadIdx.x] = (be != nullptr && c0 + (int)threadIdx.x < E)
                           ? be[c0 + threadIdx.x]
                           : 0.f;
}

// The bf16 x halo of output tile (ty0, tx0) of image n into xs (MMA only):
// [pixel][ldx], channels past C_in zero.  NHWC x: one TMA box of
// (ldx channels, halo columns, halo rows) from xmap, zeros outside the
// image, completing on bar (wait_x then reflects the image's edges);
// rows past the halo are not written (they feed only dropped outputs).
// (N, H, C, W) x: plain loads and stores, reflected here.  xs must be free
// (the previous expand has ended).
template <typename T, int K, int MODE>
__device__ __forceinline__ void stage_x(const CUtensorMap* xmap,
                                        uint64_t* bar,
                                        const T* __restrict__ xn,
                                        __nv_bfloat16* xs, int ldx,
                                        int cin16, int H, int W, int cin,
                                        int n, int ty0, int tx0) {
  using G = Halo<K>;
  constexpr int P = G::P, HW = G::HW, HP = G::HP;
  if constexpr ((MODE & kXT) == 0) {
    if (threadIdx.x == 0) {
      fence_proxy_async();  // this thread's earlier writes of xs come first
      mbar_expect_tx(bar, HP * ldx * 2);
      tma_load_4d(xs, xmap, 0, tx0 - P, ty0 - P, n, bar);
    }
  } else {
    // One thread per (channel, halo row), lanes on consecutive channels, so
    // the transposing stores are conflict-free.  The 16 interior columns
    // come as two 16-byte loads where the tile lies inside the image and
    // W % 8 == 0 (every block of the model), the 2p reflected edge columns
    // one by one; all loads are issued before the stores.
    constexpr int HH = G::HH;
    const bool vec = W % 8 == 0 && tx0 + TW <= W &&
                     (reinterpret_cast<uintptr_t>(xn) & 15) == 0;
    for (int pr = threadIdx.x; pr < cin16 * HH; pr += NTHREADS) {
      const int q = pr % cin16, hr = pr / cin16;
      __nv_bfloat16* dst = xs + hr * HW * ldx + q;  // column c: c * ldx
      if (q >= cin) {
#pragma unroll
        for (int col = 0; col < HW; ++col) dst[col * ldx] = from_f32<T>(0.f);
        continue;
      }
      const T* row = xn + ((size_t)reflect_idx(ty0 - P + hr, H) * cin + q) * W;
      if (vec) {
        const uint4 a = *reinterpret_cast<const uint4*>(row + tx0);
        const uint4 b = *reinterpret_cast<const uint4*>(row + tx0 + 8);
        T edge[2 * P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          edge[j] = row[reflect_idx(tx0 - P + j, W)];
          edge[P + j] = row[reflect_idx(tx0 + TW + j, W)];
        }
        const T* av = reinterpret_cast<const T*>(&a);
        const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          dst[j * ldx] = edge[j];
          dst[(P + TW + j) * ldx] = edge[P + j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dst[(P + j) * ldx] = av[j];
          dst[(P + 8 + j) * ldx] = bv[j];
        }
      } else {
#pragma unroll
        for (int col = 0; col < HW; ++col)
          dst[col * ldx] = row[reflect_idx(tx0 - P + col, W)];
      }
    }
    // The rows of the last MMA tile past the halo feed only outputs that
    // are dropped; zero them all the same.
    for (int idx = threadIdx.x; idx < (G::MT * 16 - HP) * cin16;
         idx += NTHREADS)
      xs[(HP + idx / cin16) * ldx + idx % cin16] = from_f32<T>(0.f);
  }
}

// Waits for stage_x's TMA box (NHWC x; the barrier's phase parity), then
// writes the reflected halo rows and columns that lie outside the image
// (torch ReflectionPad: -1 -> 1, H -> H - 2) from the rows and columns
// inside it, rows first, so the corners follow.  Halo positions further out
// feed only dropped outputs and stay zero.  The caller's next barrier
// publishes xs.
template <int K>
__device__ __forceinline__ void wait_x(uint64_t* bar, uint32_t parity,
                                       __nv_bfloat16* xs, int ldx, int H,
                                       int W, int ty0, int tx0) {
  using G = Halo<K>;
  constexpr int P = G::P, HH = G::HH, HW = G::HW;
  mbar_wait(bar, parity);
  const bool top = ty0 < P, bottom = ty0 + TH + P > H;
  const bool left = tx0 < P, right = tx0 + TW + P > W;
  if (!(top || bottom || left || right)) return;  // uniform over the CTA
  const int vpp = ldx / 8;  // 16-byte vectors per pixel
  uint4* v = reinterpret_cast<uint4*>(xs);
  // Halo row hr (image row ty0 - P + hr) from its reflection, for the P
  // rows above row 0 and below row H - 1.
  for (int idx = threadIdx.x; idx < 2 * P * HW * vpp; idx += NTHREADS) {
    const int j = idx / (HW * vpp), rest = idx % (HW * vpp);
    const int y = j < P ? j - P : H + (j - P);  // -P..-1, H..H+P-1
    const int hr = y - (ty0 - P), hs = reflect_idx(y, H) - (ty0 - P);
    if (hr >= 0 && hr < HH && hs >= 0 && hs < HH)
      v[hr * HW * vpp + rest] = v[hs * HW * vpp + rest];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * P * HH * vpp; idx += NTHREADS) {
    const int j = idx / (HH * vpp), rest = idx % (HH * vpp);
    const int hr = rest / vpp, q = rest % vpp;
    const int x = j < P ? j - P : W + (j - P);
    const int hc = x - (tx0 - P), hs = reflect_idx(x, W) - (tx0 - P);
    if (hc >= 0 && hc < HW && hs >= 0 && hs < HW)
      v[(hr * HW + hc) * vpp + q] = v[(hr * HW + hs) * vpp + q];
  }
}

// One warp's expand of 16-row tile mt of the halo, 8-channel columns
// [nt0, nt0 + NTN) of the chunk, on the tensor cores: the bias, hswish and
// (ROUND_EX) the rounding, then 8-byte stores into buf at the swizzled
// channel (conflict-free: within a half-warp the four rows g % 4 land 8
// banks apart).  Rows past the halo's hp pixels are dropped.
template <typename T, int NTN, bool ROUND_EX>
__device__ __forceinline__ void expand_mtile(const __nv_bfloat16* xs,
                                             const __nv_bfloat16* wsT,
                                             const float* bes, float* buf,
                                             int ldx, int cin16, int mt,
                                             int nt0, int pre_act, int hp) {
  static_assert(NTN == 1 || NTN % 2 == 0, "B columns come in pairs");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  float acc[NTN][4];
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  // ldmatrix addresses: lane l gives halo row l % 16 at k offset
  // 8 * (l / 16) (A), and channel row 8 * (l / 16) + l % 8 at k offset
  // 8 * ((l / 8) % 2) (B: two 8-channel columns; x2 takes lanes 0-15).
  // Rows ldx * 2 bytes apart (an odd multiple of 16 modulo 128 for every
  // C_in) meet no bank conflict.
  const __nv_bfloat16* ap =
      xs + (mt * 16 + (lane & 15)) * ldx + (lane >> 4) * 8;
  const __nv_bfloat16* bp =
      wsT + (nt0 * 8 + (lane >> 4) * 8 + (lane & 7)) * ldx +
      ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < cin16; ks += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, ap + ks);
    if constexpr (NTN == 1) {
      uint32_t b[2];
      ldmatrix_x2(b, bp + ks);
      mma_bf16(acc[0], a, b);
    } else {
#pragma unroll
      for (int i = 0; i < NTN; i += 2) {
        uint32_t b[4];  // columns i and i + 1, k 0-7 and 8-15 of each
        ldmatrix_x4(b, bp + i * 8 * ldx + ks);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(acc[i], a, b0);
        mma_bf16(acc[i + 1], a, b1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NTN; ++i) {
    const int col = (nt0 + i) * 8 + tig * 2;
    const float b0 = bes[col], b1 = bes[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + g + half * 8;
      if (row >= hp) continue;
      float v0 = acc[i][2 * half] + b0, v1 = acc[i][2 * half + 1] + b1;
      if (pre_act) {
        v0 = hswish(v0);
        v1 = hswish(v1);
      }
      if (ROUND_EX) {
        v0 = round_to<T>(v0);
        v1 = round_to<T>(v1);
      }
      *reinterpret_cast<float2*>(&buf[row * CE + (col ^ swz(row))]) =
          make_float2(v0, v1);
    }
  }
}

// The expanded halo of output tile (ty0, tx0) for the chunk whose weights
// stage_weights put in shared memory, into buf (f32, swizzled; rounded to T
// with kRoundEx).  MMA: the x halo is in xs (stage_x; the caller has waited
// for its copies); otherwise x is read here.  Starts and ends with a
// barrier.  EXPAND: a 1x1 expand precedes the depthwise; MMA: it runs on the
// tensor cores (bf16 only).
template <typename T, int K, bool EXPAND, bool MMA, int MODE>
__device__ __forceinline__ void expand_halo(const T* __restrict__ xn,
                                            char* smem,
                                            const Smem<K, EXPAND, MMA>& L,
                                            int H, int W, int cin,
                                            int pre_act, int ty0, int tx0) {
  using G = Halo<K>;
  constexpr int P = G::P, HW = G::HW, HP = G::HP;
  constexpr bool XT = (MODE & kXT) != 0;
  constexpr bool ROUND_EX = (MODE & kRoundEx) != 0;
  static_assert(EXPAND, "expand==1 takes expand_halo_identity");
  float* buf = reinterpret_cast<float*>(smem);
  const float* bes = reinterpret_cast<const float*>(smem + L.bes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __syncthreads();  // x and the weights are staged; buf's readers are done
  if constexpr (MMA) {
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.xs);
    const __nv_bfloat16* wsT =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.ws);
    // Warp w takes the 16-row tiles w, w + 8, ... as whole tiles (32
    // channels); the MT % 8 left over are split by 8-channel column, one
    // per warp in turn, so no warp does a whole extra tile (k5: 25 tiles).
    constexpr int ROUNDS = G::MT / NWARPS;
    for (int i = 0; i < ROUNDS; ++i)
      expand_mtile<T, CE / 8, ROUND_EX>(xs, wsT, bes, buf, L.ldx, L.cin16,
                                        warp + i * NWARPS, 0, pre_act, HP);
    constexpr int LEFT = (G::MT - ROUNDS * NWARPS) * (CE / 8);
    for (int u = warp; u < LEFT; u += NWARPS)
      expand_mtile<T, 1, ROUND_EX>(xs, wsT, bes, buf, L.ldx, L.cin16,
                                   ROUNDS * NWARPS + u / (CE / 8),
                                   u % (CE / 8), pre_act, HP);
  } else {
    constexpr int NPX = (HP + NWARPS - 1) / NWARPS;  // halo pixels per warp
    const float* ws = reinterpret_cast<const float*>(smem + L.ws);
    float acc[NPX];
#pragma unroll
    for (int i = 0; i < NPX; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += CK) {
      const int kc = min(CK, cin - k0);
      if (k0 > 0) __syncthreads();  // the previous step's readers are done
      for (int idx = threadIdx.x; idx < HP * CK; idx += NTHREADS) {
        const int p = idx / CK, ci = idx % CK;
        float v = 0.f;
        if (ci < kc) {
          const int gy = reflect_idx(ty0 - P + p / HW, H);
          const int gx = reflect_idx(tx0 - P + p % HW, W);
          v = to_f32(x_at<T, XT>(xn, gy, gx, k0 + ci, W, cin));
        }
        buf[idx] = v;
      }
      __syncthreads();
      const int kc4 = (kc + 3) & ~3;  // staged tail channels are zero
      for (int ci = 0; ci < kc4; ci += 4) {
        const float w0 = ws[(k0 + ci + 0) * CE + lane];
        const float w1 = ws[(k0 + ci + 1) * CE + lane];
        const float w2 = ws[(k0 + ci + 2) * CE + lane];
        const float w3 = ws[(k0 + ci + 3) * CE + lane];
#pragma unroll
        for (int i = 0; i < NPX; ++i) {
          const int p = warp + i * NWARPS;
          if (p < HP) {
            const float4 xv =
                *reinterpret_cast<const float4*>(&buf[p * CK + ci]);
            acc[i] = fmaf(xv.x, w0, acc[i]);
            acc[i] = fmaf(xv.y, w1, acc[i]);
            acc[i] = fmaf(xv.z, w2, acc[i]);
            acc[i] = fmaf(xv.w, w3, acc[i]);
          }
        }
      }
    }
    __syncthreads();  // every read of the staged x is done
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int p = warp + i * NWARPS;
      if (p < HP) {
        float v = acc[i] + bes[lane];
        if (pre_act) v = hswish(v);
        buf[p * CE + (lane ^ swz(p))] = ROUND_EX ? round_to<T>(v) : v;
      }
    }
  }
  __syncthreads();
}

// expand==1 (E == cin): the halo of x's channels [c0, c0 + 32) plus the
// bias, into buf.  Starts and ends with a barrier.
template <typename T, int K, int MODE>
__device__ __forceinline__ void expand_halo_identity(
    const T* __restrict__ xn, char* smem, const float* bes, int H, int W,
    int cin, int pre_act, int ty0, int tx0, int c0) {
  using G = Halo<K>;
  constexpr int P = G::P, HW = G::HW, HP = G::HP;
  constexpr bool XT = (MODE & kXT) != 0;
  constexpr bool ROUND_EX = (MODE & kRoundEx) != 0;
  float* buf = reinterpret_cast<float*>(smem);
  __syncthreads();
  for (int idx = threadIdx.x; idx < HP * CE; idx += NTHREADS) {
    const int p = idx / CE, cc = idx % CE;
    float v = 0.f;
    if (c0 + cc < cin) {
      const int gy = reflect_idx(ty0 - P + p / HW, H);
      const int gx = reflect_idx(tx0 - P + p % HW, W);
      v = to_f32(x_at<T, XT>(xn, gy, gx, c0 + cc, W, cin)) + bes[cc];
      if (pre_act) v = hswish(v);
    }
    buf[p * CE + (cc ^ swz(p))] = ROUND_EX ? round_to<T>(v) : v;
  }
  __syncthreads();
}

// First output row and column of this thread's depthwise block.
__device__ __forceinline__ int dw_row0() {
  return (threadIdx.x >> 5) / (TW / DW_COLS) * DW_ROWS;
}
__device__ __forceinline__ int dw_col0() {
  return (threadIdx.x >> 5) % (TW / DW_COLS) * DW_COLS;
}

// The depthwise weights of channel c (0 past E) and its bias.
template <int K>
__device__ __forceinline__ void load_dw(const float* __restrict__ wd,
                                        const float* __restrict__ bd, int E,
                                        int c, float (&wk)[K * K],
                                        float& bdv) {
  const bool c_ok = c < E;
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = c_ok ? wd[(size_t)t * E + c] : 0.f;
  bdv = (bd != nullptr && c_ok) ? bd[c] : 0.f;
}

// Depthwise over the expanded halo in buf for the lane's channel:
// o[r][j] = hswish(dw + bd) in f32 at output row dw_row0() + r, column
// dw_col0() + j of the 16x16 tile.  Each output sums its k*k taps in
// row-major order (row di, then column dj), one fmaf each.  Only reads
// buf; the caller masks the ragged edge and channels past E.
template <int K>
__device__ __forceinline__ void depthwise_tile(const float* buf,
                                               const float (&wk)[K * K],
                                               float bdv,
                                               float (&o)[DW_ROWS][DW_COLS]) {
  constexpr int HW = Halo<K>::HW;
  const int lane = threadIdx.x & 31;
  const float* base = buf + (dw_row0() * HW + dw_col0()) * CE;
  int sw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sw[q] = lane ^ (q << 3);
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j) o[r][j] = 0.f;
#pragma unroll
  for (int hr = 0; hr < DW_ROWS + K - 1; ++hr) {
#pragma unroll
    for (int hc = 0; hc < DW_COLS + K - 1; ++hc) {
      const int p = hr * HW + hc;  // relative to the block's first pixel
      const float v = base[p * CE + sw[p & 3]];
#pragma unroll
      for (int j = 0; j < DW_COLS; ++j) {
        const int dj = hc - j;
        if (dj < 0 || dj >= K) continue;
#pragma unroll
        for (int r = 0; r < DW_ROWS; ++r) {
          const int di = hr - r;
          if (di >= 0 && di < K) o[r][j] = fmaf(v, wk[di * K + dj], o[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j) o[r][j] = hswish(o[r][j] + bdv);
}

// The SE sums of this CTA's tiles of image n: the 8 warps' partials per
// channel reduced in shared memory, one atomic each.
__device__ __forceinline__ void flush_sums(float csum, float* red,
                                           float* __restrict__ sums, int n,
                                           int E, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous flush's reads are done
  red[warp * 32 + lane] = csum;
  __syncthreads();
  if (warp == 0 && c < E) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < NWARPS; ++w8) s += red[w8 * 32 + lane];
    atomicAdd(&sums[(size_t)n * E + c], s);
  }
}

// xmap: x as make_x_map's map (NHWC bf16 x with the tensor-core expand;
// unused otherwise).
template <typename T, int K, bool EXPAND, bool MMA, int MODE>
__global__ void __launch_bounds__(NTHREADS, MMA ? 2 : 1)
    expand_dw_kernel(const __grid_constant__ CUtensorMap xmap,
                     const T* __restrict__ x, const T* __restrict__ we,
                     const float* __restrict__ wd,
                     const float* __restrict__ be,
                     const float* __restrict__ bd, T* __restrict__ hidden,
                     float* __restrict__ sums, int N, int H, int W, int cin,
                     int E, int pre_act, int tiles_x, int tiles_per_image) {
  constexpr bool ASYNC = MMA && (MODE & kXT) == 0;  // TMA x halo
  constexpr int VEC = 16 / (int)sizeof(T);          // values per 16 bytes
  char* smem = smem_base();
  const Smem<K, EXPAND, MMA> L(cin);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  float* buf = reinterpret_cast<float*>(smem);
  T* hs = reinterpret_cast<T*>(smem);  // the tile's hidden, [256][32]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);

  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * CE;
  const int c = c0 + lane;
  const bool c_ok = c < E;
  const int total = N * tiles_per_image;
  int item = blockIdx.x;
  if (item >= total) return;

  stage_weights<T, K, EXPAND, MMA>(we, be, smem, L, cin, E, c0);
  float wk[K * K], bdv;
  load_dw<K>(wd, bd, E, c, wk, bdv);
  auto image_of = [&](int it) { return it / tiles_per_image; };
  auto tile_origin = [&](int it, int& ty0, int& tx0) {
    const int t = it % tiles_per_image;
    ty0 = (t / tiles_x) * TH;
    tx0 = (t % tiles_x) * TW;
  };
  uint32_t xphase = 0;
  if constexpr (ASYNC) {
    if (threadIdx.x == 0) {
      mbar_init(xbar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    int ty0, tx0;
    tile_origin(item, ty0, tx0);
    stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ldx, L.cin16, H, W, cin,
                        image_of(item), ty0, tx0);
  }
  const bool vec_out = E % VEC == 0 &&
                       (reinterpret_cast<uintptr_t>(hidden) & 15) == 0;
  const int oy0 = dw_row0(), ox0 = dw_col0();
  int n_cur = image_of(item);
  float csum = 0.f;

  for (; item < total; item += gridDim.x) {
    const int n = image_of(item);
    int ty0, tx0;
    tile_origin(item, ty0, tx0);
    if (n != n_cur) {
      flush_sums(csum, reinterpret_cast<float*>(smem + L.red), sums, n_cur,
                 E, c);
      csum = 0.f;
      n_cur = n;
    }
    const T* xn = x + (size_t)n * H * W * cin;
    if constexpr (!EXPAND) {
      expand_halo_identity<T, K, MODE>(
          xn, smem, reinterpret_cast<const float*>(smem + L.bes), H, W, cin,
          pre_act, ty0, tx0, c0);
    } else {
      if constexpr (ASYNC) {
        wait_x<K>(xbar, xphase, xs, L.ldx, H, W, ty0, tx0);
        xphase ^= 1;
      } else if constexpr (MMA) {
        stage_x<T, K, MODE>(&xmap, xbar, xn, xs, L.ldx, L.cin16, H, W, cin,
                            n, ty0, tx0);
      }
      expand_halo<T, K, EXPAND, MMA, MODE>(xn, smem, L, H, W, cin, pre_act,
                                           ty0, tx0);
      if constexpr (ASYNC) {
        // The next tile's x halo comes in while this one's depthwise runs.
        const int next = item + gridDim.x;
        if (next < total) {
          int ny0, nx0;
          tile_origin(next, ny0, nx0);
          stage_x<T, K, MODE>(&xmap, xbar, x, xs, L.ldx, L.cin16, H, W, cin,
                              image_of(next), ny0, nx0);
        }
      }
    }
    float o[DW_ROWS][DW_COLS];
    depthwise_tile<K>(buf, wk, bdv, o);
    // The SE sums (only a tile at the image's lower or right edge masks)
    // and the tile's hidden, staged in buf once every read of it is done.
    constexpr bool STORE = (MODE & kNoHidden) == 0;
    const bool full = ty0 + TH <= H && tx0 + TW <= W;
    if constexpr (STORE) __syncthreads();
#pragma unroll
    for (int r = 0; r < DW_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < DW_COLS; ++j) {
        const T hv = from_f32<T>(o[r][j]);
        if (c_ok && (full || (ty0 + oy0 + r < H && tx0 + ox0 + j < W)))
          csum += (MODE & kSumRounded) ? to_f32(hv) : o[r][j];
        if constexpr (STORE) hs[((oy0 + r) * TW + ox0 + j) * CE + lane] = hv;
      }
    if constexpr (STORE) {
      __syncthreads();
      // 16-byte stores: a pixel's 32 channels are CE / VEC vectors.
      constexpr int VPP = CE / VEC;
      for (int idx = threadIdx.x; idx < TH * TW * VPP; idx += NTHREADS) {
        const int p = idx / VPP, cc = (idx % VPP) * VEC;
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        if (gy >= H || gx >= W || c0 + cc >= E) continue;
        T* dst = hidden + ((size_t)n * H * W + (size_t)gy * W + gx) * E + c0 +
                 cc;
        const T* src = hs + p * CE + cc;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < VEC && c0 + cc + j < E; ++j) dst[j] = src[j];
        }
      }
    }
  }
  flush_sums(csum, reinterpret_cast<float*>(smem + L.red), sums, n_cur, E,
             c);
}

template <typename T, int K, bool EXPAND, bool MMA, int MODE>
cudaError_t launch(const void* x, const void* we, const void* wd,
                   const void* be, const void* bd, void* hidden, void* sums,
                   int n, int h, int w, int cin, int e, int pre_act,
                   cudaStream_t stream) {
  const Smem<K, EXPAND, MMA> L(cin);
  auto kernel = expand_dw_kernel<T, K, EXPAND, MMA, MODE>;
  CUtensorMap xmap{};
  if (MMA && (MODE & kXT) == 0 &&
      !make_x_map<K>(&xmap, x, n, h, w, cin))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        NTHREADS, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_per_image = tiles_x * ((h + TH - 1) / TH);
  const int chunks = (e + CE - 1) / CE;
  const long long items = (long long)n * tiles_per_image;
  // Never more CTAs than fit at once: one CTA past that would run alone
  // after all the others, doubling the sweep.
  const int gx = (int)std::min<long long>(
      items, std::max(1, per_sm * sms / chunks));
  dim3 grid(gx, chunks);
  kernel<<<grid, NTHREADS, L.total, stream>>>(
      xmap, static_cast<const T*>(x), static_cast<const T*>(we),
      static_cast<const float*>(wd), static_cast<const float*>(be),
      static_cast<const float*>(bd), static_cast<T*>(hidden),
      static_cast<float*>(sums), n, h, w, cin, e, pre_act, tiles_x,
      tiles_per_image);
  return cudaGetLastError();
}

// Registers, dynamic shared memory (bytes) and resident CTAs per SM of the
// kernel a bf16 block with this k and C_in launches (the tensor-core
// expand), into out[0..2].  Launches nothing.
template <int MODE>
cudaError_t occupancy(int k, int cin, int* out) {
  using B = __nv_bfloat16;
  auto query = [&](auto kernel, int smem) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                          NTHREADS, smem);
    out[0] = a.numRegs;
    out[1] = smem;
    return err;
  };
  if (k == 3)
    return query(expand_dw_kernel<B, 3, true, true, MODE>,
                 Smem<3, true, true>(cin).total);
  if (k == 5)
    return query(expand_dw_kernel<B, 5, true, true, MODE>,
                 Smem<5, true, true>(cin).total);
  return cudaErrorInvalidValue;
}

// Whether the expand runs on the tensor cores: bf16, and for NHWC x the
// 16-byte staging copies need C_in % 8 == 0 and an aligned x.
template <typename T, int MODE>
bool use_mma(const void* x, int cin) {
  return sizeof(T) == 2 &&
         ((MODE & kXT) != 0 || (cin % 8 == 0 && aligned(x, 16)));
}

template <typename T, int K, int MODE>
cudaError_t dispatch_k(const void* x, const void* we, const void* wd,
                       const void* be, const void* bd, void* hidden,
                       void* sums, int n, int h, int w, int cin, int e,
                       int pre_act, cudaStream_t s) {
  if (we == nullptr)
    return launch<T, K, false, false, MODE>(x, we, wd, be, bd, hidden, sums,
                                            n, h, w, cin, e, pre_act, s);
  if (use_mma<T, MODE>(x, cin))
    return launch<T, K, true, sizeof(T) == 2, MODE>(
        x, we, wd, be, bd, hidden, sums, n, h, w, cin, e, pre_act, s);
  return launch<T, K, true, false, MODE>(x, we, wd, be, bd, hidden, sums, n,
                                         h, w, cin, e, pre_act, s);
}

// hidden (n, h, w, e) (unused with kNoHidden) and sums (n, e) must be
// allocated by the caller, sums zeroed; we == nullptr is the expand==1 form
// (e == cin).
template <typename T, int MODE>
cudaError_t dispatch(const void* x, const void* we, const void* wd,
                     const void* be, const void* bd, void* hidden, void* sums,
                     int n, int h, int w, int cin, int e, int k, int pre_act,
                     cudaStream_t s) {
  if (we == nullptr && e != cin) return cudaErrorInvalidValue;
  if (k == 3)
    return dispatch_k<T, 3, MODE>(x, we, wd, be, bd, hidden, sums, n, h, w,
                                  cin, e, pre_act, s);
  if (k == 5)
    return dispatch_k<T, 5, MODE>(x, we, wd, be, bd, hidden, sums, n, h, w,
                                  cin, e, pre_act, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace edw
}  // namespace ast_kernels
