// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA and bulk copies, ldmatrix, and warpgroup matrix multiplies (wgmma).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ast_kernels {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// async proxy (TMA); call once after the inits, before a CTA-wide sync.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Spins until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA stores, wgmma operand reads) and vice versa.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- bulk copies and TMA -----------------------------------------------------

// Global -> shared over `bytes` (a multiple of 16), completing as
// transactions on `bar` (whose expected bytes the caller has set).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared -> global over `bytes`, committed as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// One box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing as transactions on `bar`.  Out-of-range elements are
// written as zeros.  `map` must live in parameter space (__grid_constant__).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; r[i] is matrix i in the mma.sync fragment
// layout (thread g * 4 + t holds row g, columns 2t and 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// ldmatrix_x4 with each matrix transposed: lane l gives the address of
// row l % 8 of matrix l / 8 as stored, and r[i] holds matrix i's transpose
// in the fragment layout (an A fragment from an M-contiguous operand).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Two 8x8 bf16 matrices, as ldmatrix_x4 (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// A barrier over the first `threads` threads of the CTA (id 1; id 0 is
// __syncthreads).
__device__ __forceinline__ void named_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Two bf16 products a * b, each rounded once from the exact product
// (fma with -0, so a product of +0 stays +0).
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda of its own); null where the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One box of a 4-d tensor map, as tma_load_3d.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- warpgroup matrix multiplies -----------------------------------------------

// A shared-memory matrix descriptor for the 128-byte swizzle: the tile
// starts at `p` (inside a 1024-byte-aligned swizzle atom); `lbo` and `sbo`
// are the leading and stride byte offsets.  K-major operands: rows of 128
// bytes, 8-row groups `sbo` = 1024 apart (lbo unused).  MN-major operands:
// 64-element column blocks `lbo` apart, 8-row K groups `sbo` apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait (it does not see their asynchrony).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <uint32_t R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <uint32_t R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// D(64x64, f32) (+)= A(64x16) B(16x64), A and B in shared memory, both
// K-major with the 128-byte swizzle; D is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x256, f32) += A(64x16) B(16x256), A in registers (the m16n8k16
// fragment of each warp's 16 rows), B in shared memory, MN-major with the
// 128-byte swizzle (the transpose bit).  D is the 128 accumulators from
// d[OFF] on.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[N], const uint32_t (&a)[4],
                                             uint64_t db) {
  static_assert(OFF + 128 <= N, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]), "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]), "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]), "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]), "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95]), "+f"(d[OFF + 96]), "+f"(d[OFF + 97]), "+f"(d[OFF + 98]), "+f"(d[OFF + 99]), "+f"(d[OFF + 100]), "+f"(d[OFF + 101]), "+f"(d[OFF + 102]), "+f"(d[OFF + 103]), "+f"(d[OFF + 104]), "+f"(d[OFF + 105]), "+f"(d[OFF + 106]), "+f"(d[OFF + 107]), "+f"(d[OFF + 108]), "+f"(d[OFF + 109]), "+f"(d[OFF + 110]), "+f"(d[OFF + 111]), "+f"(d[OFF + 112]), "+f"(d[OFF + 113]), "+f"(d[OFF + 114]), "+f"(d[OFF + 115]), "+f"(d[OFF + 116]), "+f"(d[OFF + 117]), "+f"(d[OFF + 118]), "+f"(d[OFF + 119]), "+f"(d[OFF + 120]), "+f"(d[OFF + 121]), "+f"(d[OFF + 122]), "+f"(d[OFF + 123]), "+f"(d[OFF + 124]), "+f"(d[OFF + 125]), "+f"(d[OFF + 126]), "+f"(d[OFF + 127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64x128, f32) += A(64x16) B(16x128), A in registers (the m16n8k16
// fragment of each warp's 16 rows), B in shared memory with the 128-byte
// swizzle: MN-major (TRANS_B 1, the transpose bit) or K-major (TRANS_B 0).
// D is the 64 accumulators from d[OFF] on.
template <int OFF, int N, int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N], const uint32_t (&a)[4],
                                             uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}

}  // namespace ast_kernels
