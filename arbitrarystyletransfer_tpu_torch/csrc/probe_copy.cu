// Copy-rate probe: y = x, streamed through a two-slot ring in shared memory.
//
// Replaces the TPU probe scripts/probe_mega2.py `_copy_kernel` (P1): a
// (B, H, C, W) copy through a 2-slot VMEM ring of `th`-row slabs, one grid
// step per image, the load of slab r + 1 in flight while slab r is stored.
//
// What bounds it on an H100: bytes only, 2 x nbytes over 3.35 TB/s (0.401 ms
// for (8, 512, 160, 512) bf16).  The TPU slab does not fit here (th = 64 at
// C = 160, W = 512 bf16 is 10.5 MB against 227 KB of shared memory), and one
// CTA per image would fill 8 of 132 SMs.  So the design keeps what the probe
// asks about, a two-stage ring with a load in flight while a store drains, on
// tiles that fit and on enough CTAs to fill the card:
//   * the array is cut into contiguous 32 KB tiles; 2 CTAs per SM, each
//     owning a contiguous run of tiles (as a TPU grid step owned an image's
//     slabs) and a ring of two 32 KB slots;
//   * the copies are TMA bulk copies (cp.async.bulk): one thread issues the
//     load of tile i + 1 into the free slot, waits on tile i's mbarrier and
//     issues its store, so at any time one load and one store are in flight
//     per CTA and no register touches the data;
//   * a slot is refilled only after the store that read it has finished
//     reading it (cp.async.bulk.wait_group.read).  The TPU kernel waits on
//     the store of slab r - 1 only at r + 1, after it already refilled that
//     slot with slab r + 1: with three or more slabs its output is not its
//     input.  That race is not reproduced.
// The output equals the input bit for bit, at any dtype.

#include "common.cuh"

namespace {

constexpr int TILE = 32768;  // bytes per slot
constexpr int CTAS_PER_SM = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

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

// Global -> shared, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared -> global, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(32)
    probe_copy_kernel(const char* __restrict__ x, char* __restrict__ y,
                      long long nbytes, long long ntiles) {
  extern __shared__ __align__(128) unsigned char ring[];  // [2][TILE]
  __shared__ __align__(8) uint64_t bar[2];
  if (threadIdx.x != 0) return;  // one thread drives the copy engine
  const long long t0 = ntiles * blockIdx.x / gridDim.x;
  const long long n = ntiles * (blockIdx.x + 1) / gridDim.x - t0;
  if (n <= 0) return;
  auto bytes = [&](long long t) {
    return static_cast<uint32_t>(min((long long)TILE, nbytes - t * TILE));
  };
  mbar_init(&bar[0]);
  mbar_init(&bar[1]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  bulk_load(ring, x + t0 * TILE, bytes(t0), &bar[0]);
  for (long long i = 0; i < n; ++i) {
    const int s = static_cast<int>(i & 1);
    if (i + 1 < n) {
      // Slot 1 - s was last read by the store of tile i - 1: wait until that
      // store has read it, then refill it with tile i + 1.
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      const long long t = t0 + i + 1;
      bulk_load(ring + (1 - s) * TILE, x + t * TILE, bytes(t), &bar[1 - s]);
    }
    // Slot s is used by tiles i = s, s + 2, ...: phase (i / 2) & 1.
    mbar_wait(&bar[s], static_cast<uint32_t>((i >> 1) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_store(y + (t0 + i) * TILE, ring + s * TILE, bytes(t0 + i));
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// y = x over nbytes (a multiple of 16; x and y 16-byte aligned, not
// overlapping).  Returns the cudaError_t of the launch (0 on success).
extern "C" int probe_copy_launch(const void* x, void* y, long long nbytes,
                                 void* stream) {
  using namespace ast_kernels;
  if (nbytes == 0) return 0;
  if (nbytes % 16 != 0 || !aligned(x, 16) || !aligned(y, 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      probe_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * TILE);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (nbytes + TILE - 1) / TILE;
  const int grid = (int)min(ntiles, (long long)CTAS_PER_SM * sms);
  probe_copy_kernel<<<grid, 32, 2 * TILE,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(y), nbytes, ntiles);
  return (int)cudaGetLastError();
}
