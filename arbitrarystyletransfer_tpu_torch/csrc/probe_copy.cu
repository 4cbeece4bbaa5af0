// Copy-rate probe: y = x, streamed through a ring of slots in shared memory.
//
// Replaces the TPU probe scripts/probe_mega2.py `_copy_kernel` (P1): a
// (B, H, C, W) copy through a 2-slot VMEM ring of `th`-row slabs, one grid
// step per image, the load of slab r + 1 in flight while slab r is stored.
//
// What bounds it on an H100: bytes only, 2 x nbytes over 3.35 TB/s (0.401 ms
// for (8, 512, 160, 512) bf16).  The TPU slab does not fit here (th = 64 at
// C = 160, W = 512 bf16 is 10.5 MB against 227 KB of shared memory), and one
// CTA per image would fill 8 of 132 SMs.  So the design keeps what the probe
// asks about, a ring with loads in flight while stores drain, on tiles that
// fit and on enough CTAs to fill the card:
//   * the array is cut into 32 KB tiles; CTAS_PER_SM CTAs per SM, each with
//     a ring of SLOTS tiles, take every grid-th tile, so that all CTAs
//     stream one window of memory, as the grid of an elementwise kernel does;
//   * the copies are TMA bulk copies (cp.async.bulk) driven by one thread:
//     the load of tile i + LOOKAHEAD is issued right after the store of
//     tile i, so LOOKAHEAD loads and up to SLOTS - LOOKAHEAD stores are in
//     flight per CTA and no register touches the data;
//   * a slot is refilled only once the store that read it has finished
//     reading it: before loading tile i + LOOKAHEAD into the slot of tile
//     i + LOOKAHEAD - SLOTS, `cp.async.bulk.wait_group.read` lets at most
//     SLOTS - LOOKAHEAD newer stores stay unread, so a load waits only for
//     its own slot's store, not behind every earlier one.  The TPU kernel
//     waits on the store of slab r - 1 only at r + 1, after it already
//     refilled that slot with slab r + 1: with three or more slabs its output
//     is not its input.  That race is not reproduced.
// The ring's shape is the fastest of those measured on the H100 (PERF.md
// keeps the table of depths and tile orders).  The output equals the input
// bit for bit, at any dtype.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ast_kernels;

constexpr int TILE = 32768;     // bytes per slot
constexpr int SLOTS = 3;        // slots per CTA
constexpr int LOOKAHEAD = 2;    // loads in flight per CTA
constexpr int CTAS_PER_SM = 2;

__global__ void __launch_bounds__(32)
    probe_copy_kernel(const char* __restrict__ x, char* __restrict__ y,
                      long long nbytes, long long ntiles) {
  extern __shared__ __align__(128) unsigned char ring[];  // [SLOTS][TILE]
  __shared__ __align__(8) uint64_t bar[SLOTS];
  if (threadIdx.x != 0) return;  // one thread drives the copy engine
  const long long g = blockIdx.x, grid = gridDim.x;
  // This CTA's i-th tile is g + i * grid.
  const long long n = (ntiles - g + grid - 1) / grid;
  if (n <= 0) return;
  auto bytes = [&](long long t) {
    return static_cast<uint32_t>(min((long long)TILE, nbytes - t * TILE));
  };
  auto load = [&](long long i) {  // tile i into slot i % SLOTS
    const int s = static_cast<int>(i % SLOTS);
    const long long t = g + i * grid;
    mbar_expect_tx(&bar[s], bytes(t));
    bulk_load(ring + s * TILE, x + t * TILE, bytes(t), &bar[s]);
  };
  for (int s = 0; s < SLOTS; ++s) mbar_init(&bar[s], 1);
  mbar_fence_init();

  for (long long i = 0; i < min((long long)LOOKAHEAD, n); ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int s = static_cast<int>(i % SLOTS);
    const long long t = g + i * grid;
    // Slot s holds tiles s, s + SLOTS, ...: this is its (i / SLOTS)-th fill.
    mbar_wait(&bar[s], static_cast<uint32_t>((i / SLOTS) & 1));
    fence_proxy_async();
    bulk_store(y + t * TILE, ring + s * TILE, bytes(t));
    const long long next = i + LOOKAHEAD;
    if (next < n) {
      // The slot of `next` was last read by the store of tile next - SLOTS,
      // committed SLOTS - LOOKAHEAD (= 1) groups before the newest one.
      static_assert(SLOTS - LOOKAHEAD == 1, "the wait below counts 1");
      if (next >= SLOTS)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(next);
    }
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
      SLOTS * TILE);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (nbytes + TILE - 1) / TILE;
  const int grid = (int)min(ntiles, (long long)CTAS_PER_SM * sms);
  probe_copy_kernel<<<grid, 32, SLOTS * TILE,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(y), nbytes, ntiles);
  return (int)cudaGetLastError();
}
