// K1: the copy kernel, the bandwidth yardstick every permutation is
// measured against (paper §2.3, §6).
//
// Replaces: src/repro/kernels/bmmc_permute.py, _copy_kernel (launched by
// copy_through_vmem), a block copy staged through VMEM.
//
// Bound on the H100: bytes. Each byte is read once and written once,
// 2 * size bytes over the 3.35 TB/s of HBM3; there is no arithmetic.
//
// The host (copy_schedule in bmmc_permute.py) cuts the array into a head
// (the bytes before the source's first word boundary), a body of whole
// words and a tail (less than a word), and names one of two paths. The
// head and the tail are copied byte by byte by threads of block 0 in the
// same launch, so a ragged size copies its body as wide as a round one.
// Offsets are 64-bit (2^30 int32 is 4 GiB).
//
// * words, the path K1 takes: W is the widest word (16, 8, 4, 2 or 1
//   bytes) on which source and destination agree. A block of 1024 threads
//   (256 for a copy too small to give every SM a block of 1024) moves one
//   tile of 16 bytes a thread, each thread 16 / W words, all loaded
//   (streaming, __ldcs) before any is stored (__stcs). The host launches
//   one block a tile, in order, so the card's block scheduler walks the
//   array as one sliding window. Measured against x.clone() at 2^30 int32
//   on the H100 (PERF.md, section 6; tools/copy_sweep.py), this is what
//   matched it: the same kernel on a persistent grid of a few blocks an
//   SM, or with more bytes in flight a thread, was slower.
// * bulk, Hopper's copy engine, run when the host asks for it (both
//   pointers alike modulo 16): a persistent grid of one block an SM (the
//   ring's 128 KiB leave no room for a second), each walking the body's
//   chunks grid-strided through a ring of BULK_STAGES stages of
//   BULK_CHUNK bytes in dynamic shared memory. One thread of the block
//   issues everything: a bulk load (cp.async.bulk ... complete_tx) into a
//   stage, signalled by the stage's mbarrier; once the phase of that
//   parity completes, a bulk store out of the stage (one bulk group).
//   Before a stage is refilled, cp.async.bulk.wait_group.read 1 waits
//   until the store that read it is done, so BULK_STAGES - 1 loads and up
//   to two stores stay in flight a block. Four stages of 32 KiB: 128 KiB
//   is the largest power of two a block's 227 KiB hold, and four stages
//   keep 96 KiB of loads in flight an SM. It is kept, and held bit for
//   bit on the card, as the measured starting point of the TMA staging the
//   tiled kernels want (bulk_copy.cuh): at 2^30 it ran a few per cent
//   behind the words path.
#include "bulk_copy.cuh"
#include "words.cuh"

#define BULK_CHUNK (32 * 1024) // bytes of one bulk copy, and of its stage
#define BULK_STAGES 4
#define BULK_THREADS 32
#define WORD_THREADS 1024 // the most threads of a words-path block
#define THREAD_BYTES 16   // bytes a words-path thread moves

// The head (threads 0-15) and the tail (threads 16-31) of block 0.
__device__ __forceinline__ void copy_edges(const uint8_t* __restrict__ x,
                                           uint8_t* __restrict__ out,
                                           long long head, long long tail0,
                                           long long nbytes) {
  if (blockIdx.x != 0) return;
  const int t = threadIdx.x;
  if (t < head) out[t] = x[t];
  const long long k = tail0 + (t - 16);
  if (t >= 16 && t < 32 && k < nbytes) out[k] = x[k];
}

template <typename W>
__global__ void __launch_bounds__(WORD_THREADS)
copy_words_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                  long long nbytes, long long head, long long n_words) {
  constexpr int F = THREAD_BYTES / sizeof(W);   // words in flight a thread
  const int T = blockDim.x;
  const long long t0 = (long long)blockIdx.x * T * F;   // this block's tile
  copy_edges(x, out, head, head + n_words * (long long)sizeof(W), nbytes);
  const W* src = reinterpret_cast<const W*>(x + head);
  W* dst = reinterpret_cast<W*>(out + head);
  const long long i = t0 + threadIdx.x;
  if (t0 + (long long)T * F <= n_words) {
    W v[F];
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = __ldcs(src + i + k * T);
#pragma unroll
    for (int k = 0; k < F; ++k) __stcs(dst + i + k * T, v[k]);
  } else {
    for (int k = 0; k < F; ++k)
      if (i + k * T < n_words)
        __stcs(dst + i + k * T, __ldcs(src + i + k * T));
  }
}

__global__ void __launch_bounds__(BULK_THREADS)
copy_bulk_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 long long nbytes, long long head, long long body) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[BULK_STAGES];
  copy_edges(x, out, head, head + body, nbytes);
  if (threadIdx.x != 0) return;

  const uint8_t* src = x + head;
  uint8_t* dst = out + head;
  const long long n_chunks = (body + BULK_CHUNK - 1) / BULK_CHUNK;
  const long long mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(full);
  for (int s = 0; s < BULK_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
  fence_barrier_init();

  // chunk j of this block: its byte offset in the body and its size
  auto off_of = [&](long long j) {
    return ((long long)blockIdx.x + j * gridDim.x) * BULK_CHUNK;
  };
  auto size_of = [&](long long off) {
    return (uint32_t)min((long long)BULK_CHUNK, body - off);
  };
  auto load = [&](long long j, int s) {
    const long long off = off_of(j);
    const uint32_t bytes = size_of(off);
    mbar_arrive_expect_tx(bar0 + 8 * s, bytes);
    bulk_load(ring0 + (uint32_t)s * BULK_CHUNK, src + off, bytes,
              bar0 + 8 * s);
  };

  for (int s = 0; s < BULK_STAGES && s < mine; ++s) load(s, s);
  int s = 0, prev = BULK_STAGES - 1;
  uint32_t parity = 0;
  for (long long j = 0; j < mine; ++j) {
    mbar_wait(bar0 + 8 * s, parity);
    const long long off = off_of(j);
    bulk_store(dst + off, ring0 + (uint32_t)s * BULK_CHUNK, size_of(off));
    bulk_commit();
    // refill the stage the previous store read, once it has read it
    if (j >= 1 && j - 1 + BULK_STAGES < mine) {
      bulk_wait_read<1>();
      load(j - 1 + BULK_STAGES, prev);
    }
    prev = s;
    if (++s == BULK_STAGES) {
      s = 0;
      parity ^= 1;
    }
  }
  bulk_wait_all();
}

// Once per device: allow the ring's dynamic shared memory, and ask for the
// whole carveout as shared memory (a copy has no use for L1).
static cudaError_t configure_bulk() {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(copy_bulk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BULK_CHUNK * BULK_STAGES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(copy_bulk_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// path 0: bulk (word_bytes 16, BULK_THREADS threads, at most one block a
// chunk), 1: words (one block of `threads` a tile of threads * 16 bytes).
// Every argument comes from the host's copy_schedule; a schedule the
// kernels cannot run is refused.
extern "C" int repro_copy(const void* x, void* out, long long nbytes,
                          long long head, long long body, int path,
                          int word_bytes, int threads, int grid,
                          void* stream) {
  const long long tail = nbytes - head - body;
  const uintptr_t src = (uintptr_t)x + head, dst = (uintptr_t)out + head;
  if (nbytes <= 0 || head < 0 || body < 0 || tail < 0 || head >= 16 ||
      tail >= 16 || grid <= 0 || word_bytes <= 0 || word_bytes > 16 ||
      body % word_bytes || src % word_bytes || dst % word_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == 0) {
    if (word_bytes != 16 || body == 0 || threads != BULK_THREADS ||
        grid > (body + BULK_CHUNK - 1) / BULK_CHUNK)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = configure_bulk();
    if (e != cudaSuccess) return (int)e;
    copy_bulk_kernel<<<(unsigned)grid, BULK_THREADS,
                       (size_t)BULK_CHUNK * BULK_STAGES, s>>>(
        (const uint8_t*)x, (uint8_t*)out, nbytes, head, body);
  } else if (path == 1) {
    const long long tile = (long long)threads * THREAD_BYTES;
    if (threads % 32 || threads < 32 || threads > WORD_THREADS ||
        grid != (body > 0 ? (body + tile - 1) / tile : 1))
      return (int)cudaErrorInvalidValue;
    const long long n_words = body / word_bytes;
    REPRO_DISPATCH_WORD(word_bytes,
      copy_words_kernel<W><<<(unsigned)grid, threads, 0, s>>>(
          (const uint8_t*)x, (uint8_t*)out, nbytes, head, n_words));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
