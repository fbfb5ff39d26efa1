// Variants of the copy kernel K1 (src/repro_torch/kernels/csrc/copy.cu),
// timed against x.clone() by tools/copy_sweep.py to choose K1's design.
// Not part of the port: nothing in src/ loads this library.
//
// * sweep_words: 16-byte words through registers, `F` words in flight a
//   thread (all loaded before any is stored), a tile of threads * F words
//   a block; grid-strided, so a grid of one block a tile is one pass and a
//   smaller grid is persistent. Hints: 0 plain loads and stores,
//   1 streaming (__ldcs / __stcs), 2 a non-coherent load that does not
//   allocate in L1 (ld.global.nc.L1::no_allocate) and __stcs.
// * sweep_bulk: the bulk-copy ring of copy.cu with its chunk and stage
//   count free: one thread a block issues bulk loads into `stages` stages
//   of `chunk` bytes and bulk stores out of them, chunks grid-strided.
//   A grid of one block a chunk is one pass.
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

#define SWEEP_MAX_STAGES 8

template <int HINT>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if (HINT == 0) return *p;
  if (HINT == 1) return __ldcs(p);
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

template <int HINT>
__device__ __forceinline__ void store16(uint4* p, uint4 v) {
  if (HINT == 0)
    *p = v;
  else
    __stcs(p, v);
}

// n16 is a multiple of the tile (the host checks): no masking.
template <int F, int HINT>
__global__ void __launch_bounds__(1024)
sweep_words_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                   long long n16) {
  const int T = blockDim.x;
  const long long tile = (long long)T * F;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n16;
       t0 += (long long)gridDim.x * tile) {
    const long long i = t0 + threadIdx.x;
    uint4 v[F];
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = load16<HINT>(src + i + k * T);
#pragma unroll
    for (int k = 0; k < F; ++k) store16<HINT>(dst + i + k * T, v[k]);
  }
}

__global__ void __launch_bounds__(32)
sweep_bulk_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  long long body, int chunk, int stages) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[SWEEP_MAX_STAGES];
  if (threadIdx.x != 0) return;
  const long long n_chunks = (body + chunk - 1) / chunk;
  const long long mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(full);
  for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
  fence_barrier_init();
  auto off_of = [&](long long j) {
    return ((long long)blockIdx.x + j * gridDim.x) * chunk;
  };
  auto size_of = [&](long long off) {
    return (uint32_t)min((long long)chunk, body - off);
  };
  auto load = [&](long long j, int s) {
    const long long off = off_of(j);
    const uint32_t bytes = size_of(off);
    mbar_arrive_expect_tx(bar0 + 8 * s, bytes);
    bulk_load(ring0 + (uint32_t)s * chunk, src + off, bytes, bar0 + 8 * s);
  };
  for (int s = 0; s < stages && s < mine; ++s) load(s, s);
  int s = 0, prev = stages - 1;
  uint32_t parity = 0;
  for (long long j = 0; j < mine; ++j) {
    mbar_wait(bar0 + 8 * s, parity);
    const long long off = off_of(j);
    bulk_store(dst + off, ring0 + (uint32_t)s * chunk, size_of(off));
    bulk_commit();
    if (j >= 1 && j - 1 + stages < mine) {
      bulk_wait_read<1>();
      load(j - 1 + stages, prev);
    }
    prev = s;
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
  bulk_wait_all();
}

#define SWEEP_HINTS(F)                                                      \
  switch (hint) {                                                           \
    case 0: sweep_words_kernel<F, 0><<<grid, threads, 0, st>>>(s, d, n16); \
      break;                                                                \
    case 1: sweep_words_kernel<F, 1><<<grid, threads, 0, st>>>(s, d, n16); \
      break;                                                                \
    case 2: sweep_words_kernel<F, 2><<<grid, threads, 0, st>>>(s, d, n16); \
      break;                                                                \
    default: return (int)cudaErrorInvalidValue;                             \
  }

extern "C" int sweep_words(const void* x, void* out, long long n16,
                           int threads, int words, int hint, int grid,
                           void* stream) {
  if ((uintptr_t)x % 16 || (uintptr_t)out % 16 || threads % 32 ||
      threads < 32 || threads > 1024 || grid <= 0 || n16 <= 0 ||
      n16 % ((long long)threads * words))
    return (int)cudaErrorInvalidValue;
  const uint4* s = (const uint4*)x;
  uint4* d = (uint4*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (words) {
    case 1: SWEEP_HINTS(1); break;
    case 2: SWEEP_HINTS(2); break;
    case 4: SWEEP_HINTS(4); break;
    case 8: SWEEP_HINTS(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sweep_bulk(const void* x, void* out, long long nbytes,
                          int chunk, int stages, int grid, void* stream) {
  if ((uintptr_t)x % 16 || (uintptr_t)out % 16 || nbytes <= 0 ||
      nbytes % 16 || chunk <= 0 || chunk % 16 || stages < 2 ||
      stages > SWEEP_MAX_STAGES || grid <= 0 ||
      grid > (nbytes + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  const int smem = chunk * stages;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sweep_bulk_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  sweep_bulk_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, nbytes, chunk, stages);
  return (int)cudaGetLastError();
}
