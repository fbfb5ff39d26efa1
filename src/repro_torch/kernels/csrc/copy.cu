// K1: the copy kernel, the bandwidth yardstick every permutation is
// measured against (paper §2.3, §6).
//
// Replaces: src/repro/kernels/bmmc_permute.py, _copy_kernel (launched by
// copy_through_vmem), a block copy staged through VMEM.
//
// Bound on the H100: bytes. Each element is read once and written once,
// 2 * size bytes over the 3.35 TB/s of HBM3; there is no arithmetic.
//
// This design: one thread block per copy block of 8 x 256 elements (the
// TPU kernel's block), moved as the widest words (up to 16 bytes) that
// divide the array and both pointers, with consecutive threads on
// consecutive words so every access is coalesced. The TPU kernel padded
// the array with zeros to whole blocks and sliced the result back; here
// the last block masks its ragged edge instead. Nothing is staged through
// shared memory: a copy has no reuse to exploit.
#include "words.cuh"

template <typename W>
__global__ void __launch_bounds__(REPRO_THREADS)
copy_kernel(const W* __restrict__ x, W* __restrict__ out, long long n_words,
            int words_per_cta) {
  const long long base = (long long)blockIdx.x * words_per_cta;
#pragma unroll 4
  for (int i = threadIdx.x; i < words_per_cta; i += REPRO_THREADS) {
    const long long k = base + i;
    if (k < n_words) out[k] = x[k];
  }
}

extern "C" int repro_copy(const void* x, void* out, long long n_words,
                          int words_per_cta, int word_bytes, void* stream) {
  if (n_words <= 0 || words_per_cta <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (n_words + words_per_cta - 1) / words_per_cta;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_WORD(word_bytes,
    copy_kernel<W><<<(unsigned)grid, REPRO_THREADS, 0, s>>>(
        (const W*)x, (W*)out, n_words, words_per_cta));
  return (int)cudaGetLastError();
}
