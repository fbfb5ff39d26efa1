// Shared helpers of the permutation kernels: the word types they move and
// the dispatch from a word width in bytes to the kernel template.
//
// The kernels never look at element values. An element of `itemsize * d`
// bytes is moved as `wpe` words of the widest type that divides it (and
// both pointers), so one instantiation per word width covers every dtype
// (float32, bfloat16, int32, bool, complex) with or without a `d` tail.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_THREADS 256

// Run the statement(s) given after `word_bytes` with `W` bound to the word
// type of that width; an unknown width returns cudaErrorInvalidValue.
#define REPRO_DISPATCH_WORD(word_bytes, ...)                     \
  switch (word_bytes) {                                          \
    case 16: { using W = uint4; __VA_ARGS__; break; }            \
    case 8: { using W = uint2; __VA_ARGS__; break; }             \
    case 4: { using W = uint32_t; __VA_ARGS__; break; }          \
    case 2: { using W = uint16_t; __VA_ARGS__; break; }          \
    case 1: { using W = uint8_t; __VA_ARGS__; break; }           \
    default: return (int)cudaErrorInvalidValue;                  \
  }

// Global loads a thread issues before it stores any of them to shared
// memory: 64 bytes of words (at most 16 words), so a block keeps its
// whole tile's loads in flight at once.
template <typename W>
struct LoadBatch {
  static constexpr int value = sizeof(W) >= 16 ? 4 : (sizeof(W) == 8 ? 8 : 16);
};

// a / d for an index inside one block; `shift` >= 0 when d == 1 << shift.
__device__ __forceinline__ unsigned div_by(unsigned a, unsigned d, int shift) {
  return shift >= 0 ? (a >> shift) : (a / d);
}

// Grid rows for a batch: gridDim.y stops at 65535, so a larger batch is
// folded into a loop over blockIdx.y.
static inline unsigned batch_grid(long long batch) {
  return (unsigned)(batch < 65535 ? batch : 65535);
}

// Opt in to dynamic shared memory above the 48 KB default for `kernel`.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
