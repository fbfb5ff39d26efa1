// K2: block permute. Output block g is input block src_rows[g], each block
// 2^b consecutive elements; there is no gather inside a block.
//
// Replaces: src/repro/kernels/bmmc_permute.py, _block_kernel (launched by
// block_permute_tables), a copy whose input BlockSpec index map is
// remapped through the scalar-prefetched src_rows table.
//
// Bound on the H100: bytes. Each element is read once and written once,
// 2 * size bytes over the 3.35 TB/s of HBM3; the table adds 4 bytes per
// block.
//
// This design: a copy. Each thread block moves `blocks_per_cta`
// consecutive output blocks (enough for about a thousand words, so a
// small block does not leave most threads idle). A block is moved as the
// widest words that divide its bytes and both pointers, consecutive
// threads on consecutive words: reads and writes are coalesced runs of
// 2^b elements. All offsets are 64-bit; the batch is folded onto
// blockIdx.y.
#include "words.cuh"

template <typename W>
__global__ void __launch_bounds__(REPRO_THREADS)
block_kernel(const W* __restrict__ x, W* __restrict__ out,
             const int* __restrict__ src_rows, int n_rows, int wpb,
             int wpb_shift, int blocks_per_cta, long long batch) {
  const int g0 = blockIdx.x * blocks_per_cta;
  const int here = min(blocks_per_cta, n_rows - g0);
  const unsigned span = (unsigned)here * (unsigned)wpb;
  const long long batch_words = (long long)n_rows * wpb;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const W* xb = x + b * batch_words;
    W* ob = out + b * batch_words;
#pragma unroll 4
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned gl = div_by(li, (unsigned)wpb, wpb_shift);
      const unsigned w = li - gl * (unsigned)wpb;
      const long long g = (long long)g0 + gl;
      const long long src = (long long)__ldg(src_rows + g);
      ob[g * wpb + w] = xb[src * wpb + w];
    }
  }
}

extern "C" int repro_block_permute(const void* x, void* out,
                                   const int* src_rows, int n_rows, int wpb,
                                   int wpb_shift, int blocks_per_cta,
                                   long long batch, int word_bytes,
                                   void* stream) {
  if (n_rows <= 0 || wpb <= 0 || blocks_per_cta <= 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_rows + blocks_per_cta - 1) / blocks_per_cta),
            batch_grid(batch));
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_WORD(word_bytes,
    block_kernel<W><<<grid, REPRO_THREADS, 0, s>>>(
        (const W*)x, (W*)out, src_rows, n_rows, wpb, wpb_shift,
        blocks_per_cta, batch));
  return (int)cudaGetLastError();
}
