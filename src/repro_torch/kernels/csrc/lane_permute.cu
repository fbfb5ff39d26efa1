// K3: lane permute. Rows of 2^t elements stay in place and every row is
// permuted the same way: out[.., r, l] = x[.., r, src_lane[l]].
//
// Replaces: src/repro/kernels/bmmc_permute.py, `kern` inside
// lane_permute_tables, a jnp.take along the lane axis of a block of rows
// staged through VMEM.
//
// Bound on the H100: bytes. Each element is read once and written once,
// 2 * size bytes over the 3.35 TB/s of HBM3; the 2^t-entry table is read
// once per thread block.
//
// This design: each thread block stages `rows_per_cta` whole rows in
// shared memory with coalesced loads (consecutive threads on consecutive
// words, each thread issuing a batch of loads before it stores any),
// then writes the same rows back in order, each thread fetching its word
// from shared memory through src_lane. Global reads and writes
// are both contiguous runs; only the shared-memory reads are permuted.
// Those reads may meet bank conflicts when the lane map scatters a warp's
// 32 lanes onto few banks; a swizzle is left to a later change.
#include "words.cuh"

template <typename W>
__global__ void __launch_bounds__(REPRO_THREADS)
lane_kernel(const W* __restrict__ x, W* __restrict__ out,
            const int* __restrict__ src_lane, int n_rows, int row_len,
            int wpe, int wpe_shift, int row_words, int row_shift,
            int rows_per_cta, long long batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_src = reinterpret_cast<int*>(smem);
  const int tab_bytes = (row_len * 4 + 15) & ~15;
  W* tile = reinterpret_cast<W*>(smem + tab_bytes);

  for (int i = threadIdx.x; i < row_len; i += REPRO_THREADS)
    s_src[i] = __ldg(src_lane + i);

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const int here = (int)min((long long)rows_per_cta, n_rows - r0);
  const unsigned span = (unsigned)here * (unsigned)row_words;
  const long long batch_words = (long long)n_rows * row_words;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const W* xb = x + b * batch_words + r0 * row_words;
    W* ob = out + b * batch_words + r0 * row_words;
    __syncthreads();  // s_src ready; the previous batch row's reads done
    constexpr int kBatch = LoadBatch<W>::value;
    for (unsigned base = threadIdx.x; base < span;
         base += kBatch * REPRO_THREADS) {
      W v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned li = base + k * REPRO_THREADS;
        if (li < span) v[k] = xb[li];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned li = base + k * REPRO_THREADS;
        if (li < span) tile[li] = v[k];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned r = div_by(li, (unsigned)row_words, row_shift);
      const unsigned rem = li - r * (unsigned)row_words;
      const unsigned l = div_by(rem, (unsigned)wpe, wpe_shift);
      const unsigned w = rem - l * (unsigned)wpe;
      ob[li] = tile[r * (unsigned)row_words +
                    (unsigned)s_src[l] * (unsigned)wpe + w];
    }
  }
}

extern "C" int repro_lane_permute(const void* x, void* out,
                                  const int* src_lane, int n_rows,
                                  int row_len, int wpe, int wpe_shift,
                                  int row_shift, int rows_per_cta,
                                  long long batch, int word_bytes,
                                  void* stream) {
  if (n_rows <= 0 || row_len <= 0 || wpe <= 0 || rows_per_cta <= 0 ||
      batch <= 0)
    return (int)cudaErrorInvalidValue;
  const int row_words = row_len * wpe;
  dim3 grid((unsigned)((n_rows + rows_per_cta - 1) / rows_per_cta),
            batch_grid(batch));
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem = (size_t)((row_len * 4 + 15) & ~15) +
                        (size_t)rows_per_cta * row_words * sizeof(W);
    cudaError_t e = allow_smem(lane_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    lane_kernel<W><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (W*)out, src_lane, n_rows, row_len, wpe, wpe_shift,
        row_words, row_shift, rows_per_cta, batch);
  });
  return (int)cudaGetLastError();
}
