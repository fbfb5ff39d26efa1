// The A/B reference of K4a's redesign: K4a as it was before its two
// schedules (one tile a block of about 16 KiB, loaded in words of the
// element's width into a tile padded by one 4-byte bank, then gathered one
// word a thread), built here from the port's tile_common.cuh, whose
// unguarded macros it runs. tools/k4a_sweep.py times it in turns with the
// port's K4a (src/repro_torch/kernels/csrc/tile_permute.cu) and K1.
//
// k4a_old takes the arguments bmmc_permute._tile_args gives (the guarded
// variant's, without the flag word).
#include "tile_common.cuh"


template <typename W, bool kGuard>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_kernel(const W* __restrict__ x, W* __restrict__ out,
            const int* __restrict__ in_rows, const int* __restrict__ out_rows,
            const int* __restrict__ xor_low, const int* __restrict__ src0,
            int n_rows, int rpt_shift, int tiles_per_cta, int t, int wpe,
            int wpe_shift, int row_shift, int pad_words, long long batch,
            int* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  W* tile = reinterpret_cast<W*>(smem + tab_bytes);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned rpt_mask = (1u << rpt_shift) - 1;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  if constexpr (!kGuard) {
    REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low,
                           g0, rpt_shift, rows, tiles_per_cta)
    const unsigned span = (unsigned)rows * row_words;
    const long long batch_words = (long long)n_rows * row_words;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const W* xb = x + b * batch_words;
      W* ob = out + b * batch_words;
      __syncthreads();  // tables ready; the previous batch row's reads done
      REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift,
                           stride)
      __syncthreads();
      REPRO_TILE_GATHER_STORE(ob, tile, s_out, s_xl, src0, span, row_words,
                              row_shift, wpe, wpe_shift, t, rpt_shift,
                              rpt_mask, row_len, stride)
    }
  } else {
    bool bad = false;
    REPRO_TILE_LOAD_TABLES_GUARDED(s_in, s_out, s_xl, in_rows, out_rows,
                                   xor_low, g0, rpt_shift, rows,
                                   tiles_per_cta, n_rows, row_len, bad)
    const unsigned span = (unsigned)rows * row_words;
    const long long batch_words = (long long)n_rows * row_words;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const W* xb = x + b * batch_words;
      W* ob = out + b * batch_words;
      __syncthreads();
      REPRO_TILE_LOAD_ROWS_GUARDED(W, tile, xb, s_in, span, row_words,
                                   row_shift, stride)
      __syncthreads();
      REPRO_TILE_GATHER_STORE_GUARDED(W, ob, tile, s_out, s_xl, src0, span,
                                      row_words, row_shift, wpe, wpe_shift,
                                      t, rpt_shift, rpt_mask, row_len,
                                      stride, bad)
    }
    if (bad) atomicOr(flags, 1);
  }
}

template <bool kGuard>
static int launch_tile(const void* x, void* out, const int* in_rows,
                       const int* out_rows, const int* xor_low,
                       const int* src0, int n_tiles, int n_rows,
                       int rpt_shift, int tiles_per_cta, int t, int wpe,
                       int wpe_shift, int row_shift, int pad_words,
                       long long batch, int word_bytes, int* flags,
                       void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 ||
      (kGuard && flags == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = tiles_per_cta << rpt_shift;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem =
        REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words);
    cudaError_t e = allow_smem(tile_kernel<W, kGuard>, smem);
    if (e != cudaSuccess) return (int)e;
    tile_kernel<W, kGuard><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, n_rows,
        rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift, pad_words,
        batch, flags);
  });
  return (int)cudaGetLastError();
}


extern "C" int k4a_old(const void* x, void* out, const int* in_rows,
                       const int* out_rows, const int* xor_low,
                       const int* src0, int n_tiles, int n_rows,
                       int rpt_shift, int tiles_per_cta, int t, int wpe,
                       int wpe_shift, int row_shift, int pad_words,
                       long long batch, int word_bytes, void* stream) {
  return launch_tile<false>(x, out, in_rows, out_rows, xor_low, src0,
                            n_tiles, n_rows, rpt_shift, tiles_per_cta, t,
                            wpe, wpe_shift, row_shift, pad_words, batch,
                            word_bytes, nullptr, stream);
}
