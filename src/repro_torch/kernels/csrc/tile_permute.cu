// K4a: the one-pass tiled BMMC permutation (paper §4.1, §5.1 and its
// generalisation to witness directions), without compute epilogues.
//
// Replaces: src/repro/kernels/bmmc_permute.py, _tile_kernel with epis=()
// (launched by tiled_permute_tables). Tile g reads rows_per_tile (rpt)
// whole rows at in_rows[g], gathers
//     out.flat[r * 2^t + l] = tile.flat[src0.flat[r * 2^t + (l ^ xor_low[g])]]
// and writes whole rows at out_rows[g].
//
// Bound on the H100: bytes. Each element is read once and written once,
// 2 * size bytes over the 3.35 TB/s of HBM3; the row tables add
// 8 bytes per row, 1/(2^t * itemsize / 4) of the data.
//
// This design: the TPU kernel walked every tile in one sequential loop
// behind a num_buffers-deep DMA pipeline. Here the tiles are split among
// thread blocks that run in parallel in any order, so the card keeps
// many tiles in flight instead of a pipeline. A block takes
// `tiles_per_cta` consecutive tiles (one when a tile holds 16 KiB, more
// when tiles are small, e.g. one row each for a mixed complement, so no
// block moves only a few hundred bytes) and
//   1. copies their row ids and lane XORs to shared memory,
//   2. loads their source rows into a shared-memory tile, consecutive
//      threads on consecutive words of a row (coalesced), each thread
//      issuing a batch of loads before it stores any (LoadBatch), so the
//      whole tile is in flight at once,
//   3. writes whole output rows in order (coalesced), each thread taking
//      its word from the tile through src0 (read through the read-only
//      cache: every block shares the one table) and its tile's lane XOR.
// Every row of the tile is padded by one 4-byte bank, so the column-wise
// reads of a transposing gather spread over the banks; the paper's §4.2
// shift study and cp.async/TMA staging are left to later changes
// (num_buffers is kept in the plan geometry but not used here). Steps
// 1-3 are macros in tile_common.cuh, which K4b (tile_fused.cu) shares.
#include "tile_common.cuh"

template <typename W>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_kernel(const W* __restrict__ x, W* __restrict__ out,
            const int* __restrict__ in_rows, const int* __restrict__ out_rows,
            const int* __restrict__ xor_low, const int* __restrict__ src0,
            int n_rows, int rpt_shift, int tiles_per_cta, int t, int wpe,
            int wpe_shift, int row_shift, int pad_words, long long batch) {
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
  REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low, g0,
                         rpt_shift, rows, tiles_per_cta)
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
}

extern "C" int repro_tile_permute(const void* x, void* out,
                                  const int* in_rows, const int* out_rows,
                                  const int* xor_low, const int* src0,
                                  int n_tiles, int n_rows, int rpt_shift,
                                  int tiles_per_cta, int t, int wpe,
                                  int wpe_shift, int row_shift, int pad_words,
                                  long long batch, int word_bytes,
                                  void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = tiles_per_cta << rpt_shift;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem =
        REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words);
    cudaError_t e = allow_smem(tile_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    tile_kernel<W><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, n_rows,
        rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift, pad_words,
        batch);
  });
  return (int)cudaGetLastError();
}
