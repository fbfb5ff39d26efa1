// K4b: the one-pass tiled BMMC with fused compute epilogues (DESIGN.md
// §10): compare-exchange (cmp) and radix-2 butterfly (bfly) stages run on
// the tile in shared memory, in order, before the intra-tile gather.
//
// Replaces: src/repro/kernels/bmmc_permute.py, _tile_kernel with a
// non-empty `epis` (apply_computes, partner_vals; launched by
// tiled_permute_tables). Tile g loads its rows at in_rows[g]; for each
// epilogue, tile position (r, c) pairs with (r ^ vr, c ^ vc) and
//     hi = hi_row[r] ^ hi_lane[c] ^ hi_base[g]
//   cmp:  v = hi ? max(v, partner) : min(v, partner), elementwise over
//         the tail d (int32, float32, bfloat16);
//   bfly: (lo, hi) pair values of the planar (re, im) tail, twiddle
//         w = w_planar[tw_row[r] ^ tw_lane[c] ^ tw_base[g]],
//         v = hi ? lo - w * hi_val : lo + w * hi_val;
// then gathers out.flat[r * 2^t + l] = tile.flat[src0.flat[r * 2^t +
// (l ^ xor_low[g])]] into whole rows at out_rows[g].
//
// Bound on the H100: bytes. Each element is read once and written once;
// the row tables add 8 bytes per row, the epilogue tables a few bytes
// per row and lane, and a butterfly reads one 8-byte twiddle per pair
// (the table itself, 2^(n-1) x 8 bytes, stays in the 50 MB L2 cache).
// The arithmetic is a few operations per element per epilogue, far below
// the card's rate.
//
// This design: the load and the gather are K4a's (tile_common.cuh), so a
// fused pass moves its bytes exactly as a plain tiled pass does. Between
// them the block runs the epilogues on its tile:
//   * one thread owns each pair — the position whose bit at the lowest
//     set bit of the combined XOR (vr << t | vc) is 0 — reads both
//     members, computes both outputs and writes both, so no pair is read
//     after its partner was rewritten; a __syncthreads() separates the
//     epilogues and the last one from the gather;
//   * elements are typed (T = int32, float, or bfloat16 kept as its bits)
//     while the load and the gather move raw words;
//   * min and max propagate NaN (fmaxf/fminf would drop it) and order
//     -0 below +0: equal operands give their bitwise AND (max) or OR
//     (min), as cmp_max / cmp_min in bmmc_permute.py do;
//   * the butterfly rounds every product and sum on its own
//     (__fmul_rn/__fadd_rn/__fsub_rn: no contraction into FMAs), so it
//     is bit-equal to the plain PyTorch version on the card;
//   * the epilogue descriptors (kind, vr, vc and seven table pointers,
//     int64 each) are read from device memory, so a cluster may carry any
//     number of epilogues; each epilogue's row, lane and per-tile tables
//     are staged in shared memory once per block, before the tile.
// The epilogue code itself is in tile_epilogue.cuh, which the gradient
// kernel K5 (tile_bwd.cu) shares to replay these epilogues bit for bit.
#include "tile_common.cuh"
#include "tile_epilogue.cuh"

template <typename W, typename T>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_fused_kernel(const W* __restrict__ x, W* __restrict__ out,
                  const int* __restrict__ in_rows,
                  const int* __restrict__ out_rows,
                  const int* __restrict__ xor_low,
                  const int* __restrict__ src0,
                  const long long* __restrict__ epis, int n_epi, int n_rows,
                  int rpt_shift, int tiles_per_cta, int t, int wpe,
                  int wpe_shift, int row_shift, int pad_words,
                  long long batch, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rpt = 1 << rpt_shift;
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  int* s_epi = reinterpret_cast<int*>(smem + tab_bytes);
  unsigned char* tile_bytes =
      smem + tab_bytes + epi_table_bytes(n_epi, rpt, t, tiles_per_cta);
  W* tile = reinterpret_cast<W*>(tile_bytes);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  const unsigned rpt_mask = (1u << rpt_shift) - 1;
  const int slot = epi_slot(rpt, t, tiles_per_cta);
  const TileView tv{tile_bytes, stride * (unsigned)sizeof(W),
                    (unsigned)wpe * (unsigned)sizeof(W), (1u << t) - 1,
                    rpt_mask, t, rpt_shift, rpt, row_len};
  REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low, g0,
                         rpt_shift, rows, tiles_per_cta)
  stage_epi_tables(s_epi, epis, n_epi, rpt, row_len, slot, g0);
  const unsigned span = (unsigned)rows * row_words;
  const unsigned pairs = ((unsigned)rows << t) >> 1;
  const long long batch_words = (long long)n_rows * row_words;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const W* xb = x + b * batch_words;
    W* ob = out + b * batch_words;
    __syncthreads();  // tables ready; the previous batch row's reads done
    REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift,
                         stride)
    for (int e = 0; e < n_epi; ++e) {
      __syncthreads();  // the tile (or the previous epilogue) complete
      forward_epilogue<T>(tv, epis + (long long)e * kEpiWords,
                          s_epi + e * slot, slot / 2, pairs, d, NoHook{});
    }
    __syncthreads();
    REPRO_TILE_GATHER_STORE(ob, tile, s_out, s_xl, src0, span, row_words,
                            row_shift, wpe, wpe_shift, t, rpt_shift,
                            rpt_mask, row_len, stride)
  }
}

template <typename T>
static int launch_fused(const void* x, void* out, const int* in_rows,
                        const int* out_rows, const int* xor_low,
                        const int* src0, const long long* epis, int n_epi,
                        int n_tiles, int n_rows, int rpt_shift,
                        int tiles_per_cta, int t, int wpe, int wpe_shift,
                        int row_shift, int pad_words, long long batch,
                        int word_bytes, int d, cudaStream_t s) {
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem =
        REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words) +
        (size_t)epi_table_bytes(n_epi, 1 << rpt_shift, t, tiles_per_cta);
    cudaError_t e = allow_smem(tile_fused_kernel<W, T>, smem);
    if (e != cudaSuccess) return (int)e;
    tile_fused_kernel<W, T><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, epis, n_epi,
        n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift,
        pad_words, batch, d);
  });
  return (int)cudaGetLastError();
}

// elem_type: 0 = int32, 1 = float32, 2 = bfloat16.
extern "C" int repro_tile_fused(const void* x, void* out, const int* in_rows,
                                const int* out_rows, const int* xor_low,
                                const int* src0, const long long* epis,
                                int n_epi, int n_tiles, int n_rows,
                                int rpt_shift, int tiles_per_cta, int t,
                                int wpe, int wpe_shift, int row_shift,
                                int pad_words, long long batch,
                                int word_bytes, int elem_type, int d,
                                void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 ||
      n_epi <= 0 || d <= 0 || epis == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_type) {
    case 0:
      return launch_fused<int>(x, out, in_rows, out_rows, xor_low, src0, epis,
                               n_epi, n_tiles, n_rows, rpt_shift,
                               tiles_per_cta, t, wpe, wpe_shift, row_shift,
                               pad_words, batch, word_bytes, d, s);
    case 1:
      return launch_fused<float>(x, out, in_rows, out_rows, xor_low, src0,
                                 epis, n_epi, n_tiles, n_rows, rpt_shift,
                                 tiles_per_cta, t, wpe, wpe_shift, row_shift,
                                 pad_words, batch, word_bytes, d, s);
    case 2:
      return launch_fused<Bf16>(x, out, in_rows, out_rows, xor_low, src0,
                                epis, n_epi, n_tiles, n_rows, rpt_shift,
                                tiles_per_cta, t, wpe, wpe_shift, row_shift,
                                pad_words, batch, word_bytes, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
