// The steps a tiled-BMMC block shares between K4a (tile_permute.cu) and
// K4b (tile_fused.cu): the block's row tables to shared memory, its
// source rows into the shared-memory tile, and the gather of the tile
// into whole output rows. See tile_permute.cu for the design.
//
// The steps are macros, not functions: each expands to exactly the
// statements K4a was measured with, so K4a compiles to the same code as
// before they were shared (the same steps as inlined device functions
// compiled to other SASS, and K4a ran 12-15 % slower on the H100). Each
// macro names, as its arguments, the variables it reads and writes.
//
// Shared-memory layout of a block of `rows` tile rows (`tiles_per_cta`
// tiles): input row ids, output row ids, per-tile lane XORs, then the
// tile itself at a 16-byte boundary, each row of `row_words` words
// padded by `pad_words`.
#pragma once

#include "words.cuh"

// Bytes of the row tables in front of the tile.
#define REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta) \
  (((2 * rows + tiles_per_cta) * 4 + 15) & ~15)

// Step 1: the block's row ids and lane XORs to shared memory.
#define REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows,       \
                               xor_low, g0, rpt_shift, rows, tiles_per_cta) \
  for (int i = threadIdx.x; i < rows; i += REPRO_THREADS) {                 \
    s_in[i] = __ldg(in_rows + (g0 << rpt_shift) + i);                       \
    s_out[i] = __ldg(out_rows + (g0 << rpt_shift) + i);                     \
  }                                                                         \
  for (int i = threadIdx.x; i < tiles_per_cta; i += REPRO_THREADS)          \
    s_xl[i] = __ldg(xor_low + g0 + i);

// Step 2: the source rows of the block into the tile, consecutive
// threads on consecutive words of a row, each thread issuing a batch of
// loads (LoadBatch) before it stores any.
#define REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift, \
                             stride)                                        \
  constexpr int kBatch = LoadBatch<W>::value;                               \
  for (unsigned base = threadIdx.x; base < span;                            \
       base += kBatch * REPRO_THREADS) {                                    \
    W v[kBatch];                                                            \
    _Pragma("unroll")                                                       \
    for (int k = 0; k < kBatch; ++k) {                                      \
      const unsigned li = base + k * REPRO_THREADS;                         \
      if (li < span) {                                                      \
        const unsigned r = div_by(li, row_words, row_shift);                \
        v[k] = xb[(long long)s_in[r] * row_words + (li - r * row_words)];   \
      }                                                                     \
    }                                                                       \
    _Pragma("unroll")                                                       \
    for (int k = 0; k < kBatch; ++k) {                                      \
      const unsigned li = base + k * REPRO_THREADS;                         \
      if (li < span) {                                                      \
        const unsigned r = div_by(li, row_words, row_shift);                \
        tile[r * stride + (li - r * row_words)] = v[k];                     \
      }                                                                     \
    }                                                                       \
  }

// Step 3: whole output rows in order, each thread taking its word from
// the tile through src0 (read through the read-only cache) and its
// tile's lane XOR.
#define REPRO_TILE_GATHER_STORE(ob, tile, s_out, s_xl, src0, span,          \
                                row_words, row_shift, wpe, wpe_shift, t,    \
                                rpt_shift, rpt_mask, row_len, stride)       \
  _Pragma("unroll 4")                                                       \
  for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {         \
    const unsigned r = div_by(li, row_words, row_shift);                    \
    const unsigned rem = li - r * row_words;                                \
    const unsigned cp = div_by(rem, (unsigned)wpe, wpe_shift);              \
    const unsigned w = rem - cp * (unsigned)wpe;                            \
    const unsigned j = r >> rpt_shift, rp = r & rpt_mask;                   \
    const unsigned s =                                                      \
        (unsigned)__ldg(src0 + ((rp << t) | (cp ^ (unsigned)s_xl[j])));     \
    const unsigned rs = (j << rpt_shift) | (s >> t);                        \
    const unsigned cs = s & (unsigned)(row_len - 1);                        \
    ob[(long long)s_out[r] * row_words + rem] =                             \
        tile[rs * stride + cs * (unsigned)wpe + w];                         \
  }

// Shared-memory bytes of a block: the row tables plus the padded tile.
#define REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words)    \
  ((size_t)(((2 * rows + tiles_per_cta) * 4 + 15) & ~15) +                  \
   (size_t)rows * ((size_t)(1 << t) * wpe + pad_words) * sizeof(W))
