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

// The guarded steps (the variants K4a and K4b launch under the guard):
// the same three steps, each table entry tested before the access it
// addresses. A row id outside [0, n_rows) or a lane XOR outside
// [0, row_len) sets `bad` as it is staged and is staged as -1; step 2
// loads a row staged as -1 as zeros instead of reading it, step 3 skips
// the write of an output row staged as -1, and writes zero for a word
// whose tile's lane XOR is -1 or whose src0 entry lies outside the tile
// (also setting `bad`) instead of reading shared memory through it. The
// kernel sets bit 1 of its flag word when `bad` is set at its end.
#define REPRO_TILE_LOAD_TABLES_GUARDED(s_in, s_out, s_xl, in_rows,        \
                                       out_rows, xor_low, g0, rpt_shift,   \
                                       rows, tiles_per_cta, n_rows,        \
                                       row_len, bad)                       \
  for (int i = threadIdx.x; i < rows; i += REPRO_THREADS) {                 \
    const int vi = __ldg(in_rows + (g0 << rpt_shift) + i);                  \
    const int vo = __ldg(out_rows + (g0 << rpt_shift) + i);                 \
    const bool oki = (unsigned)vi < (unsigned)n_rows;                       \
    const bool oko = (unsigned)vo < (unsigned)n_rows;                       \
    bad |= !(oki && oko);                                                   \
    s_in[i] = oki ? vi : -1;                                                \
    s_out[i] = oko ? vo : -1;                                               \
  }                                                                         \
  for (int i = threadIdx.x; i < tiles_per_cta; i += REPRO_THREADS) {        \
    const int v = __ldg(xor_low + g0 + i);                                  \
    const bool ok = (unsigned)v < (unsigned)row_len;                        \
    bad |= !ok;                                                             \
    s_xl[i] = ok ? v : -1;                                                  \
  }

#define REPRO_TILE_LOAD_ROWS_GUARDED(W, tile, xb, s_in, span, row_words,    \
                                     row_shift, stride)                     \
  constexpr int kBatch = LoadBatch<W>::value;                               \
  for (unsigned base = threadIdx.x; base < span;                            \
       base += kBatch * REPRO_THREADS) {                                    \
    W v[kBatch];                                                            \
    _Pragma("unroll")                                                       \
    for (int k = 0; k < kBatch; ++k) {                                      \
      const unsigned li = base + k * REPRO_THREADS;                         \
      if (li < span) {                                                      \
        const unsigned r = div_by(li, row_words, row_shift);                \
        const int sr = s_in[r];                                             \
        v[k] = sr >= 0 ? xb[(long long)sr * row_words + (li - r * row_words)] \
                       : W{};                                               \
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

#define REPRO_TILE_GATHER_STORE_GUARDED(W, ob, tile, s_out, s_xl, src0,     \
                                        span, row_words, row_shift, wpe,    \
                                        wpe_shift, t, rpt_shift, rpt_mask,  \
                                        row_len, stride, bad)               \
  _Pragma("unroll 4")                                                       \
  for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {         \
    const unsigned r = div_by(li, row_words, row_shift);                    \
    const unsigned rem = li - r * row_words;                                \
    const unsigned cp = div_by(rem, (unsigned)wpe, wpe_shift);              \
    const unsigned w = rem - cp * (unsigned)wpe;                            \
    const unsigned j = r >> rpt_shift, rp = r & rpt_mask;                   \
    const int xl = s_xl[j];                                                 \
    W val = W{};                                                            \
    if (xl >= 0) {                                                          \
      const unsigned s =                                                    \
          (unsigned)__ldg(src0 + ((rp << t) | (cp ^ (unsigned)xl)));        \
      if (s < (1u << (rpt_shift + t))) {                                    \
        const unsigned rs = (j << rpt_shift) | (s >> t);                    \
        const unsigned cs = s & (unsigned)(row_len - 1);                    \
        val = tile[rs * stride + cs * (unsigned)wpe + w];                   \
      } else {                                                              \
        bad = true;                                                         \
      }                                                                     \
    }                                                                       \
    const int orow = s_out[r];                                              \
    if (orow >= 0) ob[(long long)orow * row_words + rem] = val;             \
  }

// Shared-memory bytes of a block: the row tables plus the padded tile.
#define REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words)    \
  ((size_t)(((2 * rows + tiles_per_cta) * 4 + 15) & ~15) +                  \
   (size_t)rows * ((size_t)(1 << t) * wpe + pad_words) * sizeof(W))
