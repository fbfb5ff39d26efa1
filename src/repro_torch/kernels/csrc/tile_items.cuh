// The work-item schedule K4b (tile_fused.cu) and K5 (tile_bwd.cu) share:
// a block takes a run of work items (a work item is `per_cta` tiles of one
// batch row, at most 4096 positions), stages all their row ids, lane XORs
// and epilogue bases once, and moves each item's rows with cp.async into a
// shared-memory tile while it computes on another (the host's schedule:
// k4b_schedule / k5_schedule in bmmc_permute.py).
//
// The tile keeps each row's 16-byte chunks whole: a row of `row_words`
// words is padded by one 16-byte chunk (stride = row_words + 16 bytes of
// words), so a row can be copied in 16-byte cp.async copies and read back
// in 16-byte words, and rows shift by four banks. With `vec` (every
// pointer 16-byte aligned, rows of whole 16-byte chunks, an element of
// `DV` words) the loads are 16-byte copies, the gather stores 16 bytes a
// thread (16 / element bytes consecutive output lanes, their src0 entries
// read at once) and K5's copy-out moves 16 bytes a thread; otherwise every
// step moves one word of the element type's own width a thread (cp.async
// for 4 bytes, plain loads for 2- and 1-byte elements).
//
// With kGuard (the guarded K4b, tile_fused.cu) the steps test each table
// entry before the access it addresses; their unguarded statements stay
// apart from the guarded ones (if constexpr), as they were: folding the
// two (`!kGuard || ...`) compiled the unguarded K4b to other SASS.
//
// Shared memory of a block: s_base (groups int64 batch offsets), then the
// int32 tables of its items (input rows, output rows, lane XORs, and each
// epilogue's hi_base and tw_base entry at the item's first tile), the
// staged plan, then the tiles.
#pragma once

#include "bulk_copy.cuh"
#include "tile_epilogue.cuh"

// One launch of K4b or K5, as the host's schedule fills it
// (bmmc_permute.py's _EpiArgs mirrors this layout field by field).
struct EpiTileArgs {
  const int* in_rows;
  const int* out_rows;
  const int* xor_low;
  const int* src0;          // K4b: src0; K5: inv_src0
  const long long* plan;    // the epilogue plan (epilogue_plan.py)
  long long batch;          // batch rows
  long long n_work;         // work items, batch * n_groups
  int n_words;              // int64 words of plan
  int n_epi;                // epilogues of the plan
  int n_rows;               // rows of one batch row, 2^(n - t)
  int t;                    // log2 elements a row
  int rpt_shift;            // log2 rows a tile
  int wpe;                  // words (of the element type) an element
  int wpe_shift;            // log2 wpe, or -1
  int row_shift;            // log2 of a row's words, or -1
  int per_cta;              // tiles a work item (a power of two)
  int per_cta_shift;        // log2 per_cta
  int groups;               // work items a block
  int n_groups;             // work items a batch row
  int n_buf;                // work items in flight (1 or 2)
  int stride;               // words a tile row takes in shared memory
  int word_bytes;           // bytes of the element type's word
  int vec;                  // 16-byte copies, gathers and stores
  int elem_type;            // 0 int32, 1 float32, 2 bfloat16, 3 float16,
                            // 4 int8, 5 uint8 (bool), 6 int16, 7 uint16,
                            // 8 uint32
  int d;                    // tail values an element
  int dv;                   // tail values a register slot holds
  int regs;                 // positions a thread holds (16 or 8)
  int maps;                 // K4b: the cluster holds maps
  int has_cmp;              // K5: the cluster holds compares
  int n_spill;              // K5: compare-bit sets in shared memory
  int n_map_sets;           // K5: map input sets (maps x chunks)
  int grid;                 // blocks
  int smem;                 // dynamic shared-memory bytes a block
};

// The block's tables in shared memory.
struct ItemTables {
  long long* base;   // batch offset (in words) of each item
  int* in;           // item k's input rows at in + (k << rows_shift)
  int* out;          // and its output rows
  int* xl;           // its lane XORs at xl + (k << per_cta_shift)
  int* eb;           // its epilogue bases at eb + 2 * n_epi * k
  int* plan;         // the staged plan
  unsigned char* tiles;
};

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

// Bytes of the tables and staged plan in front of the tiles.
__host__ __device__ __forceinline__ size_t item_table_bytes(
    int groups, int rows, int per_cta, int n_epi, int n_words) {
  return align16((size_t)groups * 8) +
         align16((size_t)groups * (2 * rows + per_cta + 2 * n_epi) * 4) +
         plan_bytes(n_words);
}

__device__ __forceinline__ ItemTables carve_items(unsigned char* smem,
                                                  const EpiTileArgs& a,
                                                  int rows) {
  ItemTables s;
  s.base = reinterpret_cast<long long*>(smem);
  s.in = reinterpret_cast<int*>(smem + align16((size_t)a.groups * 8));
  s.out = s.in + a.groups * rows;
  s.xl = s.out + a.groups * rows;
  s.eb = s.xl + a.groups * a.per_cta;
  s.plan = reinterpret_cast<int*>(
      smem + align16((size_t)a.groups * 8) +
      align16((size_t)a.groups * (2 * rows + a.per_cta + 2 * a.n_epi) * 4));
  s.tiles = smem + item_table_bytes(a.groups, rows, a.per_cta, a.n_epi,
                                    a.n_words);
  return s;
}

// Stage the tables of the block's nw items (from work item w0) and the
// plan, whose per-tile base words use_item_bases fills per item. The
// caller's next barrier makes them visible. kGuard (the guarded K4b): a
// row id outside [0, n_rows) or a lane XOR outside [0, 2^t) sets *bad and
// is staged as -1.
template <bool kGuard = false>
__device__ __forceinline__ void stage_items(const ItemTables& s,
                                            const EpiTileArgs& a,
                                            long long w0, int nw, int rows,
                                            int rows_shift,
                                            long long batch_words,
                                            bool* bad = nullptr) {
  for (int k = threadIdx.x; k < nw; k += REPRO_THREADS)
    s.base[k] = (w0 + k) / a.n_groups * batch_words;
  for (int i = threadIdx.x; i < (nw << rows_shift); i += REPRO_THREADS) {
    const long long grp = (w0 + (i >> rows_shift)) % a.n_groups;
    const long long at = (grp << rows_shift) + (i & (rows - 1));
    if constexpr (kGuard) {
      const int vi = __ldg(a.in_rows + at), vo = __ldg(a.out_rows + at);
      const bool oki = (unsigned)vi < (unsigned)a.n_rows;
      const bool oko = (unsigned)vo < (unsigned)a.n_rows;
      *bad |= !(oki && oko);
      s.in[i] = oki ? vi : -1;
      s.out[i] = oko ? vo : -1;
    } else {
      s.in[i] = __ldg(a.in_rows + at);
      s.out[i] = __ldg(a.out_rows + at);
    }
  }
  for (int i = threadIdx.x; i < (nw << a.per_cta_shift);
       i += REPRO_THREADS) {
    const long long grp = (w0 + (i >> a.per_cta_shift)) % a.n_groups;
    if constexpr (kGuard) {
      const int v = __ldg(a.xor_low + (grp << a.per_cta_shift) +
                          (i & (a.per_cta - 1)));
      const bool ok = (unsigned)v < (1u << a.t);
      *bad |= !ok;
      s.xl[i] = ok ? v : -1;
    } else {
      s.xl[i] = __ldg(a.xor_low + (grp << a.per_cta_shift) +
                      (i & (a.per_cta - 1)));
    }
  }
  // each epilogue's hi_base and tw_base entry at each item's first tile
  // (a word the plan leaves 0 stays 0: no table)
  const int ebase = kHdrWords + (int)__ldg(a.plan) * kPhaseWords;
  const int per_item = 2 * a.n_epi;
  for (int i = threadIdx.x; i < nw * per_item; i += REPRO_THREADS) {
    const int k = i / per_item, f = i - k * per_item;
    const long long p = __ldg(a.plan + ebase + (f >> 1) * kEpiWords +
                              ((f & 1) ? EP_TW_BASE : EP_HI_BASE));
    const long long grp = (w0 + k) % a.n_groups;
    s.eb[i] = p ? __ldg(reinterpret_cast<const int*>(p) +
                        (grp << a.per_cta_shift))
                : 0;
  }
  for (int i = threadIdx.x; i < a.n_words; i += REPRO_THREADS)
    s.plan[i] = (int)__ldg(a.plan + i);
}

// Item k's epilogue bases into the staged plan. The caller has passed a
// barrier since the previous item's phases; the next phase's barrier
// makes them visible.
__device__ __forceinline__ void use_item_bases(const ItemTables& s, int k,
                                               int n_epi) {
  const int ebase = kHdrWords + s.plan[0] * kPhaseWords;
  for (int i = threadIdx.x; i < 2 * n_epi; i += REPRO_THREADS)
    s.plan[ebase + (i >> 1) * kEpiWords +
           ((i & 1) ? EP_TW_BASE : EP_HI_BASE)] = s.eb[2 * n_epi * k + i];
}

// Bytes of one tile of `rows` rows of `stride` words, 16-aligned.
__host__ __device__ __forceinline__ size_t item_tile_bytes(int rows,
                                                           int stride,
                                                           int word_bytes) {
  return align16((size_t)rows * stride * word_bytes);
}

// An item's rows (ids in rows_tab) into a tile, one commit group: 16-byte
// cp.async copies with vec, else one word of W a thread, consecutive
// threads on consecutive chunks (words) of a row. kGuard: a row staged as
// -1 is filled with zeros (stage_copy_or_zero) and not read.
template <typename W, bool kGuard = false>
__device__ __forceinline__ void load_item_rows(W* tile, const W* xb,
                                               const int* rows_tab,
                                               unsigned span,
                                               unsigned row_words,
                                               int row_shift, unsigned stride,
                                               bool vec) {
  constexpr int CW = 16 / (int)sizeof(W);
  if (vec) {
    for (unsigned li = threadIdx.x * CW; li < span;
         li += REPRO_THREADS * CW) {
      const unsigned r = div_by(li, row_words, row_shift);
      const unsigned q = li - r * row_words;
      if constexpr (kGuard) {
        const int row = rows_tab[r];
        stage_copy_or_zero<16>(tile + r * stride + q,
                               xb + (long long)max(row, 0) * row_words + q,
                               row >= 0);
      } else {
        stage_copy<16>(tile + r * stride + q,
                       xb + (long long)rows_tab[r] * row_words + q);
      }
    }
  } else {
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned r = div_by(li, row_words, row_shift);
      const unsigned q = li - r * row_words;
      if constexpr (kGuard) {
        const int row = rows_tab[r];
        stage_copy_or_zero<(int)sizeof(W)>(
            tile + r * stride + q,
            xb + (long long)max(row, 0) * row_words + q, row >= 0);
      } else {
        stage_copy<(int)sizeof(W)>(tile + r * stride + q,
                                   xb + (long long)rows_tab[r] * row_words +
                                       q);
      }
    }
  }
  cp_async_commit();
}

// The element of DV words of W a vector gather moves as one.
template <typename W, int DV>
struct ElemVec {
  using type = W;
};
template <>
struct ElemVec<uint32_t, 2> {
  using type = uint2;
};
template <>
struct ElemVec<uint16_t, 2> {   // a planar bfloat16 or float16 pair
  using type = uint32_t;
};
template <>
struct ElemVec<unsigned long long, 2> {   // a planar float64 pair
  using type = uint4;
};

// An item's output rows from its tile: out.flat[r * 2^t + l] =
// tile.flat[src0.flat[r * 2^t + (l ^ xl[j])]] (j the row's tile), whole
// rows at rout[r]. With vec, each thread stores 16 bytes: VE = 16 /
// element bytes consecutive lanes, whose src0 entries are those at
// (l ^ xl_hi) + m, read at once and taken in the order m ^ xl_lo
// (xl_lo = xl & (VE - 1)), as K4a's narrow schedule does (tile_permute.cu);
// VE is 1 to 16 (1-byte elements: 16 lanes, four int4 loads of src0).
// kGuard (the guarded K4b, tables staged by stage_items<true>): a lane
// whose src0 entry lies outside the tile sets *bad and stores zero; a
// tile whose lane XOR is -1 reads no src0 entry and stores zeros; a row
// whose output id is -1 is not written.
template <typename W, int DV, bool kGuard = false>
__device__ __forceinline__ void gather_item(W* ob, const W* tile,
                                            const int* rout, const int* xls,
                                            const int* __restrict__ src0,
                                            const EpiTileArgs& a,
                                            unsigned span, unsigned row_words,
                                            unsigned stride,
                                            bool* bad = nullptr) {
  const unsigned lane_mask = (1u << a.t) - 1;
  const unsigned rpt_mask = (1u << a.rpt_shift) - 1;
  if (a.vec) {
    constexpr int CW = 16 / (int)sizeof(W);
    constexpr int VE = CW / DV;
    using E = typename ElemVec<W, DV>::type;
#pragma unroll 2
    for (unsigned li = threadIdx.x * CW; li < span;
         li += REPRO_THREADS * CW) {
      const unsigned r = div_by(li, row_words, a.row_shift);
      const unsigned rem = li - r * row_words;
      const unsigned j = r >> a.rpt_shift, rp = r & rpt_mask;
      const unsigned xl = (unsigned)xls[j];
      union {
        E e[VE];
        uint4 v;
      } pack;
      if (kGuard && (int)xl < 0) {
        pack.v = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const unsigned l0 = rem / DV;   // the first output lane
        const int* e = src0 + ((rp << a.t) | (l0 ^ (xl & ~(VE - 1u))));
        int s[VE];
        if constexpr (VE == 1) {
          s[0] = __ldg(e);
        } else if constexpr (VE == 2) {
          const int2 v = __ldg(reinterpret_cast<const int2*>(e));
          s[0] = v.x;
          s[1] = v.y;
        } else {
#pragma unroll
          for (int m = 0; m < VE; m += 4) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(e + m));
            s[m] = v.x;
            s[m + 1] = v.y;
            s[m + 2] = v.z;
            s[m + 3] = v.w;
          }
        }
#pragma unroll
        for (int bit = 1; bit < VE; bit <<= 1) {   // s[m] <- s[m ^ xl_lo]
          const bool flip = xl & bit;
#pragma unroll
          for (int m = 0; m < VE; ++m) {
            if (!(m & bit)) {
              const int lo = s[m], hi = s[m | bit];
              s[m] = flip ? hi : lo;
              s[m | bit] = flip ? lo : hi;
            }
          }
        }
#pragma unroll
        for (int m = 0; m < VE; ++m) {
          const unsigned sm = (unsigned)s[m];
          const unsigned rs = (j << a.rpt_shift) | (sm >> a.t);
          if constexpr (kGuard) {   // one compare an entry
            const bool ok = sm < (1u << (a.rpt_shift + a.t));
            *bad |= !ok;
            pack.e[m] = ok ? *reinterpret_cast<const E*>(
                                 tile + rs * stride + (sm & lane_mask) * DV)
                           : E{};
          } else {
            pack.e[m] = *reinterpret_cast<const E*>(
                tile + rs * stride + (sm & lane_mask) * DV);
          }
        }
      }
      if constexpr (kGuard) {
        const int orow = rout[r];
        if (orow >= 0)
          *reinterpret_cast<uint4*>(ob + (long long)orow * row_words + rem) =
              pack.v;
      } else {
        *reinterpret_cast<uint4*>(ob + (long long)rout[r] * row_words +
                                  rem) = pack.v;
      }
    }
  } else {
#pragma unroll 4
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned r = div_by(li, row_words, a.row_shift);
      const unsigned rem = li - r * row_words;
      const unsigned cp = div_by(rem, (unsigned)a.wpe, a.wpe_shift);
      const unsigned w = rem - cp * (unsigned)a.wpe;
      const unsigned j = r >> a.rpt_shift, rp = r & rpt_mask;
      if constexpr (kGuard) {
        const int xl = xls[j];
        W val = W{};
        if (xl >= 0) {
          const unsigned s =
              (unsigned)__ldg(src0 + ((rp << a.t) | (cp ^ (unsigned)xl)));
          if (s < (1u << (a.rpt_shift + a.t))) {
            const unsigned rs = (j << a.rpt_shift) | (s >> a.t);
            val = tile[rs * stride + (s & lane_mask) * (unsigned)a.wpe + w];
          } else {
            *bad = true;
          }
        }
        const int orow = rout[r];
        if (orow >= 0) ob[(long long)orow * row_words + rem] = val;
      } else {
        const unsigned s =
            (unsigned)__ldg(src0 + ((rp << a.t) | (cp ^ (unsigned)xls[j])));
        const unsigned rs = (j << a.rpt_shift) | (s >> a.t);
        ob[(long long)rout[r] * row_words + rem] =
            tile[rs * stride + (s & lane_mask) * (unsigned)a.wpe + w];
      }
    }
  }
}

// An item's tile back to whole rows at rows_tab (K5: where the forward
// read them), 16 bytes a thread with vec, else one word.
template <typename W>
__device__ __forceinline__ void copy_out_item(W* ob, const W* tile,
                                              const int* rows_tab,
                                              unsigned span,
                                              unsigned row_words,
                                              int row_shift, unsigned stride,
                                              bool vec) {
  if (vec) {
    constexpr int CW = 16 / (int)sizeof(W);
#pragma unroll 2
    for (unsigned li = threadIdx.x * CW; li < span;
         li += REPRO_THREADS * CW) {
      const unsigned r = div_by(li, row_words, row_shift);
      const unsigned q = li - r * row_words;
      *reinterpret_cast<uint4*>(ob + (long long)rows_tab[r] * row_words +
                                q) =
          *reinterpret_cast<const uint4*>(tile + r * stride + q);
    }
  } else {
#pragma unroll 4
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned r = div_by(li, row_words, row_shift);
      const unsigned q = li - r * row_words;
      ob[(long long)rows_tab[r] * row_words + q] = tile[r * stride + q];
    }
  }
}

// cp.async.wait_group with a run-time count of 0 .. 3 groups left pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}
