// K4b: the one-pass tiled BMMC with fused compute epilogues (DESIGN.md
// §10): compare-exchange (cmp), radix-2 butterfly (bfly) and element-wise
// map stages run on the tile, in order, before the intra-tile gather.
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
//   map:  v = f(v), f the Map's torch function as the tape map_lower.py
//         lowers it to (the reference calls the function on the tile);
// then gathers out.flat[r * 2^t + l] = tile.flat[src0.flat[r * 2^t +
// (l ^ xor_low[g])]] into whole rows at out_rows[g].
//
// Bound on the H100: bytes, 2 * size over 3.35 TB/s, as K4a; the row
// tables add 8 bytes per row and a butterfly reads one 8-byte twiddle per
// element (the table stays in the 50 MB L2 cache). What held the first
// design at 15 % of that bound (device time) was the epilogue phase: per
// pair and epilogue it read six shared-memory table entries, two elements
// and wrote two, behind a barrier per epilogue, and it staged 12 KiB of
// tables per 16 KiB tile.
//
// This design: the load and the gather are K4a's (tile_common.cuh), so a
// fused pass moves its bytes exactly as a plain tiled pass does. Between
// them the epilogues run in registers (tile_epilogue.cuh): the host plan
// (epilogue_plan.py) splits them into phases; in each phase a thread
// takes its 16 (or 8) positions of the tile into registers under the
// phase's layout, runs the phase's epilogues there (partner in a register
// or one warp shuffle away, hi from one mask word and a popc, floats as
// integer keys where the warp holds no NaN), and puts them back; one
// barrier per phase. The 12-compare clusters of a 2^24 sort run in two
// phases. Tails are taken one value at a time (cmp acts on each value of
// the tail alone); a cluster with butterflies holds the planar (re, im)
// pair of each position. A map runs its tape on each register in the
// thread (tile_epilogue.cuh). The kernel is compiled once per element
// type, register count, planar-or-not and with-or-without maps (a
// cluster with maps takes the 8-register variant with the map code; the
// others keep the code they had without it), its tile moved in words of
// the element's own width, with the blocks per SM its registers allow
// chosen by measurement. What still bounds it: instruction issue and the
// latency of each block's load -> phases -> gather sequence (PERF.md).
//
// The guarded variant (kGuard, launched by repro_tile_fused_guarded, for
// clusters without maps) loads and gathers through the guarded steps of
// tile_common.cuh: every row id, lane XOR and src0 entry is tested before
// the access it addresses, an entry out of range sets bit 1 of *flags
// (one atomicOr per thread that met one) and its access is skipped (a
// row not read is loaded as zeros). The epilogue phases are the same.
// The unguarded instantiations compile to the code they had before the
// variant existed (flags unused).
#include "tile_common.cuh"
#include "tile_epilogue.cuh"

// The epilogue phases of one batch row on the block's tile, from the
// staged plan sp (device plan gp).
template <typename T, int DV, int KR, bool kMaps>
__device__ __forceinline__ void fused_phases(const TileView& tv, const int* sp,
                                             const long long* gp, int d) {
  const int n_phases = sp[0], outer_bits = sp[2];
  const int* phases = sp + kHdrWords;
  const int ebase = kHdrWords + n_phases * kPhaseWords;
  T v[DV][KR];
  unsigned m[DV][KR];   // no compare bits in the forward pass
  for (int k = 0; k < d; k += DV) {
    for (int p = 0; p < n_phases; ++p) {
      __syncthreads();  // the tile (or the previous phase) complete
      const int* ph = phases + p * kPhaseWords;
      const PhaseRegs pr(ph);
      for (unsigned c = 0; c < (1u << outer_bits); ++c) {
        const unsigned qb = pr.qt ^ image_of(ph + PH_IMG_OUT, c, outer_bits);
        load_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
        phase_epilogues<false, kMaps>(ph, sp, gp, ebase, v, m, qb, c,
                                      outer_bits, (T*)nullptr);
        store_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
  }
}

template <typename T, int DV, int KR, bool kMaps, int MB, bool kGuard>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_fused_kernel(const typename ElemWord<T>::type* __restrict__ x,
                  typename ElemWord<T>::type* __restrict__ out,
                  const int* __restrict__ in_rows,
                  const int* __restrict__ out_rows,
                  const int* __restrict__ xor_low,
                  const int* __restrict__ src0,
                  const long long* __restrict__ plan, int n_words,
                  int n_rows, int rpt_shift, int tiles_per_cta, int t,
                  int wpe, int wpe_shift, int row_shift, int pad_words,
                  long long batch, int d, int* __restrict__ flags) {
  using W = typename ElemWord<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  int* s_plan = reinterpret_cast<int*>(smem + tab_bytes);
  unsigned char* tile_bytes = smem + tab_bytes + plan_bytes(n_words);
  W* tile = reinterpret_cast<W*>(tile_bytes);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  const unsigned rpt_mask = (1u << rpt_shift) - 1;
  const TileView tv{tile_bytes, stride * (unsigned)sizeof(W),
                    (unsigned)wpe * (unsigned)sizeof(W), (1u << t) - 1, t};
  if constexpr (!kGuard) {
    REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low,
                           g0, rpt_shift, rows, tiles_per_cta)
    stage_plan(s_plan, plan, n_words, g0);
    const unsigned span = (unsigned)rows * row_words;
    const long long batch_words = (long long)n_rows * row_words;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const W* xb = x + b * batch_words;
      W* ob = out + b * batch_words;
      __syncthreads();  // tables ready; the previous batch row's reads done
      REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift,
                           stride)
      fused_phases<T, DV, KR, kMaps>(tv, s_plan, plan, d);
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
    stage_plan(s_plan, plan, n_words, g0);
    const unsigned span = (unsigned)rows * row_words;
    const long long batch_words = (long long)n_rows * row_words;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const W* xb = x + b * batch_words;
      W* ob = out + b * batch_words;
      __syncthreads();
      REPRO_TILE_LOAD_ROWS_GUARDED(W, tile, xb, s_in, span, row_words,
                                   row_shift, stride)
      fused_phases<T, DV, KR, kMaps>(tv, s_plan, plan, d);
      __syncthreads();
      REPRO_TILE_GATHER_STORE_GUARDED(W, ob, tile, s_out, s_xl, src0, span,
                                      row_words, row_shift, wpe, wpe_shift,
                                      t, rpt_shift, rpt_mask, row_len,
                                      stride, bad)
    }
    if (bad) atomicOr(flags, 1);
  }
}

template <typename T, int DV, int KR, bool kMaps, int MB, bool kGuard>
static int launch_fused(const void* x, void* out, const int* in_rows,
                        const int* out_rows, const int* xor_low,
                        const int* src0, const long long* plan, int n_words,
                        int n_tiles, int n_rows, int rpt_shift,
                        int tiles_per_cta, int t, int wpe, int wpe_shift,
                        int row_shift, int pad_words, long long batch,
                        int word_bytes, int d, int* flags, cudaStream_t s) {
  using W = typename ElemWord<T>::type;
  if (word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  const size_t smem =
      REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words) +
      plan_bytes(n_words);
  cudaError_t e =
      allow_smem(tile_fused_kernel<T, DV, KR, kMaps, MB, kGuard>, smem);
  if (e != cudaSuccess) return (int)e;
  tile_fused_kernel<T, DV, KR, kMaps, MB, kGuard>
      <<<grid, REPRO_THREADS, smem, s>>>(
          (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, plan,
          n_words, n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift,
          row_shift, pad_words, batch, d, flags);
  return (int)cudaGetLastError();
}

// elem_type: 0 = int32, 1 = float32, 2 = bfloat16; dv: tail values a
// register slot holds (2: a planar (re, im) cluster with butterflies);
// regs: positions a thread holds (16, or 8: see tile_epilogue.cuh);
// word_bytes: the element type's own width; n_words: int64 words of plan;
// maps: the cluster holds map epilogues (single values, 8 registers);
// flags: null, or (the guarded variant, clusters without maps) one int32
// on the device whose bit 1 is set when a table entry lies out of range.
template <bool kGuard>
static int launch_any(const void* x, void* out, const int* in_rows,
                      const int* out_rows, const int* xor_low,
                      const int* src0, const long long* plan, int n_words,
                      int n_tiles, int n_rows, int rpt_shift,
                      int tiles_per_cta, int t, int wpe, int wpe_shift,
                      int row_shift, int pad_words, long long batch,
                      int word_bytes, int elem_type, int d, int dv, int regs,
                      int maps, int* flags, void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 || d <= 0 ||
      plan == nullptr || n_words < kHdrWords || (regs != 8 && regs != 16) ||
      (dv == 2 && (elem_type != 1 || d != 2)) ||
      (maps && (dv != 1 || regs != 8)) ||
      (kGuard && (flags == nullptr || maps)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FUSED(T, DV, KR, MAPS, MB)                                    \
  return launch_fused<T, DV, KR, MAPS, MB, kGuard>(                         \
      x, out, in_rows, out_rows, xor_low, src0, plan, n_words, n_tiles,     \
      n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift,       \
      pad_words, batch, word_bytes, d, flags, s)
  // the last argument: blocks per SM the variant's registers allow (the
  // fastest choice on the H100 of a sweep over it; see PERF.md, PR 14)
  if (dv == 2) REPRO_FUSED(float, 2, 8, false, 3);
  if (dv != 1) return (int)cudaErrorInvalidValue;
  if constexpr (!kGuard) {
    if (maps) {
      switch (elem_type) {
        case 0: REPRO_FUSED(int, 1, 8, true, 4);
        case 1: REPRO_FUSED(float, 1, 8, true, 4);
        case 2: REPRO_FUSED(Bf16, 1, 8, true, 4);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  const bool r16 = regs == 16;
  switch (elem_type) {
    case 0: if (r16) REPRO_FUSED(int, 1, 16, false, 4);
            REPRO_FUSED(int, 1, 8, false, 4);
    case 1: if (r16) REPRO_FUSED(float, 1, 16, false, 4);
            REPRO_FUSED(float, 1, 8, false, 4);
    case 2: if (r16) REPRO_FUSED(Bf16, 1, 16, false, 2);
            REPRO_FUSED(Bf16, 1, 8, false, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FUSED
}

extern "C" int repro_tile_fused(const void* x, void* out, const int* in_rows,
                                const int* out_rows, const int* xor_low,
                                const int* src0, const long long* plan,
                                int n_words, int n_tiles, int n_rows,
                                int rpt_shift, int tiles_per_cta, int t,
                                int wpe, int wpe_shift, int row_shift,
                                int pad_words, long long batch,
                                int word_bytes, int elem_type, int d, int dv,
                                int regs, int maps, void* stream) {
  return launch_any<false>(x, out, in_rows, out_rows, xor_low, src0, plan,
                           n_words, n_tiles, n_rows, rpt_shift,
                           tiles_per_cta, t, wpe, wpe_shift, row_shift,
                           pad_words, batch, word_bytes, elem_type, d, dv,
                           regs, maps, nullptr, stream);
}

extern "C" int repro_tile_fused_guarded(
    const void* x, void* out, const int* in_rows, const int* out_rows,
    const int* xor_low, const int* src0, const long long* plan, int n_words,
    int n_tiles, int n_rows, int rpt_shift, int tiles_per_cta, int t,
    int wpe, int wpe_shift, int row_shift, int pad_words, long long batch,
    int word_bytes, int elem_type, int d, int dv, int regs, int maps,
    int* flags, void* stream) {
  return launch_any<true>(x, out, in_rows, out_rows, xor_low, src0, plan,
                          n_words, n_tiles, n_rows, rpt_shift, tiles_per_cta,
                          t, wpe, wpe_shift, row_shift, pad_words, batch,
                          word_bytes, elem_type, d, dv, regs, maps, flags,
                          stream);
}
