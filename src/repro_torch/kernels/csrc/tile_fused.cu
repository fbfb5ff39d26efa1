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
//         the tail d (integers of 8, 16, 32 and 64 bits, bool, float32,
//         bfloat16, float16, float64);
//   bfly: (lo, hi) pair values of the planar (re, im) tail (float32,
//         bfloat16, float16 or float64; a half float rounds each product
//         and sum to its type, the twiddles already rounded to it; float64
//         computes in double with float64 twiddles), twiddle
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
// This design: a block takes a run of work items (a
// work item is at most 4096 positions of one batch row, 16 KiB of int32;
// the host's k4b_schedule) and keeps two in flight (tile_items.cuh): it
// stages all its items' row ids, lane XORs and epilogue bases once,
// copies item k + 1's rows into the other tile with 16-byte cp.async
// copies (one commit group) before it runs item k's phases, and gathers
// item k's output rows 16 bytes a thread (src0 entries read four at a
// time). Tile rows are padded by one 16-byte chunk. Between load and
// gather the epilogues run in registers (tile_epilogue.cuh): the host
// plan (epilogue_plan.py) splits them into phases; in each phase a
// thread takes its 16 (or 8) positions of the tile into registers under
// the phase's layout, runs the phase's epilogues there (partner in a
// register or one warp shuffle away, hi from one mask word and a popc,
// floats as integer keys where the warp holds no NaN; integers and keys
// compare in-register pairs once, kPairs), and puts them back
// (addresses as at_padded, no branch a register, kFast); one barrier
// per phase. The 12-compare clusters of a 2^24 sort run in two phases.
// Tails are taken one value at a time (cmp acts on each value of the
// tail alone); a cluster with butterflies holds the planar (re, im) pair
// of each position. A map runs its tape op by op on all of the thread's
// registers at once (beside butterflies, on both planar values). The
// kernel is compiled once per element class (storage width and compare
// class: I64, U64, int, U32, I16, U16, I8, U8 for uint8 and bool, double,
// float, Bf16, F16), register count, planar-or-not and with-or-without
// maps, at the blocks per SM its
// registers allow (a sweep, tools/fused_ab.py, for the int32, float32,
// bfloat16 and 64-bit ones; the 8- and 16-bit classes take the blocks per
// SM of the class they widen like). The 8-byte classes run at 8
// positions a thread only: their work items of 16 KiB hold 2048
// positions (2^11, epilogue_plan.regs_for). A pointer off 16-byte
// alignment, rows of fewer than 16 bytes or a tail of several values a
// register slot does not hold take the same schedule one word of the
// element's width at a time.
//
// Measured (PERF.md; H100 80GB HBM3, 700 W; the largest 2^24 sort
// cluster, device time): 0.0999 ms on int32 keys against 0.1431 for the
// design before (tools/fused_ab.cu), in turns; bound 0.041 ms. What
// still bounds it: instruction issue in the phases (the compares, the
// register moves through the tile, each epilogue's dispatch) at 4 blocks
// an SM, about 2,000 instructions a thread and work item.
//
// The guarded variant (launched by repro_tile_fused_guarded, for clusters
// without maps) runs the same schedule, phases and gathers, instantiated
// with kGuard: stage_items tests every row id and lane XOR as it stages
// them, load_item_rows fills a row not read with zeros, and gather_item
// tests each src0 entry before the tile read it addresses (one compare an
// entry, four an int4 of them). An entry out of range sets bit 1 of
// *flags (one atomicOr per thread that met one) and its access is
// skipped; a tile whose lane XOR is out of range stores zeros and a row
// whose output id is out of range is not written, as the guarded plain
// version (_tile_fused_plain with flags) does. The guarded K4b before
// this design (one work item a block, one word a thread, the plain
// epilogue steps) is the A/B reference k4b_guarded_old in
// tools/fused_ab.cu, beside the unguarded design before the schedule.
// Measured (PERF.md; H100 80GB HBM3, 700 W; the same cluster, device
// time, in turns): 0.1042 ms on int32 keys against 0.1595 for the guarded
// design before and 0.0996 for the unguarded K4b. On 64-bit keys (t = 5,
// bound 0.080 ms): K4b int64 0.1785, uint64 0.1814, float64 0.1993 ms;
// the guarded K4b 0.1870, 0.1917, 0.2115.
#include "tile_common.cuh"
#include "tile_items.cuh"

// The epilogue phases of one batch row on the block's tile, from the
// staged plan sp (device plan gp). kFast (the work-item kernel): the
// register moves and compares of tile_epilogue.cuh's kFast and kPairs.
template <typename T, int DV, int KR, bool kMaps, bool kFast = false>
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
        load_regs<DV, kFast>(v, tv, qb, pr.qr, pr.valid, k);
        phase_epilogues<false, kMaps, kFast>(ph, sp, gp, ebase, v, m, qb, c,
                                             outer_bits, (T*)nullptr);
        store_regs<DV, kFast>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
  }
}

// A block of K4b: `groups` work items (k4b_schedule), `n_buf` of them in
// flight: item k + 1's rows are copied into the other tile while item k's
// phases and gather run. One body for both kernels below, kGuard true in
// the guarded K4b (its tests and its flag word, see above). It is a macro,
// as tile_common.cuh's steps are: the same body as an inlined device
// function compiled the unguarded K4b to other SASS (tools/sass_diff.py).
#define REPRO_K4B_ITEMS(kGuard)                                               \
  using W = typename ElemWord<T>::type;                                       \
  extern __shared__ __align__(16) unsigned char smem[];                       \
  const int rows = a.per_cta << a.rpt_shift;      /* tile rows of an item */  \
  const int rows_shift = a.per_cta_shift + a.rpt_shift;                       \
  const unsigned row_words = (1u << a.t) * (unsigned)a.wpe;                   \
  const unsigned span = (unsigned)rows * row_words;                           \
  const unsigned stride = (unsigned)a.stride;                                 \
  const long long batch_words = (long long)a.n_rows * row_words;              \
  const ItemTables s = carve_items(smem, a, rows);                            \
  const size_t tb = item_tile_bytes(rows, a.stride, (int)sizeof(W));          \
  const long long w0 = (long long)blockIdx.x * a.groups;                      \
  const int nw = (int)min((long long)a.groups, a.n_work - w0);                \
  bool bad = false;                                                           \
  stage_items<kGuard>(s, a, w0, nw, rows, rows_shift, batch_words, &bad);     \
  __syncthreads();                                                            \
                                                                              \
  auto tile_of = [&](int k) {                                                 \
    return reinterpret_cast<W*>(s.tiles + (a.n_buf > 1 && (k & 1) ? tb : 0)); \
  };                                                                          \
  auto load = [&](int k) {                                                    \
    load_item_rows<W, kGuard>(tile_of(k), x + s.base[k],                      \
                              s.in + (k << rows_shift), span, row_words,      \
                              a.row_shift, stride, a.vec);                    \
  };                                                                          \
  load(0);                                                                    \
  if (a.n_buf > 1 && nw > 1) load(1);                                         \
  TileView tv{nullptr, stride * (unsigned)sizeof(W),                          \
              (unsigned)a.wpe * (unsigned)sizeof(W), (1u << a.t) - 1, a.t};   \
  for (int k = 0; k < nw; ++k) {                                              \
    cp_async_wait_n(a.n_buf > 1 && k + 1 < nw ? 1 : 0);   /* item k's rows */ \
    use_item_bases(s, k, a.n_epi);                                            \
    W* tile = tile_of(k);                                                     \
    tv.bytes = reinterpret_cast<unsigned char*>(tile);                        \
    fused_phases<T, DV, KR, kMaps, true>(tv, s.plan, a.plan, a.d);            \
    __syncthreads();                                                          \
    gather_item<W, DV, kGuard>(out + s.base[k], tile,                         \
                               s.out + (k << rows_shift),                     \
                               s.xl + (k << a.per_cta_shift), a.src0, a,      \
                               span, row_words, stride, &bad);                \
    if (k + a.n_buf < nw) {                                                   \
      __syncthreads();   /* every thread is done reading that tile */         \
      load(k + a.n_buf);                                                      \
    }                                                                         \
  }                                                                           \
  if constexpr (kGuard) {                                                     \
    if (bad) atomicOr(flags, 1);                                              \
  }

template <typename T, int DV, int KR, bool kMaps, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_fused_items_kernel(const typename ElemWord<T>::type* __restrict__ x,
                        typename ElemWord<T>::type* __restrict__ out,
                        const EpiTileArgs a) {
  int* flags = nullptr;   // named by the body, never written here
  REPRO_K4B_ITEMS(false)
}

// The guarded K4b: the same body with kGuard, and the flag word as its one
// extra argument (the unguarded kernel keeps its signature and its code).
template <typename T, int DV, int KR, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_fused_items_guarded_kernel(
    const typename ElemWord<T>::type* __restrict__ x,
    typename ElemWord<T>::type* __restrict__ out, const EpiTileArgs a,
    int* __restrict__ flags) {
  constexpr bool kMaps = false;
  REPRO_K4B_ITEMS(true)
}

template <typename T, int DV, int KR, bool kMaps, int MB, bool kGuard = false>
static int launch_items(const void* x, void* out, const EpiTileArgs& a,
                        cudaStream_t s, int* flags = nullptr) {
  using W = typename ElemWord<T>::type;
  if (a.word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  if constexpr (kGuard) {
    static_assert(!kMaps, "the guarded K4b takes no maps");
    cudaError_t e = allow_smem(tile_fused_items_guarded_kernel<T, DV, KR, MB>,
                               (size_t)a.smem);
    if (e != cudaSuccess) return (int)e;
    tile_fused_items_guarded_kernel<T, DV, KR, MB>
        <<<(unsigned)a.grid, REPRO_THREADS, (size_t)a.smem, s>>>(
            (const W*)x, (W*)out, a, flags);
  } else {
    cudaError_t e = allow_smem(tile_fused_items_kernel<T, DV, KR, kMaps, MB>,
                               (size_t)a.smem);
    if (e != cudaSuccess) return (int)e;
    tile_fused_items_kernel<T, DV, KR, kMaps, MB>
        <<<(unsigned)a.grid, REPRO_THREADS, (size_t)a.smem, s>>>(
            (const W*)x, (W*)out, a);
  }
  return (int)cudaGetLastError();
}

// Whether *a describes a launch the kernels take.
static bool valid_args(const EpiTileArgs* a) {
  return a != nullptr && a->grid > 0 && a->n_work > 0 && a->batch > 0 &&
         a->n_rows > 0 && a->t >= 0 && a->rpt_shift >= 0 && a->wpe > 0 &&
         a->per_cta > 0 && a->groups > 0 && a->n_groups > 0 &&
         (a->n_buf == 1 || a->n_buf == 2) && a->d > 0 &&
         a->plan != nullptr && a->n_words >= kHdrWords && a->n_epi >= 0 &&
         (a->regs == 8 || a->regs == 16) &&
         !(a->dv == 2 && (a->d != 2 || !(a->elem_type == 11 ||
                                         (a->elem_type >= 1 &&
                                          a->elem_type <= 3)))) &&
         !(a->maps && a->regs != 8) && !(a->vec && a->wpe != a->dv);
}

// Blocks per SM of the 64-bit classes (K4b and the guarded K4b, 8
// registers): int64, uint64 and float64 single values, and planar float64.
// The fastest of a sweep on the H100 (tools/fused_ab.py --wide; PERF.md;
// device ms on the largest 2^24 sort cluster at 2 / 3 / 4 / 5 blocks an
// SM): int64 0.1894 / 0.1893 / 0.1780 / 0.1789, uint64 0.1929 / 0.1925 /
// 0.1817 / 0.1796, float64 0.2437 / 0.2066 / 0.1991 / 0.2014 (63-64
// registers at 4); the 2^22 FFT's planar float64 cluster at 2 / 3 / 4:
// 0.3201 / 0.2948 / 0.3414 (80 registers and 196 bytes of spills at 3:
// without spills, at 2, fewer blocks cost more).
#define REPRO_MB_64 4
#define REPRO_MB_F64_PLANAR 3

// The entry points (a file that includes this one for its device code,
// tools/fused_ab.cu, leaves them and their instantiations out).
#ifndef REPRO_NO_EPI_ENTRY_POINTS

// The planar (dv 2) element types of 32 bits and less: float32,
// bfloat16, float16 (float64, 11, is launched on its own).
#define REPRO_PLANAR_SWITCH(elem_type, CASE) \
  switch (elem_type) {                       \
    case 1: CASE(float);                     \
    case 2: CASE(Bf16);                      \
    case 3: CASE(F16);                       \
    default: return (int)cudaErrorInvalidValue; \
  }

#ifdef REPRO_MAP_EXT
// An ext library's map kernel of class T with DV values a register slot:
// instantiated in the library of its part (kExtPart, REPRO_MAP_EXT = 1
// to 4), refused in the others.
template <typename T, int DV, int KR, int MB>
static int launch_ext(const void* x, void* out, const EpiTileArgs& a,
                      cudaStream_t s) {
  if constexpr (kExtPart<T, DV> == REPRO_MAP_EXT)
    return launch_items<T, DV, KR, true, MB>(x, out, a, s);
  else
    return (int)cudaErrorInvalidValue;
}
#endif

// One K4b launch under the schedule *a (EpiTileArgs; k4b_schedule in
// bmmc_permute.py): elem_type 0 = int32, 1 = float32, 2 = bfloat16, 3 =
// float16, 4 = int8, 5 = uint8 (and bool), 6 = int16, 7 = uint16, 8 =
// uint32, 9 = int64, 10 = uint64, 11 = float64; dv: tail values a
// register slot holds (2: a planar (re, im) cluster with butterflies,
// float types only); regs: positions a thread holds (16, or 8: see
// tile_epilogue.cuh; the 64-bit types 8 only); maps: the cluster holds
// map epilogues (8 registers).
extern "C" int repro_tile_fused(const void* x, void* out,
                                const EpiTileArgs* a, void* stream) {
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FUSED(T, DV, KR, MAPS, MB) REPRO_FUSED_##MAPS(T, DV, KR, MB)
#define REPRO_FUSED_true(T, DV, KR, MB) \
  return launch_items<T, DV, KR, true, MB>(x, out, *a, s)
#ifdef REPRO_MAP_EXT   // an ext library holds its part's map kernels only
#undef REPRO_FUSED_true
#define REPRO_FUSED_true(T, DV, KR, MB) \
  return launch_ext<T, DV, KR, MB>(x, out, *a, s)
#define REPRO_FUSED_false(T, DV, KR, MB) return (int)cudaErrorInvalidValue
#else
#define REPRO_FUSED_false(T, DV, KR, MB) \
  return launch_items<T, DV, KR, false, MB>(x, out, *a, s)
#endif
  // the last argument: blocks per SM, the fastest of a sweep on the H100
  // (tools/fused_ab.py; PERF.md): bfloat16 at 16 registers runs faster at
  // 3 with a few spills than at 2 without
  if (a->dv == 2) {
    if (a->elem_type == 11) {
      if (a->maps) REPRO_FUSED(double, 2, 8, true, REPRO_MB_F64_PLANAR);
      REPRO_FUSED(double, 2, 8, false, REPRO_MB_F64_PLANAR);
    }
#define REPRO_PLANAR(T)                                    \
  if (a->maps) REPRO_FUSED(T, 2, 8, true, 3);              \
  REPRO_FUSED(T, 2, 8, false, 3)
    REPRO_PLANAR_SWITCH(a->elem_type, REPRO_PLANAR)
#undef REPRO_PLANAR
  }
  if (a->dv != 1) return (int)cudaErrorInvalidValue;
  if (a->elem_type >= 9) {   // 64-bit: 8 registers (see above)
    if (a->regs != 8) return (int)cudaErrorInvalidValue;
    switch (a->elem_type) {
      case 9: if (a->maps) REPRO_FUSED(I64, 1, 8, true, REPRO_MB_64);
              REPRO_FUSED(I64, 1, 8, false, REPRO_MB_64);
      case 10: if (a->maps) REPRO_FUSED(U64, 1, 8, true, REPRO_MB_64);
               REPRO_FUSED(U64, 1, 8, false, REPRO_MB_64);
      case 11: if (a->maps) REPRO_FUSED(double, 1, 8, true, REPRO_MB_64);
               REPRO_FUSED(double, 1, 8, false, REPRO_MB_64);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (a->maps) {
    switch (a->elem_type) {
      case 0: REPRO_FUSED(int, 1, 8, true, 4);
      case 1: REPRO_FUSED(float, 1, 8, true, 4);
      case 2: REPRO_FUSED(Bf16, 1, 8, true, 4);
      case 3: REPRO_FUSED(F16, 1, 8, true, 4);
      case 4: REPRO_FUSED(I8, 1, 8, true, 4);
      case 5: REPRO_FUSED(U8, 1, 8, true, 4);
      case 6: REPRO_FUSED(I16, 1, 8, true, 4);
      case 7: REPRO_FUSED(U16, 1, 8, true, 4);
      case 8: REPRO_FUSED(U32, 1, 8, true, 4);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool r16 = a->regs == 16;
  switch (a->elem_type) {
    case 0: if (r16) REPRO_FUSED(int, 1, 16, false, 4);
            REPRO_FUSED(int, 1, 8, false, 4);
    case 1: if (r16) REPRO_FUSED(float, 1, 16, false, 4);
            REPRO_FUSED(float, 1, 8, false, 4);
    case 2: if (r16) REPRO_FUSED(Bf16, 1, 16, false, 3);
            REPRO_FUSED(Bf16, 1, 8, false, 4);
    case 3: if (r16) REPRO_FUSED(F16, 1, 16, false, 3);
            REPRO_FUSED(F16, 1, 8, false, 4);
    case 4: if (r16) REPRO_FUSED(I8, 1, 16, false, 4);
            REPRO_FUSED(I8, 1, 8, false, 4);
    case 5: if (r16) REPRO_FUSED(U8, 1, 16, false, 4);
            REPRO_FUSED(U8, 1, 8, false, 4);
    case 6: if (r16) REPRO_FUSED(I16, 1, 16, false, 4);
            REPRO_FUSED(I16, 1, 8, false, 4);
    case 7: if (r16) REPRO_FUSED(U16, 1, 16, false, 4);
            REPRO_FUSED(U16, 1, 8, false, 4);
    case 8: if (r16) REPRO_FUSED(U32, 1, 16, false, 4);
            REPRO_FUSED(U32, 1, 8, false, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FUSED
#undef REPRO_FUSED_true
#undef REPRO_FUSED_false
}

#ifndef REPRO_MAP_EXT
// The guarded K4b under the same schedule (clusters without maps): bit 1
// of the int32 *flags on the device is set when a table entry lies out of
// range.
extern "C" int repro_tile_fused_guarded(const void* x, void* out,
                                        const EpiTileArgs* a, int* flags,
                                        void* stream) {
  if (!valid_args(a) || a->maps || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_GUARDED(T, DV, KR, MB) \
  return launch_items<T, DV, KR, false, MB, true>(x, out, *a, s, flags)
  // the last argument: blocks per SM, the fastest of a sweep on the H100
  // (tools/fused_ab.py; PERF.md): bfloat16 at 16 registers runs faster at
  // 4 with spills than at 3
  if (a->dv == 2) {
    if (a->elem_type == 11) REPRO_GUARDED(double, 2, 8, REPRO_MB_F64_PLANAR);
#define REPRO_PLANAR(T) REPRO_GUARDED(T, 2, 8, 3)
    REPRO_PLANAR_SWITCH(a->elem_type, REPRO_PLANAR)
#undef REPRO_PLANAR
  }
  if (a->dv != 1) return (int)cudaErrorInvalidValue;
  if (a->elem_type >= 9) {
    if (a->regs != 8) return (int)cudaErrorInvalidValue;
    switch (a->elem_type) {
      case 9: REPRO_GUARDED(I64, 1, 8, REPRO_MB_64);
      case 10: REPRO_GUARDED(U64, 1, 8, REPRO_MB_64);
      case 11: REPRO_GUARDED(double, 1, 8, REPRO_MB_64);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool r16 = a->regs == 16;
  switch (a->elem_type) {
    case 0: if (r16) REPRO_GUARDED(int, 1, 16, 4);
            REPRO_GUARDED(int, 1, 8, 4);
    case 1: if (r16) REPRO_GUARDED(float, 1, 16, 4);
            REPRO_GUARDED(float, 1, 8, 4);
    case 2: if (r16) REPRO_GUARDED(Bf16, 1, 16, 4);
            REPRO_GUARDED(Bf16, 1, 8, 4);
    case 3: if (r16) REPRO_GUARDED(F16, 1, 16, 4);
            REPRO_GUARDED(F16, 1, 8, 4);
    case 4: if (r16) REPRO_GUARDED(I8, 1, 16, 4);
            REPRO_GUARDED(I8, 1, 8, 4);
    case 5: if (r16) REPRO_GUARDED(U8, 1, 16, 4);
            REPRO_GUARDED(U8, 1, 8, 4);
    case 6: if (r16) REPRO_GUARDED(I16, 1, 16, 4);
            REPRO_GUARDED(I16, 1, 8, 4);
    case 7: if (r16) REPRO_GUARDED(U16, 1, 16, 4);
            REPRO_GUARDED(U16, 1, 8, 4);
    case 8: if (r16) REPRO_GUARDED(U32, 1, 16, 4);
            REPRO_GUARDED(U32, 1, 8, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_GUARDED
}
#endif  // REPRO_MAP_EXT

#endif  // REPRO_NO_EPI_ENTRY_POINTS
