// The A/B reference of the K4b and K5 redesign: the unguarded K4b and K5
// as they were before their work-item schedules (one block a work item of
// at most 4096 positions, loaded in words of the element's width into a
// tile padded by one 4-byte bank, its plan's bases fixed at the block's
// first tile, then gathered or copied out one word a thread; K5 kept a
// second compare-bit set in shared memory), and the guarded K4b as it was
// before it took the work-item schedule (the same design, each row id,
// lane XOR and src0 entry tested by tile_common.cuh's guarded steps, the
// plain epilogue steps). It includes the port's tile_fused.cu and
// tile_bwd.cu for their shared device code (fused_phases, the transposed
// epilogues), so the old kernels run exactly that code.
// tools/fused_kernel_times.py, tools/fused_ab.py and chip_smoke.py
// (phases 6, 9 and 11) time them in turns with the port's.
//
// k4b_old, k4b_guarded_old and k5_old take the arguments the old
// launchers passed (tools/fused_ab.py's _old_args, then the element
// type, tail, registers and maps, the guarded kernel's flag word, or K5's
// compare, spill and map-set counts).
// The port's entry points (and their instantiations of every element
// class) are left out: this library instantiates what it launches.
#define REPRO_NO_EPI_ENTRY_POINTS
#include "tile_fused.cu"
#include "tile_bwd.cu"

// ---------------------------------------------------------------------------
// K4b before its schedule
// ---------------------------------------------------------------------------

template <typename T, int DV, int KR, bool kMaps, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_fused_old_kernel(const typename ElemWord<T>::type* __restrict__ x,
                      typename ElemWord<T>::type* __restrict__ out,
                      const int* __restrict__ in_rows,
                      const int* __restrict__ out_rows,
                      const int* __restrict__ xor_low,
                      const int* __restrict__ src0,
                      const long long* __restrict__ plan, int n_words,
                      int n_rows, int rpt_shift, int tiles_per_cta, int t,
                      int wpe, int wpe_shift, int row_shift, int pad_words,
                      long long batch, int d) {
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
}

template <typename T, int DV, int KR, bool kMaps, int MB>
static int launch_fused_old(const void* x, void* out, const int* in_rows,
                            const int* out_rows, const int* xor_low,
                            const int* src0, const long long* plan,
                            int n_words, int n_tiles, int n_rows,
                            int rpt_shift, int tiles_per_cta, int t, int wpe,
                            int wpe_shift, int row_shift, int pad_words,
                            long long batch, int word_bytes, int d,
                            cudaStream_t s) {
  using W = typename ElemWord<T>::type;
  if (word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  const size_t smem =
      REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words) +
      plan_bytes(n_words);
  cudaError_t e =
      allow_smem(tile_fused_old_kernel<T, DV, KR, kMaps, MB>, smem);
  if (e != cudaSuccess) return (int)e;
  tile_fused_old_kernel<T, DV, KR, kMaps, MB>
      <<<grid, REPRO_THREADS, smem, s>>>(
          (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, plan,
          n_words, n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift,
          row_shift, pad_words, batch, d);
  return (int)cudaGetLastError();
}

extern "C" int k4b_old(const void* x, void* out, const int* in_rows,
                       const int* out_rows, const int* xor_low,
                       const int* src0, const long long* plan, int n_words,
                       int n_tiles, int n_rows, int rpt_shift,
                       int tiles_per_cta, int t, int wpe, int wpe_shift,
                       int row_shift, int pad_words, long long batch,
                       int word_bytes, int elem_type, int d, int dv,
                       int regs, int maps, void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 || d <= 0 ||
      plan == nullptr || n_words < kHdrWords || (regs != 8 && regs != 16) ||
      (dv == 2 && (elem_type != 1 || d != 2)) ||
      (maps && (dv != 1 || regs != 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FUSED_OLD(T, DV, KR, MAPS, MB)                                \
  return launch_fused_old<T, DV, KR, MAPS, MB>(                             \
      x, out, in_rows, out_rows, xor_low, src0, plan, n_words, n_tiles,     \
      n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift,       \
      pad_words, batch, word_bytes, d, s)
  if (dv == 2) REPRO_FUSED_OLD(float, 2, 8, false, 3);
  if (dv != 1) return (int)cudaErrorInvalidValue;
  if (maps) {
    switch (elem_type) {
      case 0: REPRO_FUSED_OLD(int, 1, 8, true, 4);
      case 1: REPRO_FUSED_OLD(float, 1, 8, true, 4);
      case 2: REPRO_FUSED_OLD(Bf16, 1, 8, true, 4);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool r16 = regs == 16;
  switch (elem_type) {
    case 0: if (r16) REPRO_FUSED_OLD(int, 1, 16, false, 4);
            REPRO_FUSED_OLD(int, 1, 8, false, 4);
    case 1: if (r16) REPRO_FUSED_OLD(float, 1, 16, false, 4);
            REPRO_FUSED_OLD(float, 1, 8, false, 4);
    case 2: if (r16) REPRO_FUSED_OLD(Bf16, 1, 16, false, 2);
            REPRO_FUSED_OLD(Bf16, 1, 8, false, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FUSED_OLD
}

// ---------------------------------------------------------------------------
// The guarded K4b before the work-item schedule
// ---------------------------------------------------------------------------

template <typename T, int DV, int KR, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_fused_guarded_old_kernel(
    const typename ElemWord<T>::type* __restrict__ x,
    typename ElemWord<T>::type* __restrict__ out,
    const int* __restrict__ in_rows, const int* __restrict__ out_rows,
    const int* __restrict__ xor_low, const int* __restrict__ src0,
    const long long* __restrict__ plan, int n_words, int n_rows,
    int rpt_shift, int tiles_per_cta, int t, int wpe, int wpe_shift,
    int row_shift, int pad_words, long long batch, int d,
    int* __restrict__ flags) {
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
    fused_phases<T, DV, KR, false>(tv, s_plan, plan, d);
    __syncthreads();
    REPRO_TILE_GATHER_STORE_GUARDED(W, ob, tile, s_out, s_xl, src0, span,
                                    row_words, row_shift, wpe, wpe_shift,
                                    t, rpt_shift, rpt_mask, row_len,
                                    stride, bad)
  }
  if (bad) atomicOr(flags, 1);
}

template <typename T, int DV, int KR, int MB>
static int launch_fused_guarded_old(
    const void* x, void* out, const int* in_rows, const int* out_rows,
    const int* xor_low, const int* src0, const long long* plan, int n_words,
    int n_tiles, int n_rows, int rpt_shift, int tiles_per_cta, int t,
    int wpe, int wpe_shift, int row_shift, int pad_words, long long batch,
    int word_bytes, int d, int* flags, cudaStream_t s) {
  using W = typename ElemWord<T>::type;
  if (word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  const size_t smem =
      REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words) +
      plan_bytes(n_words);
  cudaError_t e =
      allow_smem(tile_fused_guarded_old_kernel<T, DV, KR, MB>, smem);
  if (e != cudaSuccess) return (int)e;
  tile_fused_guarded_old_kernel<T, DV, KR, MB>
      <<<grid, REPRO_THREADS, smem, s>>>(
          (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, plan,
          n_words, n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift,
          row_shift, pad_words, batch, d, flags);
  return (int)cudaGetLastError();
}

extern "C" int k4b_guarded_old(
    const void* x, void* out, const int* in_rows, const int* out_rows,
    const int* xor_low, const int* src0, const long long* plan, int n_words,
    int n_tiles, int n_rows, int rpt_shift, int tiles_per_cta, int t,
    int wpe, int wpe_shift, int row_shift, int pad_words, long long batch,
    int word_bytes, int elem_type, int d, int dv, int regs, int maps,
    int* flags, void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 || d <= 0 ||
      plan == nullptr || n_words < kHdrWords || (regs != 8 && regs != 16) ||
      (dv == 2 && (elem_type != 1 || d != 2)) || maps || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_GUARDED_OLD(T, DV, KR, MB)                                    \
  return launch_fused_guarded_old<T, DV, KR, MB>(                           \
      x, out, in_rows, out_rows, xor_low, src0, plan, n_words, n_tiles,     \
      n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift,       \
      pad_words, batch, word_bytes, d, flags, s)
  if (dv == 2) REPRO_GUARDED_OLD(float, 2, 8, 3);
  if (dv != 1) return (int)cudaErrorInvalidValue;
  const bool r16 = regs == 16;
  switch (elem_type) {
    case 0: if (r16) REPRO_GUARDED_OLD(int, 1, 16, 4);
            REPRO_GUARDED_OLD(int, 1, 8, 4);
    case 1: if (r16) REPRO_GUARDED_OLD(float, 1, 16, 4);
            REPRO_GUARDED_OLD(float, 1, 8, 4);
    case 2: if (r16) REPRO_GUARDED_OLD(Bf16, 1, 16, 2);
            REPRO_GUARDED_OLD(Bf16, 1, 8, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_GUARDED_OLD
}

// ---------------------------------------------------------------------------
// K5 before its schedule
// ---------------------------------------------------------------------------

// Make the compare-bit words of set `sid` (group * chunks + chunk) the
// ones in registers: the words in use wait in shared memory (`spill`, one
// word per set, tail value, register and thread), and a set's first phase
// starts from zeros.
template <int DV, int KR>
__device__ __forceinline__ void use_masks_old(unsigned (&m)[DV][KR], int& cur,
                                              int sid, bool fresh,
                                              unsigned* spill) {
  if (sid == cur) return;
  if (cur >= 0 && spill != nullptr) {
#pragma unroll
    for (int c = 0; c < DV; ++c)
#pragma unroll
      for (int i = 0; i < KR; ++i)
        spill[(((size_t)cur * DV + c) * KR + i) * REPRO_THREADS +
              threadIdx.x] = m[c][i];
  }
#pragma unroll
  for (int c = 0; c < DV; ++c)
#pragma unroll
    for (int i = 0; i < KR; ++i)
      m[c][i] = fresh ? 0u
                      : spill[(((size_t)sid * DV + c) * KR + i) *
                                  REPRO_THREADS + threadIdx.x];
  cur = sid;
}

// Bytes of one tile buffer (rows padded as K4a pads them), 16-aligned.
__host__ __device__ __forceinline__ size_t tile_buf_bytes_old(
    int rows, int t, int wpe, int pad_words, int word_bytes) {
  return ((size_t)rows * ((size_t)(1 << t) * wpe + pad_words) * word_bytes +
          15) & ~(size_t)15;
}

// The replay and the transposed sweep of one batch row on the block's
// tiles (x in tv, ct as loaded in cv; the result left in tv), from the
// staged plan sp (device plan gp). kCmp: the cluster has compares (their
// bits in m); kMaps: it has maps, `save` the room for their inputs.
template <typename T, int DV, int KR, bool kCmp, bool kMaps>
__device__ __forceinline__ void bwd_phases_old(const TileView& tv,
                                               const TileView& cv, const int* sp,
                                               const long long* gp, int d,
                                               const int* __restrict__ inv_src0,
                                               const int* s_xl, int rpt_shift,
                                               unsigned* spill, T* save) {
  const int n_phases = sp[0], outer_bits = sp[2];
  const unsigned chunks = 1u << outer_bits;
  const int* phases = sp + kHdrWords;
  const int ebase = kHdrWords + n_phases * kPhaseWords;
  T v[DV][KR];
  unsigned m[DV][KR];
  for (int k = 0; k < d; k += DV) {
    int cur = -1;
    // replay, keeping the compare bits
    for (int p = 0; p < n_phases; ++p) {
      __syncthreads();  // the tiles (or the previous phase) complete
      const int* ph = phases + p * kPhaseWords;
      const PhaseRegs pr(ph);
      const int group = ph[PH_GROUP];
      const bool first = ph[PH_FIRST] != 0;
      for (unsigned c = 0; c < chunks; ++c) {
        const unsigned qb = pr.qt ^ image_of(ph + PH_IMG_OUT, c, outer_bits);
        if (kCmp && group >= 0)
          use_masks_old<DV>(m, cur, group * (int)chunks + (int)c, first,
                            spill);
        load_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
        phase_epilogues<kCmp, kMaps>(ph, sp, gp, ebase, v, m, qb, c,
                                     outer_bits, save);
        if (p + 1 < n_phases) store_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
    // the transposed epilogues, last phase first; the last phase's
    // positions are the replay's own, so it needs no barrier and reads
    // the cotangent through the un-gather
    for (int p = n_phases - 1; p >= 0; --p) {
      if (p + 1 < n_phases) __syncthreads();
      const int* ph = phases + p * kPhaseWords;
      const PhaseRegs pr(ph);
      const int e0 = ph[PH_E0], e1 = ph[PH_E1], group = ph[PH_GROUP];
      for (unsigned c = 0; c < chunks; ++c) {
        const unsigned qb = pr.qt ^ image_of(ph + PH_IMG_OUT, c, outer_bits);
        if (kCmp && group >= 0)
          use_masks_old<DV>(m, cur, group * (int)chunks + (int)c, false,
                            spill);
        if (p + 1 == n_phases)
          load_ungathered<DV>(v, cv, qb, pr.qr, pr.valid, k, inv_src0, s_xl,
                              rpt_shift);
        else
          load_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
        for (int e = e1 - 1; e >= e0; --e)
          transposed_epilogue<kCmp, kMaps>(sp, gp, ebase, e, v, m, qb, c,
                                           outer_bits, save);
        store_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
  }
}

template <typename T, int DV, int KR, bool kCmp, bool kMaps, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_bwd_old_kernel(const typename ElemWord<T>::type* __restrict__ x,
                    const typename ElemWord<T>::type* __restrict__ ct,
                    typename ElemWord<T>::type* __restrict__ out,
                    const int* __restrict__ in_rows,
                    const int* __restrict__ out_rows,
                    const int* __restrict__ xor_low,
                    const int* __restrict__ inv_src0,
                    const long long* __restrict__ plan, int n_words, int n_rows,
                    int rpt_shift, int tiles_per_cta, int t, int wpe,
                    int wpe_shift, int row_shift, int pad_words,
                    long long batch, int d, int n_spill) {
  using W = typename ElemWord<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  int* s_plan = reinterpret_cast<int*>(smem + tab_bytes);
  const size_t buf = tile_buf_bytes_old(rows, t, wpe, pad_words, sizeof(W));
  unsigned char* a_bytes = smem + tab_bytes + plan_bytes(n_words);
  W* tile = reinterpret_cast<W*>(a_bytes);             // x, then ct_pre
  W* ctile = reinterpret_cast<W*>(a_bytes + buf);      // ct as loaded
  unsigned* spill =
      n_spill ? reinterpret_cast<unsigned*>(a_bytes + 2 * buf) : nullptr;
  T* save = nullptr;
  if constexpr (kMaps)
    save = reinterpret_cast<T*>(a_bytes + 2 * buf +
                                (size_t)n_spill * DV * KR * REPRO_THREADS * 4);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  const TileView tv{a_bytes, stride * (unsigned)sizeof(W),
                    (unsigned)wpe * (unsigned)sizeof(W), (1u << t) - 1, t};
  const TileView cv{a_bytes + buf, tv.stride_bytes, tv.elem_bytes,
                    tv.lane_mask, t};
  REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low, g0,
                         rpt_shift, rows, tiles_per_cta)
  stage_plan(s_plan, plan, n_words, g0);
  const unsigned span = (unsigned)rows * row_words;
  const long long batch_words = (long long)n_rows * row_words;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const W* xb = x + b * batch_words;
    const W* cb = ct + b * batch_words;
    W* ob = out + b * batch_words;
    __syncthreads();  // tables ready; the previous batch row's reads done
    {
      REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift,
                           stride)
    }
    {
      REPRO_TILE_LOAD_ROWS(W, ctile, cb, s_out, span, row_words, row_shift,
                           stride)
    }
    bwd_phases_old<T, DV, KR, kCmp, kMaps>(tv, cv, s_plan, plan, d, inv_src0,
                                       s_xl, rpt_shift, spill, save);
    __syncthreads();
    // whole rows back where the forward read them
#pragma unroll 4
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned r = div_by(li, row_words, row_shift);
      const unsigned rem = li - r * row_words;
      ob[(long long)s_in[r] * row_words + rem] = tile[r * stride + rem];
    }
  }
}

template <typename T, int DV, int KR, bool kCmp, bool kMaps, int MB>
static int launch_bwd_old(const void* x, const void* ct, void* out,
                          const int* in_rows, const int* out_rows,
                          const int* xor_low, const int* inv_src0,
                          const long long* plan, int n_words, int n_tiles,
                          int n_rows, int rpt_shift, int tiles_per_cta, int t,
                          int wpe, int wpe_shift, int row_shift, int pad_words,
                          long long batch, int word_bytes, int d, int n_spill,
                          int n_map_sets, cudaStream_t s) {
  using W = typename ElemWord<T>::type;
  if (word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  const size_t smem =
      (size_t)REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta) +
      plan_bytes(n_words) +
      2 * tile_buf_bytes_old(rows, t, wpe, pad_words, (int)sizeof(W)) +
      (size_t)n_spill * DV * KR * REPRO_THREADS * 4 +
      (size_t)n_map_sets * KR * REPRO_THREADS * sizeof(T);
  cudaError_t e =
      allow_smem(tile_bwd_old_kernel<T, DV, KR, kCmp, kMaps, MB>, smem);
  if (e != cudaSuccess) return (int)e;
  tile_bwd_old_kernel<T, DV, KR, kCmp, kMaps, MB>
      <<<grid, REPRO_THREADS, smem, s>>>(
      (const W*)x, (const W*)ct, (W*)out, in_rows, out_rows, xor_low,
      inv_src0, plan, n_words, n_rows, rpt_shift, tiles_per_cta, t, wpe,
      wpe_shift, row_shift, pad_words, batch, d, n_spill);
  return (int)cudaGetLastError();
}

extern "C" int k5_old(const void* x, void* out, const void* ct,
                              const int* in_rows, const int* out_rows,
                              const int* xor_low, const int* inv_src0,
                              const long long* plan, int n_words,
                              int n_tiles, int n_rows,
                              int rpt_shift, int tiles_per_cta, int t,
                              int wpe, int wpe_shift, int row_shift,
                              int pad_words, long long batch, int word_bytes,
                              int elem_type, int d, int dv, int has_cmp,
                              int n_spill, int n_map_sets, void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 || d <= 0 ||
      n_spill < 0 || n_map_sets < 0 || plan == nullptr ||
      n_words < kHdrWords || (dv == 2 && (elem_type != 1 || d != 2)) ||
      (dv == 2 && n_map_sets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(T, DV, CMP, MAPS, MB)                                      \
  return launch_bwd_old<T, DV, 8, CMP, MAPS, MB>(                            \
      x, ct, out, in_rows, out_rows, xor_low, inv_src0, plan, n_words,       \
      n_tiles, n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift,          \
      row_shift, pad_words, batch, word_bytes, d, n_spill, n_map_sets, s)
  // the last argument: blocks per SM the variant's registers allow (the
  // fastest choice on the H100 of a sweep over it; see PERF.md)
  if (dv == 2 && has_cmp) REPRO_BWD(float, 2, true, false, 2);
  if (dv == 2) REPRO_BWD(float, 2, false, false, 3);
  if (dv != 1) return (int)cudaErrorInvalidValue;
  if (n_map_sets) {   // 2 blocks an SM: the map code spills at 3 (80 regs)
    if (elem_type == 1) REPRO_BWD(float, 1, true, true, 2);
    if (elem_type == 2) REPRO_BWD(Bf16, 1, true, true, 2);
    return (int)cudaErrorInvalidValue;
  }
  if (elem_type == 1) REPRO_BWD(float, 1, true, false, 3);
  if (elem_type == 2) REPRO_BWD(Bf16, 1, true, false, 2);
  return (int)cudaErrorInvalidValue;
#undef REPRO_BWD
}

// ---------------------------------------------------------------------------
// The port's K4b and K5 at other blocks per SM (the sweep of
// tools/fused_ab.py; the port keeps the value PERF.md records)
// ---------------------------------------------------------------------------

extern "C" int k4b_mb(const void* x, void* out, const EpiTileArgs* a,
                      int mb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->dv != 1 || a->maps || a->regs != 16)
    return (int)cudaErrorInvalidValue;
#define REPRO_MB(T)                                                   \
  switch (mb) {                                                       \
    case 3: return launch_items<T, 1, 16, false, 3>(x, out, *a, s);   \
    case 5: return launch_items<T, 1, 16, false, 5>(x, out, *a, s);   \
    default: return (int)cudaErrorInvalidValue;                       \
  }
  if (a->elem_type == 0) REPRO_MB(int)
  if (a->elem_type == 1) REPRO_MB(float)
  if (a->elem_type == 2 && mb == 3)
    return launch_items<Bf16, 1, 16, false, 3>(x, out, *a, s);
#undef REPRO_MB
  return (int)cudaErrorInvalidValue;
}

// The port's guarded K4b at other blocks per SM (16 registers, no maps)
extern "C" int k4b_guarded_mb(const void* x, void* out, const EpiTileArgs* a,
                              int* flags, int mb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->dv != 1 || a->maps || a->regs != 16 || flags == nullptr)
    return (int)cudaErrorInvalidValue;
#define REPRO_GMB(T)                                                       \
  switch (mb) {                                                            \
    case 2: return launch_items<T, 1, 16, false, 2, true>(x, out, *a, s,   \
                                                          flags);          \
    case 3: return launch_items<T, 1, 16, false, 3, true>(x, out, *a, s,   \
                                                          flags);          \
    case 4: return launch_items<T, 1, 16, false, 4, true>(x, out, *a, s,   \
                                                          flags);          \
    default: return (int)cudaErrorInvalidValue;                            \
  }
  if (a->elem_type == 0) REPRO_GMB(int)
  if (a->elem_type == 1) REPRO_GMB(float)
  if (a->elem_type == 2) REPRO_GMB(Bf16)
#undef REPRO_GMB
  return (int)cudaErrorInvalidValue;
}

extern "C" int k5_mb(const void* x, void* out, const void* ct,
                     const EpiTileArgs* a, int mb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->dv != 1 || a->n_map_sets) return (int)cudaErrorInvalidValue;
  if (a->elem_type == 2 && mb == 2)
    return launch_bwd<Bf16, 1, 8, true, false, 2>(x, ct, out, *a, s);
  if (a->elem_type != 1) return (int)cudaErrorInvalidValue;
  switch (mb) {
    case 2: return launch_bwd<float, 1, 8, true, false, 2>(x, ct, out, *a, s);
    case 3: return launch_bwd<float, 1, 8, true, false, 3>(x, ct, out, *a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5 at 16 positions a thread (a plan of 4 register bits: the 2^12
// positions of the sort's largest cluster in one chunk), an experiment of
// tools/fused_ab.py
extern "C" int k5_kr16(const void* x, void* out, const void* ct,
                       const EpiTileArgs* a, int mb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->dv != 1 || a->n_map_sets || a->elem_type != 1)
    return (int)cudaErrorInvalidValue;
  switch (mb) {
    case 2:
      return launch_bwd<float, 1, 16, true, false, 2>(x, ct, out, *a, s);
    case 3:
      return launch_bwd<float, 1, 16, true, false, 3>(x, ct, out, *a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The 64-bit classes (8 registers, no maps) at other blocks per SM: K4b on
// int64, uint64 and float64 single values and on planar float64, K5 on
// float64 compares and planar float64 butterflies (tools/fused_ab.py
// --wide, which defines REPRO_WIDE_SWEEP; the port keeps the values
// PERF.md records). Left out otherwise, so that chip_smoke.py's build of
// this file does not compile them.
#ifdef REPRO_WIDE_SWEEP
extern "C" int k4b_wide_mb(const void* x, void* out, const EpiTileArgs* a,
                           int mb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->maps || a->regs != 8) return (int)cudaErrorInvalidValue;
#define REPRO_WMB(T, DV)                                                   \
  switch (mb) {                                                            \
    case 2: return launch_items<T, DV, 8, false, 2>(x, out, *a, s);        \
    case 3: return launch_items<T, DV, 8, false, 3>(x, out, *a, s);        \
    case 4: return launch_items<T, DV, 8, false, 4>(x, out, *a, s);        \
    case 5: return launch_items<T, DV, 8, false, 5>(x, out, *a, s);        \
    default: return (int)cudaErrorInvalidValue;                            \
  }
  if (a->dv == 2 && a->elem_type == 11) REPRO_WMB(double, 2)
  if (a->dv == 1 && a->elem_type == 9) REPRO_WMB(I64, 1)
  if (a->dv == 1 && a->elem_type == 10) REPRO_WMB(U64, 1)
  if (a->dv == 1 && a->elem_type == 11) REPRO_WMB(double, 1)
#undef REPRO_WMB
  return (int)cudaErrorInvalidValue;
}

extern "C" int k5_wide_mb(const void* x, void* out, const void* ct,
                          const EpiTileArgs* a, int mb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->n_map_sets || a->elem_type != 11) return (int)cudaErrorInvalidValue;
  if (a->dv == 2 && !a->has_cmp) {
    switch (mb) {
      case 1: return launch_bwd<double, 2, 8, false, false, 1>(x, ct, out,
                                                               *a, s);
      case 2: return launch_bwd<double, 2, 8, false, false, 2>(x, ct, out,
                                                               *a, s);
      case 3: return launch_bwd<double, 2, 8, false, false, 3>(x, ct, out,
                                                               *a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (a->dv != 1) return (int)cudaErrorInvalidValue;
  switch (mb) {
    case 2: return launch_bwd<double, 1, 8, true, false, 2>(x, ct, out, *a,
                                                            s);
    case 3: return launch_bwd<double, 1, 8, true, false, 3>(x, ct, out, *a,
                                                            s);
    case 4: return launch_bwd<double, 1, 8, true, false, 4>(x, ct, out, *a,
                                                            s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // REPRO_WIDE_SWEEP
