// K5: the gradient kernel, the exact transpose of one fused tiled pass
// (DESIGN.md §13): the backward of a compute-bearing cluster in one pass.
//
// Replaces: src/repro/kernels/bmmc_permute.py, _tile_bwd_kernel (launched
// by tiled_permute_bwd_tables). The forward pass (K4b) read tile g at
// in_rows[g], ran epilogues C1..Cm on it and gathered
//     out.flat[j] = pre.flat[src0.flat[j ^ xor_low[g]]]
// into out_rows[g]. Its transpose, for the saved input x and the output
// cotangent ct:
//   1. loads x rows at in_rows[g] and ct rows at out_rows[g];
//   2. replays C1..Cm on the x values (K4b's own code, tile_epilogue.cuh),
//      keeping of each compare only two bits per element: u == o and
//      partner(u) == o, for its input u and output o;
//   3. un-gathers the cotangent, ct_pre.flat[k] = ct.flat[inv_src0.flat[k]
//      ^ xor_low[g]] (the XOR applies to the looked-up index);
//   4. applies the transposed epilogues Cm'..C1' on it, in reverse:
//        cmp:  ct <- ct * m1 + P(ct * m2), with jax's balanced tie masks
//              m1 = 1{u==o} / (1 + 1{P(u)==o}), m2 the same with the roles
//              of u and P(u) swapped (values 0, 1/2, 1, applied as
//              products so 0 * inf stays NaN), P the partner flip;
//        bfly: with q = P(ct), s = q - ct and the position's twiddle w:
//              hi ? (wr*s_re + wi*s_im, wr*s_im - wi*s_re) : ct + q;
//   5. writes the result where the forward read: rows in_rows[g].
// float32 and bfloat16 (cmp) and planar float32 (bfly); bfloat16 computes
// each product and sum in float and rounds it to nearest even once, as
// PyTorch does; float32 rounds each on its own (__fmul_rn/__fadd_rn: no
// contraction into FMAs), so the kernel is bit-equal to its plain version
// tiled_permute_bwd_tables_plain.
//
// Bound on the H100: bytes. x and ct are read once and the result written
// once, 3 * size bytes over 3.35 TB/s, plus the tables. The first design
// ran at 7 % of it (device time): besides K4b's table reads and
// per-epilogue barriers it kept the compare bits in shared memory (a
// zeroing pass, two read-modify-writes per pair per compare, two reads
// per transposed compare) and needed about 62 KiB per block.
//
// This design: the epilogues run in registers under the host plan's
// phases (tile_epilogue.cuh), 8 positions a thread. The compare bits stay
// in registers: each element's two bits of compare j sit at bits 2j,
// 2j + 1 of one register word of the thread that computed them, and the
// transposed sweep runs the phases in reverse, so the same thread holds
// the same positions under the same layout when it reads them back. The
// replay compares floats as integer keys where a warp holds no NaN (the
// compare bits from key equality, -0 and +0 equal). Past 16 compares (a
// phase never spans a group of 16) or with chunks, the words of the
// groups and chunks not in use wait in shared memory, one word per thread
// and register. The last replay phase keeps its values and the first
// transposed phase reads the cotangent straight from the loaded ct tile
// through the un-gather, so the replay's last store, the un-gather pass
// and a barrier go away. Shared memory per block: the row tables, the
// staged plan, the two tiles and, with chunks or more than 16 compares,
// the waiting compare bits. What still bounds it: instruction issue (the
// replay, the transposed compares' masks and products) and the latency of
// four phase passes per block (PERF.md).
#include "tile_common.cuh"
#include "tile_epilogue.cuh"

__device__ __forceinline__ Bf16 round_bf16(float f) {
  // round to nearest even, as PyTorch rounds float to bfloat16 on the
  // card (__float2bfloat16: a NaN becomes 0x7FFF)
  return Bf16{__bfloat16_as_ushort(__float2bfloat16(f))};
}

// a * m and a + b, each rounded to T on its own
__device__ __forceinline__ float prod(float a, float m) {
  return __fmul_rn(a, m);
}
__device__ __forceinline__ Bf16 prod(Bf16 a, float m) {
  return round_bf16(__fmul_rn(as_float(a), m));
}
__device__ __forceinline__ float sum(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ Bf16 sum(Bf16 a, Bf16 b) {
  return round_bf16(__fadd_rn(as_float(a), as_float(b)));
}

// The compare bits b of one element (bit 0: u == o, bit 1: P(u) == o) as
// the tie masks m1 (mask_self) and m2 (mask_cross), each 0, 1/2 or 1: two
// byte permutes of 4-entry tables of the float's upper bytes, with one
// selector per b (byte 3 from the first word, byte 2 from the second).
__device__ __forceinline__ unsigned mask_selector(unsigned b) {
  return b * 0x1100u + 0x0400u;
}
__device__ __forceinline__ float mask_self(unsigned sel) {    // m1: 0 1 0 1/2
  return __uint_as_float(__byte_perm(0x3F003F00u, 0x00008000u, sel));
}
__device__ __forceinline__ float mask_cross(unsigned sel) {   // m2: 0 0 1 1/2
  return __uint_as_float(__byte_perm(0x3F3F0000u, 0x00800000u, sel));
}

// Transposed compare on registers: ct * m1 + P(ct * m2), the partner's
// product taken where the partner is (its register, or a shuffle away).
template <int VR, int DV, int KR, typename T>
__device__ __forceinline__ void tr_cmp_regs(T (&v)[DV][KR],
                                            const unsigned (&m)[DV][KR],
                                            int vlane, int shift) {
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    T s[KR], p[KR];
#pragma unroll
    for (int j = 0; j < KR; ++j)
      s[j] = prod(v[c][j], mask_cross(mask_selector((m[c][j] >> shift) & 3u)));
    partners<VR>(s, vlane, p);
#pragma unroll
    for (int i = 0; i < KR; ++i)
      v[c][i] = sum(prod(v[c][i], mask_self(mask_selector((m[c][i] >> shift) & 3u))),
                    p[i]);
  }
}

// Transposed butterfly on registers (planar float32).
template <int VR, int KR>
__device__ __forceinline__ void tr_bfly_regs(float (&v)[2][KR],
                                             unsigned hx, int vlane,
                                             const float2* w,
                                             const unsigned (&tw)[KR]) {
  float pr[KR], pi[KR];
  partners<VR>(v[0], vlane, pr);
  partners<VR>(v[1], vlane, pi);
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    if ((hx >> i) & 1u) {                  // the pair's "hi" member
      const float2 wv = __ldg(w + tw[i]);
      const float s_re = __fsub_rn(pr[i], v[0][i]);
      const float s_im = __fsub_rn(pi[i], v[1][i]);
      v[0][i] = __fadd_rn(__fmul_rn(wv.x, s_re), __fmul_rn(wv.y, s_im));
      v[1][i] = __fsub_rn(__fmul_rn(wv.x, s_im), __fmul_rn(wv.y, s_re));
    } else {
      v[0][i] = __fadd_rn(v[0][i], pr[i]);
      v[1][i] = __fadd_rn(v[1][i], pi[i]);
    }
  }
}

// The transpose of epilogue e (staged record ep, device record gep) on the
// cotangent registers (see step 4).
template <bool kCmp, int DV, int KR, typename T>
__device__ __forceinline__ void transposed_epilogue(
    const int* ep, const long long* gep, T (&v)[DV][KR],
    const unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits) {
  const int vreg = ep[EP_VREG], vlane = ep[EP_VLANE];
  if (ep[EP_KIND] == 0) {
    if constexpr (kCmp) {
      const int shift = ep[EP_SHIFT];
      REPRO_VREG_SWITCH(vreg, (tr_cmp_regs<VR>(v, m, vlane, shift)))
    }
  } else {
    if constexpr (DV == 2) {
      const float2* w = reinterpret_cast<const float2*>(__ldg(gep + EP_W));
      unsigned tw[KR];
      tw_index(ep, tw_thread(ep, chunk, outer_bits), tw);
      REPRO_VREG_SWITCH(vreg, (tr_bfly_regs<VR>(v, hi_bits(ep, qb), vlane, w,
                                                tw)))
    }
  }
}

// Make the compare-bit words of set `sid` (group * chunks + chunk) the
// ones in registers: the words in use wait in shared memory (`spill`, one
// word per set, tail value, register and thread), and a set's first phase
// starts from zeros.
template <int DV, int KR>
__device__ __forceinline__ void use_masks(unsigned (&m)[DV][KR], int& cur,
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

// The cotangent values at the thread's positions, read through the
// un-gather from the ct tile as loaded (step 3).
template <int DV, int KR, typename T>
__device__ __forceinline__ void load_ungathered(
    T (&v)[DV][KR], const TileView& cv, unsigned qb,
    const RegImages& qr, unsigned valid, int k,
    const int* __restrict__ inv_src0, const int* s_xl, int rpt_shift) {
  const int t = cv.t;
  const unsigned lane_mask = cv.lane_mask;
  const unsigned rpt_mask = (1u << rpt_shift) - 1;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    if ((valid >> i) & 1u) {
      const unsigned q = qb ^ qr(i);
      const unsigned r = q >> t, j = r >> rpt_shift;
      const unsigned s = (unsigned)__ldg(inv_src0 + (((r & rpt_mask) << t) |
                                                     (q & lane_mask))) ^
                         (unsigned)s_xl[j];
      const unsigned src = (((j << rpt_shift) | (s >> t)) << t) |
                           (s & lane_mask);
#pragma unroll
      for (int c = 0; c < DV; ++c) v[c][i] = *cv.at<T>(src, k + c);
    } else {
#pragma unroll
      for (int c = 0; c < DV; ++c) v[c][i] = T{};
    }
  }
}

// Bytes of one tile buffer (rows padded as K4a pads them), 16-aligned.
__host__ __device__ __forceinline__ size_t tile_buf_bytes(int rows, int t,
                                                          int wpe,
                                                          int pad_words,
                                                          int word_bytes) {
  return ((size_t)rows * ((size_t)(1 << t) * wpe + pad_words) * word_bytes +
          15) & ~(size_t)15;
}

// The replay and the transposed sweep of one batch row on the block's
// tiles (x in tv, ct as loaded in cv; the result left in tv), from the
// staged plan sp (device plan gp). kCmp: the cluster has compares (their
// bits in m).
template <typename T, int DV, int KR, bool kCmp>
__device__ __forceinline__ void bwd_phases(const TileView& tv,
                                           const TileView& cv, const int* sp,
                                           const long long* gp, int d,
                                           const int* __restrict__ inv_src0,
                                           const int* s_xl, int rpt_shift,
                                           unsigned* spill) {
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
      const int e0 = ph[PH_E0], e1 = ph[PH_E1], group = ph[PH_GROUP];
      const bool first = ph[PH_FIRST] != 0;
      for (unsigned c = 0; c < chunks; ++c) {
        const unsigned qb = pr.qt ^ image_of(ph + PH_IMG_OUT, c, outer_bits);
        if (kCmp && group >= 0)
          use_masks<DV>(m, cur, group * (int)chunks + (int)c, first, spill);
        load_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
        forward_epilogues<kCmp>(sp, gp, ebase, e0, e1, v, m, qb, c,
                                outer_bits);
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
          use_masks<DV>(m, cur, group * (int)chunks + (int)c, false, spill);
        if (p + 1 == n_phases)
          load_ungathered<DV>(v, cv, qb, pr.qr, pr.valid, k, inv_src0, s_xl,
                              rpt_shift);
        else
          load_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
        for (int e = e1 - 1; e >= e0; --e) {
          const int off = ebase + e * kEpiWords;
          transposed_epilogue<kCmp>(sp + off, gp + off, v, m, qb, c,
                                    outer_bits);
        }
        store_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
  }
}

template <typename T, int DV, int KR, bool kCmp, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_bwd_kernel(const typename ElemWord<T>::type* __restrict__ x,
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
  const size_t buf = tile_buf_bytes(rows, t, wpe, pad_words, sizeof(W));
  unsigned char* a_bytes = smem + tab_bytes + plan_bytes(n_words);
  W* tile = reinterpret_cast<W*>(a_bytes);             // x, then ct_pre
  W* ctile = reinterpret_cast<W*>(a_bytes + buf);      // ct as loaded
  unsigned* spill =
      n_spill ? reinterpret_cast<unsigned*>(a_bytes + 2 * buf) : nullptr;

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
    bwd_phases<T, DV, KR, kCmp>(tv, cv, s_plan, plan, d, inv_src0, s_xl,
                            rpt_shift, spill);
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

template <typename T, int DV, int KR, bool kCmp, int MB>
static int launch_bwd(const void* x, const void* ct, void* out,
                      const int* in_rows, const int* out_rows,
                      const int* xor_low, const int* inv_src0,
                      const long long* plan, int n_words, int n_tiles,
                      int n_rows, int rpt_shift, int tiles_per_cta, int t,
                      int wpe, int wpe_shift, int row_shift, int pad_words,
                      long long batch, int word_bytes, int d, int n_spill,
                      cudaStream_t s) {
  using W = typename ElemWord<T>::type;
  if (word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  const size_t smem =
      (size_t)REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta) +
      plan_bytes(n_words) +
      2 * tile_buf_bytes(rows, t, wpe, pad_words, (int)sizeof(W)) +
      (size_t)n_spill * DV * KR * REPRO_THREADS * 4;
  cudaError_t e = allow_smem(tile_bwd_kernel<T, DV, KR, kCmp, MB>, smem);
  if (e != cudaSuccess) return (int)e;
  tile_bwd_kernel<T, DV, KR, kCmp, MB><<<grid, REPRO_THREADS, smem, s>>>(
      (const W*)x, (const W*)ct, (W*)out, in_rows, out_rows, xor_low,
      inv_src0, plan, n_words, n_rows, rpt_shift, tiles_per_cta, t, wpe,
      wpe_shift, row_shift, pad_words, batch, d, n_spill);
  return (int)cudaGetLastError();
}

// elem_type: 1 = float32, 2 = bfloat16 (int32 has no gradient); dv as in
// repro_tile_fused; n_words: int64 words of plan (8 registers a thread:
// its compare bits sit beside its values); has_cmp: the cluster has
// compares (always, for dv 1); n_spill: compare-bit sets kept in shared
// memory (0: all in registers).
extern "C" int repro_tile_bwd(const void* x, void* out, const void* ct,
                              const int* in_rows, const int* out_rows,
                              const int* xor_low, const int* inv_src0,
                              const long long* plan, int n_words,
                              int n_tiles, int n_rows,
                              int rpt_shift, int tiles_per_cta, int t,
                              int wpe, int wpe_shift, int row_shift,
                              int pad_words, long long batch, int word_bytes,
                              int elem_type, int d, int dv, int has_cmp,
                              int n_spill, void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 || d <= 0 ||
      n_spill < 0 || plan == nullptr || n_words < kHdrWords ||
      (dv == 2 && (elem_type != 1 || d != 2)) || (dv == 1 && !has_cmp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(T, DV, CMP, MB)                                            \
  return launch_bwd<T, DV, 8, CMP, MB>(                                      \
      x, ct, out, in_rows, out_rows, xor_low, inv_src0, plan, n_words,       \
      n_tiles, n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift,          \
      row_shift, pad_words, batch, word_bytes, d, n_spill, s)
  // the last argument: blocks per SM the variant's registers allow (the
  // fastest choice on the H100 of a sweep over it; see PERF.md, PR 14)
  if (dv == 2 && has_cmp) REPRO_BWD(float, 2, true, 2);
  if (dv == 2) REPRO_BWD(float, 2, false, 3);
  if (dv != 1) return (int)cudaErrorInvalidValue;
  if (elem_type == 1) REPRO_BWD(float, 1, true, 3);
  if (elem_type == 2) REPRO_BWD(Bf16, 1, true, 2);
  return (int)cudaErrorInvalidValue;
#undef REPRO_BWD
}
