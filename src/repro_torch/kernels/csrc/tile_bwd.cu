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
//        map:  ct <- ct * f'(u), by reverse mode over the map's tape with
//              autograd's derivative formulas (the reference's jax.vjp);
//   5. writes the result where the forward read: rows in_rows[g].
// float32 and bfloat16 (cmp) and planar float32 (bfly); bfloat16 computes
// each product and sum in float and rounds it to nearest even once, as
// PyTorch does; float32 rounds each on its own (__fmul_rn/__fadd_rn: no
// contraction into FMAs); a map's derivative formulas round as PyTorch's
// CUDA kernels for them round (map_op_back). So the kernel is bit-equal
// to its plain version tiled_permute_bwd_tables_plain on the card.
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
// the waiting compare bits, and each map's input values: the replay keeps
// the values a map met (one per register and thread, by the map's slot
// and chunk) for the transposed sweep, which recomputes the tape's
// intermediates from them op by op (a tape of n ops costs n(n+1)/2 op
// evaluations, no array indexed at run time). What still bounds it:
// instruction issue (the replay, the transposed compares' masks and
// products) and the latency of four phase passes per block (PERF.md).
#include "tile_common.cuh"
#include "tile_epilogue.cuh"

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

// The cotangents (ga, gb) of the first and second operand (a, b) of one
// tape op from g, that of its result y: autograd's formulas as eager
// PyTorch rounds them on the card, each aten op rounded to T once (the
// fused tanh_backward and sigmoid_backward kernels as they compute:
// bfloat16 after each op, float32 tanh's 1 - y * y an FMA), as
// map_lower.tape_vjp computes them for a CUDA tensor. Out of line, as
// map_elem_op.
template <typename T>
__device__ __noinline__ float2 map_op_back(int op, int kb, float c, float a,
                                           float b, float y, float g) {
  float ga, gb = 0.0f;
  switch (op) {
    case OP_ADD: ga = g; gb = g; break;
    case OP_SUB: ga = g; gb = -g; break;
    case OP_MUL:
      ga = rnd<T>(__fmul_rn(g, b));
      gb = rnd<T>(__fmul_rn(g, a));
      break;
    case OP_DIV:
      if (kb == OPND_C) {   // g / c, as PyTorch divides by a number
        ga = rnd<T>(__fmul_rn(g, __fdiv_rn(1.0f, c)));
      } else {
        const float q = rnd<T>(__fdiv_rn(rnd<T>(__fdiv_rn(a, b)), b));
        ga = rnd<T>(__fdiv_rn(g, b));
        gb = rnd<T>(__fmul_rn(-g, q));
      }
      break;
    case OP_NEG: ga = -g; break;
    case OP_ABS:
      ga = rnd<T>(__fmul_rn(g, (float)((a > 0.0f) - (a < 0.0f))));
      break;
    case OP_MAXC: ga = a >= b ? g : 0.0f; break;
    case OP_MINC: ga = a <= b ? g : 0.0f; break;
    case OP_RELU: ga = y <= 0.0f ? 0.0f : g; break;
    case OP_EXP: ga = rnd<T>(__fmul_rn(g, y)); break;
    case OP_EXPM1:
      ga = rnd<T>(__fmul_rn(g, rnd<T>(__fadd_rn(y, 1.0f))));
      break;
    case OP_LOG: ga = rnd<T>(__fdiv_rn(g, a)); break;
    case OP_LOG1P:
      ga = rnd<T>(__fdiv_rn(g, rnd<T>(__fadd_rn(a, 1.0f))));
      break;
    case OP_SQRT:
      ga = rnd<T>(__fdiv_rn(g, rnd<T>(__fmul_rn(2.0f, y))));
      break;
    case OP_RSQRT:   // y.pow(3) as PyTorch's pow takes a cube, in T
      ga = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(-0.5f, g)),
                            rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(y, y)), y))));
      break;
    case OP_TANH:   // PyTorch's CUDA tanh_backward: g * (1 - y * y)
      if constexpr (std::is_same_v<T, Bf16>)   // in bfloat16 arithmetic
        ga = rnd<T>(__fmul_rn(g, rnd<T>(__fsub_rn(1.0f,
                                                  rnd<T>(__fmul_rn(y, y))))));
      else                                     // contracted into an FMA
        ga = __fmul_rn(g, __fmaf_rn(-y, y, 1.0f));
      break;
    case OP_SIGMOID:   // sigmoid_backward: (g * (1 - y)) * y, each in T
      ga = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(g, rnd<T>(__fsub_rn(1.0f, y)))),
                            y));
      break;
    default: ga = g; break;
  }
  return make_float2(ga, gb);
}

// The transposed map (staged record ep) on the cotangent registers ct,
// `at` the map's input values the replay kept (map_save_at): reverse mode
// over the tape, one register at a time, the input of op s recomputed
// from u by ops 0 .. s - 1; the cotangents of u summed in the order
// autograd receives them (last op first).
template <int KR, typename T>
__device__ __forceinline__ void map_vjp_regs(const int* ep, T (&ct)[KR],
                                             const T* at) {
  const int n = ep[EP_MAP_LEN];
  if (n == 0) return;
  const int* tape = ep + EP_MAP_OPS;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const float u = widen(at[i * REPRO_THREADS]);
    float g = widen(ct[i]), cu = -0.0f;   // -0 + x == x for every x
    for (int s = n - 1; s >= 0; --s) {
      const int* w = tape + 2 * s;
      const float x = map_eval<T>(tape, s, u);   // the op's R operand
      const float y = map_elem_op<T>(w, x, u);
      const int op = w[0] & 0xff, ka = (w[0] >> 8) & 3, kb = (w[0] >> 10) & 3;
      const float c = __int_as_float(w[1]);
      const float2 gg = map_op_back<T>(op, kb, c, operand(ka, x, u, c),
                                        operand(kb, x, u, c), y, g);
      const float ga = gg.x, gb = gg.y;
      if (ka == OPND_U) cu = rnd<T>(__fadd_rn(cu, ga));
      if (kb == OPND_U) cu = rnd<T>(__fadd_rn(cu, gb));
      if (kb == OPND_R) g = ka == OPND_R ? rnd<T>(__fadd_rn(ga, gb)) : gb;
      else if (ka == OPND_R) g = ga;
    }
    narrow_to(cu, ct[i]);
  }
}

// The transpose of epilogue e (staged record ep, device record gep) on the
// cotangent registers (see step 4); `save` holds the maps' inputs.
template <bool kCmp, bool kMaps, int DV, int KR, typename T>
__device__ __forceinline__ void transposed_epilogue(
    const int* ep, const long long* gep, T (&v)[DV][KR],
    const unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits, const T* save) {
  if constexpr (kMaps && DV == 1) {
    if (ep[EP_KIND] == kKindMap) {
      map_vjp_regs(ep, v[0], map_save_at<KR>(save, ep[EP_MAP_SLOT], chunk,
                                             outer_bits));
      return;
    }
  }
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
// bits in m); kMaps: it has maps, `save` the room for their inputs.
template <typename T, int DV, int KR, bool kCmp, bool kMaps>
__device__ __forceinline__ void bwd_phases(const TileView& tv,
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
          use_masks<DV>(m, cur, group * (int)chunks + (int)c, first, spill);
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
          use_masks<DV>(m, cur, group * (int)chunks + (int)c, false, spill);
        if (p + 1 == n_phases)
          load_ungathered<DV>(v, cv, qb, pr.qr, pr.valid, k, inv_src0, s_xl,
                              rpt_shift);
        else
          load_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
        for (int e = e1 - 1; e >= e0; --e) {
          const int off = ebase + e * kEpiWords;
          transposed_epilogue<kCmp, kMaps>(sp + off, gp + off, v, m, qb, c,
                                           outer_bits, save);
        }
        store_regs<DV>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
  }
}

template <typename T, int DV, int KR, bool kCmp, bool kMaps, int MB>
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
    bwd_phases<T, DV, KR, kCmp, kMaps>(tv, cv, s_plan, plan, d, inv_src0,
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
static int launch_bwd(const void* x, const void* ct, void* out,
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
      2 * tile_buf_bytes(rows, t, wpe, pad_words, (int)sizeof(W)) +
      (size_t)n_spill * DV * KR * REPRO_THREADS * 4 +
      (size_t)n_map_sets * KR * REPRO_THREADS * sizeof(T);
  cudaError_t e =
      allow_smem(tile_bwd_kernel<T, DV, KR, kCmp, kMaps, MB>, smem);
  if (e != cudaSuccess) return (int)e;
  tile_bwd_kernel<T, DV, KR, kCmp, kMaps, MB>
      <<<grid, REPRO_THREADS, smem, s>>>(
      (const W*)x, (const W*)ct, (W*)out, in_rows, out_rows, xor_low,
      inv_src0, plan, n_words, n_rows, rpt_shift, tiles_per_cta, t, wpe,
      wpe_shift, row_shift, pad_words, batch, d, n_spill);
  return (int)cudaGetLastError();
}

// elem_type: 1 = float32, 2 = bfloat16 (int32 has no gradient); dv as in
// repro_tile_fused; n_words: int64 words of plan (8 registers a thread:
// its compare bits sit beside its values); has_cmp: the cluster has
// compares (dv 1 takes the compare variant either way: a cluster of maps
// alone has no compare bits to keep); n_spill: compare-bit sets kept in
// shared memory (0: all in registers); n_map_sets: maps times chunks,
// the sets of map inputs kept in shared memory.
extern "C" int repro_tile_bwd(const void* x, void* out, const void* ct,
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
  return launch_bwd<T, DV, 8, CMP, MAPS, MB>(                                \
      x, ct, out, in_rows, out_rows, xor_low, inv_src0, plan, n_words,       \
      n_tiles, n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift,          \
      row_shift, pad_words, batch, word_bytes, d, n_spill, n_map_sets, s)
  // the last argument: blocks per SM the variant's registers allow (the
  // fastest choice on the H100 of a sweep over it; see PERF.md, PR 14)
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
