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
// float32, bfloat16, float16 and float64 (cmp, map, and bfly on a planar
// (re, im) tail; integers have no gradient); a half float computes each
// product and sum in float and rounds it to nearest even once, as PyTorch
// does; float32 and float64 round each on their own (__fmul_rn/__fadd_rn,
// __dmul_rn/__dadd_rn: no contraction into FMAs); a map's derivative
// formulas round as PyTorch's CUDA kernels for them round (map_op_back).
// So the kernel is bit-equal to its plain version
// tiled_permute_bwd_tables_plain on the card.
//
// Bound on the H100: bytes. x and ct are read once and the result written
// once, 3 * size bytes over 3.35 TB/s, plus the tables. The first design
// ran at 7 % of it (device time): besides K4b's table reads and
// per-epilogue barriers it kept the compare bits in shared memory (a
// zeroing pass, two read-modify-writes per pair per compare, two reads
// per transposed compare) and needed about 62 KiB per block.
//
// This design: a block takes a run of work items (at most 4096
// positions of one batch row; the host's k5_schedule), stages all their
// row ids, lane XORs and epilogue bases once, and copies each item's x
// rows and ct rows with 16-byte cp.async copies as two commit groups
// (tile_items.cuh): the replay waits for x alone, the first transposed
// phase for ct, so the cotangent lands under the replay; a second item
// is in flight where the block's shared memory stays small enough (the
// schedule's rule). The result leaves 16 bytes a thread to rows
// in_rows[g]. Tile rows are padded by one 16-byte chunk. The epilogues
// run in registers under the host plan's phases (tile_epilogue.cuh, its
// kFast register moves and kPairs compares), 8 positions a thread. The
// compare bits stay in registers: each element's two bits of compare j
// sit at bits 2j, 2j + 1 of one register word of the thread that
// computed them, and the transposed sweep runs the phases in reverse, so
// the same thread holds the same positions under the same layout when it
// reads them back. The replay compares floats as integer keys where a
// warp holds no NaN (the compare bits from key equality, -0 and +0
// equal). With two compare-bit sets (two chunks of one group, or two
// groups of 16 compares: the 2^24 sort's largest cluster is the first)
// the second waits in registers too; with more, the words of the sets
// not in use wait in shared memory, one word per thread and register.
// The last replay phase keeps no values and the first transposed phase
// reads the cotangent straight from the loaded ct tile through the
// un-gather. Shared memory per block: the tables, the staged plan, an x
// and a ct tile per item in flight and, with more than two bit sets, the
// waiting compare bits, and the maps' input values: the replay keeps the
// values a map met (one per register and thread, by the map's slot and
// chunk) for the transposed sweep, which runs the tape forward once from
// them (every value kept in a per-thread array) and then in reverse. The
// host gives as many maps a slot as fit 227 KiB with one work item in
// flight (k5_map_slots); past that, the first map of each phase keeps
// one, and a map without one has its input recomputed, when its turn
// comes in the transposed sweep, from the nearest kept map before it in
// its phase: the replay's epilogues in between run again on the kept
// values, into the one spare slot. A pointer off 16-byte alignment or
// rows of fewer than 16 bytes take the same schedule one word of the
// element's width at a time.
//
// Measured (PERF.md; H100 80GB HBM3, 700 W; the largest 2^24 sort
// cluster, float32, device time): 0.393 ms against 0.442 for the design
// before (tools/fused_ab.cu), in turns; bound 0.061 ms. On float64 0.5015
// ms (bound 0.120). What still
// bounds it: the replay and the transposed compares (about 20
// instructions an element and compare: keys, compare bits, the masks'
// byte permutes, two products and a sum), issued at 3 blocks an SM with
// their latency behind a barrier a phase.
#include "tile_items.cuh"

// a * m and a + b, each rounded to T on its own
__device__ __forceinline__ float prod(float a, float m) {
  return __fmul_rn(a, m);
}
__device__ __forceinline__ Bf16 prod(Bf16 a, float m) {
  return round_bf16(__fmul_rn(as_float(a), m));
}
__device__ __forceinline__ F16 prod(F16 a, float m) {
  return round_f16(__fmul_rn(as_float(a), m));
}
__device__ __forceinline__ float sum(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ Bf16 sum(Bf16 a, Bf16 b) {
  return round_bf16(__fadd_rn(as_float(a), as_float(b)));
}
__device__ __forceinline__ F16 sum(F16 a, F16 b) {
  return round_f16(__fadd_rn(as_float(a), as_float(b)));
}
__device__ __forceinline__ double prod(double a, float m) {
  return __dmul_rn(a, (double)m);
}
__device__ __forceinline__ double sum(double a, double b) {
  return __dadd_rn(a, b);
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

// Transposed butterfly on registers (planar float32, bfloat16, float16 or
// float64; a half float rounds each product and sum to its type).
template <int VR, int KR, typename T>
__device__ __forceinline__ void tr_bfly_regs(T (&v)[2][KR], unsigned hx,
                                             int vlane,
                                             const typename TwOf<T>::type* w,
                                             const unsigned (&tw)[KR]) {
  T pr[KR], pi[KR];
  partners<VR>(v[0], vlane, pr);
  partners<VR>(v[1], vlane, pi);
  if constexpr (std::is_same_v<T, double>) {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      if ((hx >> i) & 1u) {                // the pair's "hi" member
        const double2 wv = __ldg(w + tw[i]);
        const double s_re = __dsub_rn(pr[i], v[0][i]);
        const double s_im = __dsub_rn(pi[i], v[1][i]);
        v[0][i] = __dadd_rn(__dmul_rn(wv.x, s_re), __dmul_rn(wv.y, s_im));
        v[1][i] = __dsub_rn(__dmul_rn(wv.x, s_im), __dmul_rn(wv.y, s_re));
      } else {
        v[0][i] = __dadd_rn(v[0][i], pr[i]);
        v[1][i] = __dadd_rn(v[1][i], pi[i]);
      }
    }
  } else if constexpr (std::is_same_v<T, float>) {   // float32's code
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      if ((hx >> i) & 1u) {                // the pair's "hi" member
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
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const float c_re = as_float(v[0][i]), c_im = as_float(v[1][i]);
      const float q_re = as_float(pr[i]), q_im = as_float(pi[i]);
      if ((hx >> i) & 1u) {                // the pair's "hi" member
        const float2 wv = __ldg(w + tw[i]);
        const float s_re = rnd<T>(__fsub_rn(q_re, c_re));
        const float s_im = rnd<T>(__fsub_rn(q_im, c_im));
        narrow_to(__fadd_rn(rnd<T>(__fmul_rn(wv.x, s_re)),
                            rnd<T>(__fmul_rn(wv.y, s_im))), v[0][i]);
        narrow_to(__fsub_rn(rnd<T>(__fmul_rn(wv.x, s_im)),
                            rnd<T>(__fmul_rn(wv.y, s_re))), v[1][i]);
      } else {
        narrow_to(__fadd_rn(c_re, q_re), v[0][i]);
        narrow_to(__fadd_rn(c_im, q_im), v[1][i]);
      }
    }
  }
}

// The cotangents of an op's operands (a, b, c) from that of its result.
template <typename F>
struct Back {
  F a, b, c;
};

// PyTorch's fused backward kernels (gelu_backward, silu_backward,
// softplus_backward) as PyTorch's CUDA kernels write them, in their
// compute type F.
template <typename F>
__device__ __forceinline__ F gelu_erf_back(F dy, F x) {
  constexpr F kBeta = k2SqrtPi * kSqrt1_2 * F(0.5);
  constexpr F kAlpha = kSqrt1_2;
  const F cdf = F(0.5) * (F(1) + erf(x * kAlpha));
  const F pdf = exp(F(-0.5) * x * x) * kBeta;
  return dy * (cdf + x * pdf);
}
template <typename F>
__device__ __forceinline__ F gelu_tanh_back(F dy, F x) {
  constexpr F kBeta = kSqrt2 * k2SqrtPi * F(0.5);
  constexpr F kKappa = 0.044715;
  auto x_sq = x * x;
  auto x_cube = x_sq * x;
  auto inner = kBeta * (x + kKappa * x_cube);
  auto tanh_inner = tanh(inner);
  auto left = F(0.5) * x;
  auto right = F(1) + tanh_inner;
  auto left_derivative = F(0.5) * right;
  auto tanh_derivative = F(1) - tanh_inner * tanh_inner;
  auto inner_derivative = kBeta * (F(1) + F(3) * kKappa * x_sq);
  auto right_derivative = left * tanh_derivative * inner_derivative;
  return dy * (left_derivative + right_derivative);
}
template <typename F>
__device__ __forceinline__ F silu_back(F dy, F x) {
  const F s = F(1) / (F(1) + exp(-x));
  return dy * s * (F(1) + x * (F(1) - s));
}
template <typename F>
__device__ __forceinline__ F softplus_back(F dy, F x, F beta, F threshold) {
  const F z = exp(x * beta);
  return (x * beta) > threshold ? dy : dy * z / (z + F(1));
}

// The cotangents of the operands (a, b, c) of tape op w from g, that of
// its result y, for the ops map_back_step does not run inline:
// autograd's formulas as eager PyTorch rounds them on the card, each aten
// op rounded to T once (the fused tanh_backward and sigmoid_backward
// kernels as they compute: bfloat16 after each op, float32 tanh's 1 - y *
// y an FMA; the fused gelu, silu and softplus backward kernels rounded
// once), as autograd computes them for a CUDA tensor; float16 rounds as
// bfloat16 does. Out of line, as map_elem_op.
template <typename T>
__device__ __noinline__ Back<float> map_op_back(int w, float a, float b,
                                                float c, float y, float g,
                                                const int* pool);

// A float value rounded to element class T: the policy the float formulas
// of K5 take (the ext build's RndK rounds to a type chosen at run time).
template <typename T>
struct RndT {
  __device__ __forceinline__ float operator()(float f) const {
    return rnd<T>(f);
  }
  __device__ __forceinline__ bool half() const { return kHalf<T>; }
  __device__ __forceinline__ float pow(float x, double e) const {
    return map_pow<T>(x, e);
  }
  __device__ __forceinline__ Back<float> back(int w, float a, float b,
                                              float c, float y, float g,
                                              const int* pool) const {
    return map_op_back<T>(w, a, b, c, y, g, pool);
  }
};

template <typename R>
__device__ __forceinline__ Back<float> map_op_back_f(R rn, int w, float a,
                                                     float b, float c,
                                                     float y, float g,
                                                     const int* pool) {
  const int op = w & 0x7F;
  float ga = 0.0f, gb = 0.0f;
  switch (op) {
    case OP_DIV: {   // b a value (map_back_step takes b a number)
      const float q = rn(__fdiv_rn(rn(__fdiv_rn(a, b)), b));
      ga = rn(__fdiv_rn(g, b));
      gb = rn(__fmul_rn(-g, q));
      break;
    }
    case OP_EXP: ga = rn(__fmul_rn(g, y)); break;
    case OP_EXPM1:
      ga = rn(__fmul_rn(g, rn(__fadd_rn(y, 1.0f))));
      break;
    case OP_LOG: ga = rn(__fdiv_rn(g, a)); break;
    case OP_LOG1P:
      ga = rn(__fdiv_rn(g, rn(__fadd_rn(a, 1.0f))));
      break;
    case OP_SQRT:
      ga = rn(__fdiv_rn(g, rn(__fmul_rn(2.0f, y))));
      break;
    case OP_RSQRT:   // y.pow(3) as PyTorch's pow takes a cube, in T
      ga = rn(__fmul_rn(rn(__fmul_rn(-0.5f, g)),
                            rn(__fmul_rn(rn(__fmul_rn(y, y)), y))));
      break;
    case OP_TANH:   // PyTorch's CUDA tanh_backward: g * (1 - y * y)
      if (rn.half())                  // in half arithmetic
        ga = rn(__fmul_rn(g, rn(__fsub_rn(1.0f,
                                                  rn(__fmul_rn(y, y))))));
      else                                     // contracted into an FMA
        ga = __fmul_rn(g, __fmaf_rn(-y, y, 1.0f));
      break;
    case OP_SIGMOID:   // sigmoid_backward: (g * (1 - y)) * y, each in T
      ga = rn(__fmul_rn(rn(__fmul_rn(g, rn(__fsub_rn(1.0f, y)))),
                            y));
      break;
    case OP_SIN:   // autograd: g * a.cos(), two ops
      ga = rn(__fmul_rn(g, rn(map_trig(OP_COS, a))));
      break;
    case OP_COS:   // g * -a.sin()
      ga = rn(__fmul_rn(g, -rn(map_trig(OP_SIN, a))));
      break;
    case OP_POW: {   // g * (e * a.pow(e - 1)); 0 for e == 0
      const int k = (w >> 16) & 0x3F;
      const double e = __longlong_as_double(wide_const(pool[2 * k],
                                                       pool[2 * k + 1]));
      if (e != 0.0)
        ga = rn(__fmul_rn(g, rn(__fmul_rn((float)e,
                                                  rn.pow(a, e - 1.0)))));
      break;
    }
    case OP_RECIP: ga = rn(__fmul_rn(-g, rn(__fmul_rn(y, y)))); break;
    case OP_ERF: {   // 2 / sqrt(pi) * exp(-(a.pow(2))) * g
      const float k = (float)(2.0 / sqrt(kPi));
      ga = rn(__fmul_rn(
          rn(__fmul_rn(rn(expf(-rn(__fmul_rn(a, a)))), k)), g));
      break;
    }
    case OP_LOG2:   // g / (a * ln 2)
      ga = rn(__fdiv_rn(g, rn(__fmul_rn(a, (float)kLn2))));
      break;
    case OP_EXP2:   // g * y * ln 2
      ga = rn(__fmul_rn(rn(__fmul_rn(g, y)), (float)kLn2));
      break;
    case OP_GELU: ga = rn(gelu_erf_back(g, a)); break;
    case OP_GELU_TANH: ga = rn(gelu_tanh_back(g, a)); break;
    case OP_SILU: ga = rn(silu_back(g, a)); break;
    case OP_SOFTPLUS: ga = rn(softplus_back(g, a, b, c)); break;
    default: break;
  }
  return Back<float>{ga, gb, 0.0f};
}
template <typename T>
__device__ __noinline__ Back<float> map_op_back(int w, float a, float b,
                                                float c, float y, float g,
                                                const int* pool) {
  return map_op_back_f(RndT<T>{}, w, a, b, c, y, g, pool);
}

// map_op_back in double (float64): each aten op rounded once, tanh's
// 1 - y * y an FMA as in float32.
__device__ __noinline__ Back<double> map_op_back(int w, double a, double b,
                                                 double c, double y, double g,
                                                 const int* pool) {
  const int op = w & 0x7F;
  double ga = 0.0, gb = 0.0;
  switch (op) {
    case OP_DIV: {
      const double q = __ddiv_rn(__ddiv_rn(a, b), b);
      ga = __ddiv_rn(g, b);
      gb = __dmul_rn(-g, q);
      break;
    }
    case OP_EXP: ga = __dmul_rn(g, y); break;
    case OP_EXPM1: ga = __dmul_rn(g, __dadd_rn(y, 1.0)); break;
    case OP_LOG: ga = __ddiv_rn(g, a); break;
    case OP_LOG1P: ga = __ddiv_rn(g, __dadd_rn(a, 1.0)); break;
    case OP_SQRT: ga = __ddiv_rn(g, __dmul_rn(2.0, y)); break;
    case OP_RSQRT:
      ga = __dmul_rn(__dmul_rn(-0.5, g), __dmul_rn(__dmul_rn(y, y), y));
      break;
    case OP_TANH: ga = __dmul_rn(g, __fma_rn(-y, y, 1.0)); break;
    case OP_SIGMOID:
      ga = __dmul_rn(__dmul_rn(g, __dsub_rn(1.0, y)), y);
      break;
    case OP_SIN: ga = __dmul_rn(g, map_trig(OP_COS, a)); break;
    case OP_COS: ga = __dmul_rn(g, -map_trig(OP_SIN, a)); break;
    case OP_POW:
      if (b != 0.0)
        ga = __dmul_rn(g, __dmul_rn(b, map_pow<double>(a, b - 1.0)));
      break;
    case OP_RECIP: ga = __dmul_rn(-g, __dmul_rn(y, y)); break;
    case OP_ERF:
      ga = __dmul_rn(__dmul_rn(exp(-__dmul_rn(a, a)), 2.0 / sqrt(kPi)), g);
      break;
    case OP_LOG2: ga = __ddiv_rn(g, __dmul_rn(a, kLn2)); break;
    case OP_EXP2: ga = __dmul_rn(__dmul_rn(g, y), kLn2); break;
    case OP_GELU: ga = gelu_erf_back(g, a); break;
    case OP_GELU_TANH: ga = gelu_tanh_back(g, a); break;
    case OP_SILU: ga = silu_back(g, a); break;
    case OP_SOFTPLUS: ga = softplus_back(g, a, b, c); break;
    default: break;
  }
  return Back<double>{ga, gb, 0.0};
}

// cotangents summed as autograd sums them: rounded to T once (float64 in
// double)
template <typename T, typename F>
__device__ __forceinline__ F ct_sum(F a, F b) {
  if constexpr (std::is_same_v<T, double>) return __dadd_rn(a, b);
  else return rnd<T>(__fadd_rn(a, b));
}

// An operand byte d for every register, every slot's values in vals
// (vals[0] the inputs).
template <int KR, typename F>
__device__ __forceinline__ void tape_args(int d, const F (*vals)[KR],
                                          const int* pool, F (&x)[KR]) {
  if (d & 0x80) {
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = F(0);
  } else if (d & kOpndConst) {
    const F k = map_const<F>(pool, d & 0x3F);
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = k;
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = vals[d][i];
  }
}

// The cotangents (ga, gb, gc) of tape op w's operands (a, b, c) for every
// register, from g, that of its result y (autograd's formulas, rounded as
// PyTorch's CUDA kernels round them): the ops whose formula is a few
// instructions inline across the registers, the others through
// map_op_back once a register.
#define REPRO_BACK_ALL(A, B, C)                                       \
  {                                                                   \
    _Pragma("unroll") for (int i = 0; i < KR; ++i) {                  \
      ga[i] = (A);                                                    \
      gb[i] = (B);                                                    \
      gc[i] = (C);                                                    \
    }                                                                 \
  }                                                                   \
  return;
// The float branch of map_back_step under rounding policy rn (its back:
// the out-of-line formulas, map_op_back, for the ops not run inline).
template <int KR, typename R>
__device__ __forceinline__ void map_back_step_f(
    R rn, int w, const float (&a)[KR], const float (&b)[KR],
    const float (&c)[KR], const float (&y)[KR], const float (&g)[KR],
    float (&ga)[KR], float (&gb)[KR], float (&gc)[KR], const int* pool) {
  const int op = w & 0x7F;
  const bool b_const = ((w >> 16) & 0xC0) == kOpndConst;
  const float z = 0.0f;
  switch (op) {
    case OP_ADD: REPRO_BACK_ALL(g[i], g[i], z)
    case OP_SUB: REPRO_BACK_ALL(g[i], -g[i], z)
    case OP_MUL:
      REPRO_BACK_ALL(rn(__fmul_rn(g[i], b[i])),
                     rn(__fmul_rn(g[i], a[i])), z)
    case OP_DIV:
      if (b_const) {   // g / c, as PyTorch divides by a number
        const float inv = __fdiv_rn(1.0f, b[0]);
        REPRO_BACK_ALL(rn(__fmul_rn(g[i], inv)), z, z)
      }
      break;
    case OP_NEG: REPRO_BACK_ALL(-g[i], z, z)
    case OP_ABS:
      REPRO_BACK_ALL(rn(__fmul_rn(g[i], (float)((a[i] > 0.0f) -
                                                     (a[i] < 0.0f)))),
                     z, z)
    case OP_MAXC: REPRO_BACK_ALL(a[i] >= b[i] ? g[i] : z, z, z)
    case OP_MINC: REPRO_BACK_ALL(a[i] <= b[i] ? g[i] : z, z, z)
    case OP_RELU: REPRO_BACK_ALL(y[i] <= 0.0f ? z : g[i], z, z)
    case OP_WHERE:
      REPRO_BACK_ALL(z, a[i] != 0.0f ? g[i] : z, a[i] != 0.0f ? z : g[i])
    case OP_MAXIMUM:
      REPRO_BACK_ALL(
          a[i] < b[i] ? z : (a[i] == b[i] ? rn(__fmul_rn(g[i], 0.5f))
                                          : g[i]),
          a[i] > b[i] ? z : (a[i] == b[i] ? rn(__fmul_rn(g[i], 0.5f))
                                          : g[i]), z)
    case OP_MINIMUM:
      REPRO_BACK_ALL(
          a[i] > b[i] ? z : (a[i] == b[i] ? rn(__fmul_rn(g[i], 0.5f))
                                          : g[i]),
          a[i] < b[i] ? z : (a[i] == b[i] ? rn(__fmul_rn(g[i], 0.5f))
                                          : g[i]), z)
    case OP_FLOOR:
    case OP_CEIL:
    case OP_TRUNC:
    case OP_ROUND:
    case OP_SIGN:
    case OP_FLOORDIV:
    case OP_TRUNCDIV: REPRO_BACK_ALL(z, z, z)
    case OP_REM:
    case OP_FMOD: REPRO_BACK_ALL(g[i], z, z)
    case OP_LEAKY:
      REPRO_BACK_ALL(rn(a[i] > 0.0f ? g[i] : g[i] * b[i]), z, z)
    case OP_HARDTANH:
      REPRO_BACK_ALL((a[i] <= b[i]) || (a[i] >= c[i]) ? z : g[i], z, z)
    default: break;
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const Back<float> r = rn.back(w, a[i], b[i], c[i], y[i], g[i],
                                  pool);
    ga[i] = r.a;
    gb[i] = r.b;
    gc[i] = r.c;
  }
}

template <typename T, int KR, typename F>
__device__ __forceinline__ void map_back_step(
    int w, const F (&a)[KR], const F (&b)[KR], const F (&c)[KR],
    const F (&y)[KR], const F (&g)[KR], F (&ga)[KR], F (&gb)[KR],
    F (&gc)[KR], const int* pool) {
  const int op = w & 0x7F;
  const bool b_const = ((w >> 16) & 0xC0) == kOpndConst;
  const F z = F(0);
  if constexpr (std::is_same_v<F, float>) {
    map_back_step_f<KR>(RndT<T>{}, w, a, b, c, y, g, ga, gb, gc, pool);
  } else {
    switch (op) {
      case OP_ADD: REPRO_BACK_ALL(g[i], g[i], z)
      case OP_SUB: REPRO_BACK_ALL(g[i], -g[i], z)
      case OP_MUL:
        REPRO_BACK_ALL(__dmul_rn(g[i], b[i]), __dmul_rn(g[i], a[i]), z)
      case OP_DIV:
        if (b_const) {
          const double inv = __ddiv_rn(1.0, b[0]);
          REPRO_BACK_ALL(__dmul_rn(g[i], inv), z, z)
        }
        break;
      case OP_NEG: REPRO_BACK_ALL(-g[i], z, z)
      case OP_ABS:
        REPRO_BACK_ALL(__dmul_rn(g[i], (double)((a[i] > 0.0) - (a[i] < 0.0))),
                       z, z)
      case OP_MAXC: REPRO_BACK_ALL(a[i] >= b[i] ? g[i] : z, z, z)
      case OP_MINC: REPRO_BACK_ALL(a[i] <= b[i] ? g[i] : z, z, z)
      case OP_RELU: REPRO_BACK_ALL(y[i] <= 0.0 ? z : g[i], z, z)
      case OP_WHERE:
        REPRO_BACK_ALL(z, a[i] != 0.0 ? g[i] : z, a[i] != 0.0 ? z : g[i])
      case OP_MAXIMUM:
        REPRO_BACK_ALL(
            a[i] < b[i] ? z : (a[i] == b[i] ? __dmul_rn(g[i], 0.5) : g[i]),
            a[i] > b[i] ? z : (a[i] == b[i] ? __dmul_rn(g[i], 0.5) : g[i]),
            z)
      case OP_MINIMUM:
        REPRO_BACK_ALL(
            a[i] > b[i] ? z : (a[i] == b[i] ? __dmul_rn(g[i], 0.5) : g[i]),
            a[i] < b[i] ? z : (a[i] == b[i] ? __dmul_rn(g[i], 0.5) : g[i]),
            z)
      case OP_FLOOR:
      case OP_CEIL:
      case OP_TRUNC:
      case OP_ROUND:
      case OP_SIGN:
      case OP_FLOORDIV:
      case OP_TRUNCDIV: REPRO_BACK_ALL(z, z, z)
      case OP_REM:
      case OP_FMOD: REPRO_BACK_ALL(g[i], z, z)
      case OP_LEAKY: REPRO_BACK_ALL(a[i] > 0.0 ? g[i] : g[i] * b[i], z, z)
      case OP_HARDTANH:
        REPRO_BACK_ALL((a[i] <= b[i]) || (a[i] >= c[i]) ? z : g[i], z, z)
      default: break;
    }
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const Back<double> r = map_op_back(w, a[i], b[i], c[i], y[i], g[i],
                                         pool);
      ga[i] = r.a;
      gb[i] = r.b;
      gc[i] = r.c;
    }
  }
}

#ifdef REPRO_MAP_EXT
// The ext build's K5 side (tile_epilogue.cuh's ext build): the derivative
// formulas of the ops past the register path's list, and typed tapes.
// Each aten op of a derivative formula on its own: no contraction into
// FMAs across ops (float32 and float64).
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// The cotangents of the ops past PyTorch's one-op activations (d: a
// fourth operand, addcmul's and addcdiv's value), in the compute type F:
// autograd's formulas as eager PyTorch rounds them on the card, each aten
// op rounded to the type (rk, kRk) once; PyTorch's fused backward
// kernels (elu, hardsigmoid, hardswish, mish, log_sigmoid, the shrinks,
// threshold, logit) written as PyTorch writes them and rounded once. Out
// of line (map_ext_back): one copy a translation unit and compute type.
template <typename F>
__device__ __forceinline__ Back<F> map_ext_back_f(int w, int rk, F a, F b,
                                                  F c, F d, F y, F g,
                                                  const int* pool) {
  auto R = [rk](F x) { return rnd_k(x, rk); };
  const F zero(0.0f), one(1.0f);
  F ga = zero, gb = zero, gc = zero;
  switch (w & 0x7F) {
    case OP_REM:     // by a value: other gets -g * a.div(b, "floor")
      ga = g;
      gb = R(mul_rn(-g, floor_div_tt(a, b, rk)));
      break;
    case OP_FMOD:    // -g * a.div(b, "trunc")
      ga = g;
      gb = R(mul_rn(-g, trunc(R(div_rn(a, b)))));
      break;
    case OP_NAN_TO_NUM:   // g * isfinite(a)
      ga = R(mul_rn(g, isfinite(a) ? one : zero));
      break;
    case OP_COPYSIGN: {   // ratio = y / a, 0 where a == 0; other: zeros
      const F ratio = (a == zero) ? zero : R(div_rn(y, a));
      ga = R(mul_rn(g, ratio));
      break;
    }
    case OP_POWT:
      ga = (b == zero) ? zero
           : R(mul_rn(g, R(mul_rn(b, R(m_pow(a, R(sub_rn(b, one))))))));
      gb = R(mul_rn(g, (a == zero && b >= zero) ? zero
                                                : R(mul_rn(y, R(m_log(a))))));
      break;
    case OP_ATAN2: {
      const F recip = R(div_rn(one, R(add_rn(R(mul_rn(a, a)),
                                             R(mul_rn(b, b))))));
      ga = R(mul_rn(R(mul_rn(g, b)), recip));
      gb = R(mul_rn(R(mul_rn(g, -a)), recip));
      break;
    }
    case OP_HYPOT:
      ga = R(div_rn(R(mul_rn(g, a)), y));
      gb = R(div_rn(R(mul_rn(g, b)), y));
      break;
    case OP_LERP:   // g * (1 - w) from the double, g * w
      if constexpr (std::is_same_v<F, double>) {
        ga = mul_rn(g, 1.0 - c);
      } else {
        ga = R(mul_rn(g, __int_as_float(pool[2 * ((w >> 24) & 0x3F) + 1])));
      }
      gb = R(mul_rn(g, c));
      break;
    case OP_ADDCMUL:
      ga = g;
      gb = R(mul_rn(g, R(mul_rn(c, d))));
      gc = R(mul_rn(g, R(mul_rn(b, d))));
      break;
    case OP_ADDCDIV:   // value / c fills the value in the type first
      ga = g;
      gb = R(mul_rn(g, R(div_rn(R(d), c))));
      gc = R(mul_rn(-g, R(div_rn(R(mul_rn(b, d)), R(mul_rn(c, c))))));
      break;
    case OP_ELU:
    case OP_ELU_SCALED: {   // elu_backward, is_result false
      const bool scaled = (w & 0x7F) == OP_ELU_SCALED;
      const F negcoef = scaled ? b * c : b;
      const F poscoef = scaled ? c : one;
      const F negiptcoef = scaled ? one : c;
      ga = R(a <= zero ? g * negiptcoef * negcoef * m_exp(a * negiptcoef)
                       : g * poscoef);
      break;
    }
    case OP_HARDSIGMOID: {
      const F one_sixth(1.0f / 6.0f);
      ga = R((a > F(-3.0f) && a < F(3.0f)) ? g * one_sixth : zero);
      break;
    }
    case OP_HARDSWISH:
      ga = R(a <= F(-3.0f) ? zero
             : (a < F(3.0f) ? g * ((a / F(3.0f)) + F(0.5f)) : g));
      break;
    case OP_MISH: {
      const F s = one / (one + m_exp(-a));
      const F t = m_softplus_tanh(a);
      ga = R(g * (t + a * s * (one - t * t)));
      break;
    }
    case OP_LOGSIGMOID: {
      const bool neg = a < zero;
      const F max_deriv = neg ? one : zero;
      const F sign = neg ? one : -one;
      const F z = m_exp(-fabs(a));
      ga = R(g * (max_deriv - sign * (z / (one + z))));
      break;
    }
    case OP_HARDSHRINK:
    case OP_SOFTSHRINK: ga = (a >= -b && a <= b) ? zero : g; break;
    case OP_THRESHOLD: ga = a <= b ? zero : g; break;
    case OP_LOGIT:
      if (b < zero) {
        ga = R((a < zero || a > one) ? F(NAN) : g / (a * (one - a)));
      } else {
        const F hi = one - b;
        ga = R((a < b || a > hi) ? zero : g / (a * (one - a)));
      }
      break;
    case OP_TAN:   // g * (1 + y.pow(2))
      ga = R(mul_rn(g, R(add_rn(R(mul_rn(y, y)), one))));
      break;
    case OP_ATAN:   // g / (a * a + 1)
      ga = R(div_rn(g, R(add_rn(R(mul_rn(a, a)), one))));
      break;
    case OP_ASIN:   // g * (-a * a + 1).rsqrt()
      ga = R(mul_rn(g, R(m_rsqrt(R(add_rn(R(mul_rn(-a, a)), one))))));
      break;
    case OP_ACOS:   // g * -((-a * a + 1).rsqrt())
      ga = R(mul_rn(g, -R(m_rsqrt(R(add_rn(R(mul_rn(-a, a)), one))))));
      break;
    case OP_SINH: ga = R(mul_rn(g, R(m_cosh(a)))); break;
    case OP_COSH: ga = R(mul_rn(g, R(m_sinh(a)))); break;
    case OP_ASINH:   // g * (a.pow(2) + 1).rsqrt()
      ga = R(mul_rn(g, R(m_rsqrt(R(add_rn(R(mul_rn(a, a)), one))))));
      break;
    case OP_ACOSH:   // g * (a.pow(2) - 1).rsqrt()
      ga = R(mul_rn(g, R(m_rsqrt(R(sub_rn(R(mul_rn(a, a)), one))))));
      break;
    case OP_ATANH:   // g * 1 / (1 - a.pow(2))
      ga = R(div_rn(R(mul_rn(g, one)), R(sub_rn(one, R(mul_rn(a, a))))));
      break;
    case OP_ERFC: {   // -2 / sqrt(pi) * exp(-(a.pow(2))) * g
      const F k = F(-2.0 / sqrt(kPi));
      ga = R(mul_rn(R(mul_rn(R(m_exp(-R(mul_rn(a, a)))), k)), g));
      break;
    }
    case OP_ERFINV: {   // 0.5 * sqrt(pi) * exp(a.erfinv().pow(2)) * g
      const F k = F(0.5 * sqrt(kPi));
      const F e = R(m_erfinv(a));
      ga = R(mul_rn(R(mul_rn(R(m_exp(R(mul_rn(e, e)))), k)), g));
      break;
    }
    case OP_LOG10:   // g / (a * ln 10)
      ga = R(div_rn(g, R(mul_rn(a, F(2.3025850929940456)))));
      break;
    case OP_XLOGY: {   // xlogy(g, b), 0 where a == 0 and b <= 0; g * a / b
      const F xl = (b != b) ? F(NAN)
                   : (g == zero ? zero : R(g * m_log(b)));
      ga = (a == zero && b <= zero) ? zero : xl;
      gb = R(div_rn(R(mul_rn(g, a)), b));
      break;
    }
    case OP_SINC: {
      const F pi = F(kPi);
      const F x_pi = R(mul_rn(a, pi));
      const F x2_pi = R(mul_rn(R(mul_rn(a, a)), pi));
      const F t = R(sub_rn(R(mul_rn(x_pi, R(m_cos(x_pi)))), R(m_sin(x_pi))));
      const F out = R(mul_rn(g, R(div_rn(t, x2_pi))));
      ga = (x2_pi == zero) ? zero : out;
      break;
    }
    default: break;   // rounding, tests of a value, casts: none
  }
  return Back<F>{ga, gb, gc};
}
__device__ __noinline__ Back<float> map_ext_back(int w, int rk, float a,
                                                 float b, float c, float d,
                                                 float y, float g,
                                                 const int* pool) {
  return map_ext_back_f(w, rk, a, b, c, d, y, g, pool);
}
__device__ __noinline__ Back<double> map_ext_back(int w, int rk, double a,
                                                  double b, double c,
                                                  double d, double y,
                                                  double g,
                                                  const int* pool) {
  return map_ext_back_f(w, rk, a, b, c, d, y, g, pool);
}

// The float formulas' rounding policy for a compute dtype chosen at run
// time (rk, kRk): map_back_step_f and map_op_back_f round with it.
__device__ __noinline__ Back<float> map_op_back_k(int rk, int w, float a,
                                                  float b, float c, float y,
                                                  float g, const int* pool);
struct RndK {
  int rk;
  __device__ __forceinline__ float operator()(float f) const {
    return rnd_k(f, rk);
  }
  __device__ __forceinline__ bool half() const { return rk != 0; }
  __device__ __forceinline__ float pow(float x, double e) const {
    return map_pow_rk(x, e, rk);
  }
  __device__ __forceinline__ Back<float> back(int w, float a, float b,
                                              float c, float y, float g,
                                              const int* pool) const {
    return map_op_back_k(rk, w, a, b, c, y, g, pool);
  }
};
__device__ __noinline__ Back<float> map_op_back_k(int rk, int w, float a,
                                                  float b, float c, float y,
                                                  float g, const int* pool) {
  return map_op_back_f(RndK{rk}, w, a, b, c, y, g, pool);
}

// ---------------------------------------------------------------------
// Typed tapes in K5 (tile_epilogue.cuh's typed path): the forward on
// words, then reverse mode with each slot's cotangent a word of the
// slot's own float type, summed in that type; a cast's cotangent is the
// cotangent cast back to its source type (between float types; none to
// or from an integer or bool), the other ops' as map_back_step gives them
// in the op's compute type.
// ---------------------------------------------------------------------
__device__ __forceinline__ bool float_ty(int t) {
  return t == TY_F32 || t == TY_BF16 || t == TY_F16 || t == TY_F64;
}
// The cotangents of typed op w in the float family (compute dtype of
// rounding rk: float32's formulas, each op rounded to the type) or in
// float64 (F double).
template <typename F>
__device__ __noinline__ Back<Word> typed_back_as(int rk, int w, int tw,
                                                 Word a, Word b, Word c,
                                                 Word y, Word g,
                                                 const int* pool) {
  F x[1] = {typed_arg<F>(w >> 8, tw, 0, a, pool)};
  F u[1] = {typed_arg<F>(w >> 16, tw, 1, b, pool)};
  F z[1] = {typed_arg<F>(w >> 24, tw, 2, c, pool)};
  F yv[1] = {word_as<F>(y)}, gv[1] = {word_as<F>(g)};
  const int op = w & 0x7F;
  if (op > OP_SIGNBIT || ((op == OP_REM || op == OP_FMOD) &&
                          !(((w >> 16) & 0xC0) == kOpndConst))) {
    // the ops past the list (d: addcmul's and addcdiv's value), and
    // remainder and fmod by a value
    const Back<F> r = map_ext_back(w, rk, x[0], u[0], z[0],
                                   fourth<F>(tw, pool),
                                   yv[0], gv[0], pool);
    return Back<Word>{as_word(r.a), as_word(r.b), as_word(r.c)};
  }
  F ga[1], gb[1], gc[1];
  if constexpr (std::is_same_v<F, double>)
    map_back_step<double>(w, x, u, z, yv, gv, ga, gb, gc, pool);
  else
    map_back_step_f<1>(RndK{rk}, w, x, u, z, yv, gv, ga, gb, gc, pool);
  return Back<Word>{as_word(ga[0]), as_word(gb[0]), as_word(gc[0])};
}
__device__ __noinline__ Back<Word> typed_back(int w, int tw, Word a, Word b,
                                              Word c, Word y, Word g,
                                              const int* pool) {
  const int rt = tw & 0xF, ct = (tw >> 4) & 0xF;
  if ((w & 0x7F) == OP_CAST)
    return Back<Word>{float_ty(rt) && float_ty(ct) ? cast_word(g, rt, ct)
                                                   : Word(0), 0, 0};
  switch (ct) {
    case TY_F32:
    case TY_BF16:
    case TY_F16:
      return typed_back_as<float>(rk_of(ct), w, tw, a, b, c, y, g, pool);
    case TY_F64: return typed_back_as<double>(0, w, tw, a, b, c, y, g, pool);
    default: return Back<Word>{0, 0, 0};
  }
}
// cotangents x + y summed in float type t (a half float rounded once)
__device__ __noinline__ Word typed_sum(int t, Word x, Word y) {
  switch (t) {
    case TY_F64:
      return as_word(__dadd_rn(word_as<double>(x), word_as<double>(y)));
    case TY_BF16:
      return as_word(rnd<Bf16>(__fadd_rn(word_as<float>(x), word_as<float>(y))));
    case TY_F16:
      return as_word(rnd<F16>(__fadd_rn(word_as<float>(x), word_as<float>(y))));
    default: return as_word(__fadd_rn(word_as<float>(x), word_as<float>(y)));
  }
}

// map_vjp_regs for a typed tape on words: u the map's inputs, ct the
// cotangents (the map's dtype t0), replaced by the inputs' cotangents.
template <int KR>
__device__ __noinline__ void map_vjp_typed(const int* tape, int n, int t0,
                                           const Word (&u)[KR],
                                           Word (&ct)[KR]) {
  const unsigned gmask = (unsigned)tape[0];
  const int* ops = tape + 1;
  const int* tys = ops + n;
  const int* pool = tys + n;
  Word vals[kTapeMax + 1][KR], adj[kTapeMax + 1][KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) vals[0][i] = u[i];
  for (int s = 0; s < n; ++s) {
    const int w = ops[s], tw = tys[s];
    const int da = (w >> 8) & 0xFF, db = (w >> 16) & 0xFF;
    const int dc = (w >> 24) & 0xFF;
#pragma unroll
    for (int i = 0; i < KR; ++i)
      vals[s + 1][i] = typed_op(w, tw, (da & 0xC0) ? 0 : vals[da][i],
                                (db & 0xC0) ? 0 : vals[db][i],
                                (dc & 0xC0) ? 0 : vals[dc][i], pool);
  }
  for (int k = 0; k < n; ++k) {   // -0 of each slot's type: -0 + x == x
    const int t = k == 0 ? t0 : tys[k - 1] & 0xF;
    const Word nz = t == TY_F64 ? 0x8000000000000000ull : 0x80000000ull;
#pragma unroll
    for (int i = 0; i < KR; ++i) adj[k][i] = nz;
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) adj[n][i] = ct[i];
  for (int s = n - 1; s >= 0; --s) {
    if (!((gmask >> s) & 1u)) continue;
    const int w = ops[s], tw = tys[s], op = w & 0x7F, t = (tw >> 4) & 0xF;
    const int da = (w >> 8) & 0xFF, db = (w >> 16) & 0xFF;
    const int dc = (w >> 24) & 0xFF;
    const bool to_a = op != OP_WHERE && !(da & 0xC0) && !((tw >> 8) & 1);
    const bool to_b = !(db & 0xC0) && !((tw >> 9) & 1);
    const bool to_c = (op == OP_WHERE || op == OP_ADDCMUL ||
                       op == OP_ADDCDIV) && !(dc & 0xC0) && !((tw >> 10) & 1);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const Back<Word> r = typed_back(
          w, tw, (da & 0xC0) ? 0 : vals[da][i], (db & 0xC0) ? 0 : vals[db][i],
          (dc & 0xC0) ? 0 : vals[dc][i], vals[s + 1][i], adj[s + 1][i], pool);
      if (to_a) adj[da][i] = typed_sum(t, adj[da][i], r.a);
      if (to_b) adj[db][i] = typed_sum(t, adj[db][i], r.b);
      if (to_c) adj[dc][i] = typed_sum(t, adj[dc][i], r.c);
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) ct[i] = adj[0][i];
}
// map_vjp_regs for a typed tape: the registers as words and back.
template <int KR, typename T>
__device__ __noinline__ void map_vjp_of_typed(const int* tape, int n,
                                              T (&ct)[KR], const T* at) {
  Word u[KR], g[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    u[i] = to_word(at[i * REPRO_THREADS]);
    g[i] = to_word(ct[i]);
  }
  map_vjp_typed<KR>(tape, n, kTypeOf<T>, u, g);
#pragma unroll
  for (int i = 0; i < KR; ++i) from_word(g[i], ct[i]);
}


// K5 on a float-family tape (map_regs_mixed): the structure of
// map_vjp_regs on float registers; each op's formulas rounded to its own
// compute dtype (RndK: map_back_step's and map_op_back's float code with
// the rounding chosen at run time), a cast's cotangent rounded back to its
// source's type, the ops past the list through map_ext_back, a slot's
// cotangents summed in its type.
template <int KR, typename T>
__device__ __noinline__ void map_vjp_mixed(const int* tape, int n,
                                           T (&ct)[KR], const T* at) {
  const unsigned gmask = (unsigned)tape[0];
  const int* ops = tape + 1;
  const int* tys = ops + n;
  const int* pool = tys + n;
  float vals[kTapeMax + 1][KR], adj[kTapeMax + 1][KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) vals[0][i] = widen(at[i * REPRO_THREADS]);
  for (int s = 0; s < n; ++s) {
    const int w = ops[s];
    float a[KR], b[KR], c[KR];
    tape_args((w >> 8) & 0xFF, vals, pool, a);
    tape_args((w >> 16) & 0xFF, vals, pool, b);
    tape_args((w >> 24) & 0xFF, vals, pool, c);
    mixed_step(w, tys[s], a, b, c, vals[s + 1], pool);
  }
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int i = 0; i < KR; ++i) adj[k][i] = -0.0f;   // -0 + x == x
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) adj[n][i] = widen(ct[i]);
  for (int s = n - 1; s >= 0; --s) {
    if (!((gmask >> s) & 1u)) continue;
    const int w = ops[s], tw = tys[s], op = w & 0x7F;
    const int rk = rk_of((tw >> 4) & 0xF);
    const int da = (w >> 8) & 0xFF, db = (w >> 16) & 0xFF;
    const int dc = (w >> 24) & 0xFF;
    float a[KR], b[KR], c[KR], ga[KR], gb[KR], gc[KR];
    tape_args(da, vals, pool, a);
    tape_args(db, vals, pool, b);
    tape_args(dc, vals, pool, c);
    if (op == OP_CAST) {   // the cotangent cast back to the source's type
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        ga[i] = rnd_k(adj[s + 1][i], rk);
        gb[i] = gc[i] = 0.0f;
      }
    } else if (op > OP_SIGNBIT ||
               ((op == OP_REM || op == OP_FMOD) &&
                ((w >> 16) & 0xC0) != kOpndConst)) {
      const float d = fourth<float>(tw, pool);
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const Back<float> r = map_ext_back(w, rk, a[i], b[i], c[i], d,
                                           vals[s + 1][i], adj[s + 1][i],
                                           pool);
        ga[i] = r.a;
        gb[i] = r.b;
        gc[i] = r.c;
      }
    } else {
      map_back_step_f<KR>(RndK{rk}, w, a, b, c, vals[s + 1], adj[s + 1], ga,
                          gb, gc, pool);
    }
    const bool to_a = op != OP_WHERE && !(da & 0xC0);
    const bool to_b = !(db & 0xC0);
    const bool to_c = (op == OP_WHERE || op == OP_ADDCMUL ||
                       op == OP_ADDCDIV) && !(dc & 0xC0);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      if (to_a) adj[da][i] = rnd_k(__fadd_rn(adj[da][i], ga[i]), rk);
      if (to_b) adj[db][i] = rnd_k(__fadd_rn(adj[db][i], gb[i]), rk);
      if (to_c) adj[dc][i] = rnd_k(__fadd_rn(adj[dc][i], gc[i]), rk);
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) narrow_to(adj[0][i], ct[i]);
}
#endif  // REPRO_MAP_EXT

// The transposed map (its tape's words at tape, n ops) on the cotangent
// registers ct, `at` the map's input values the replay kept (map_save_at):
// the tape once forward, op by op on every register, keeping every slot's
// values, then reverse mode over the ops whose backward autograd runs
// (the tape's gradient mask), last first, each slot's cotangents summed in
// that order (autograd's engine runs the ops of a graph in that order and
// sums what a tensor receives as it arrives). Out of line: one copy of its
// code a kernel, not one a planar value (the slot values live in a
// per-thread array either way).
template <int KR, typename T>
__device__ __noinline__ void map_vjp_regs(const int* tape, int n,
                                             T (&ct)[KR], const T* at) {
  using F = typename MapOf<T>::type;   // float, or double for float64
  if (n == 0) return;
  const unsigned gmask = (unsigned)tape[0];
  const int* ops = tape + 1;
  const int* pool = ops + n;
  F vals[kTapeMax + 1][KR], adj[kTapeMax + 1][KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) vals[0][i] = widen(at[i * REPRO_THREADS]);
  for (int s = 0; s < n; ++s) {
    const int w = ops[s];
    F a[KR], b[KR], c[KR];
    tape_args((w >> 8) & 0xFF, vals, pool, a);
    tape_args((w >> 16) & 0xFF, vals, pool, b);
    tape_args((w >> 24) & 0xFF, vals, pool, c);
    map_step<T>(w, a, b, c, vals[s + 1], pool);
  }
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int i = 0; i < KR; ++i) adj[k][i] = -F(0);   // -0 + x == x
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) adj[n][i] = widen(ct[i]);
  for (int s = n - 1; s >= 0; --s) {
    if (!((gmask >> s) & 1u)) continue;
    const int w = ops[s];
    const int da = (w >> 8) & 0xFF, db = (w >> 16) & 0xFF;
    const int dc = (w >> 24) & 0xFF;
    F a[KR], b[KR], c[KR], ga[KR], gb[KR], gc[KR];
    tape_args(da, vals, pool, a);
    tape_args(db, vals, pool, b);
    tape_args(dc, vals, pool, c);
    map_back_step<T>(w, a, b, c, vals[s + 1], adj[s + 1], ga, gb, gc, pool);
    const bool where = (w & 0x7F) == OP_WHERE;   // no cotangent for c
    if (!where && (da & 0xC0) == 0) {
#pragma unroll
      for (int i = 0; i < KR; ++i) adj[da][i] = ct_sum<T>(adj[da][i], ga[i]);
    }
    if ((db & 0xC0) == 0) {
#pragma unroll
      for (int i = 0; i < KR; ++i) adj[db][i] = ct_sum<T>(adj[db][i], gb[i]);
    }
    if (where && (dc & 0xC0) == 0) {
#pragma unroll
      for (int i = 0; i < KR; ++i) adj[dc][i] = ct_sum<T>(adj[dc][i], gc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) narrow_to(adj[0][i], ct[i]);
}

// The input values of map epilogue e, recomputed from those kept for map
// `from` (the nearest map before it in its phase that keeps them): the
// replay's epilogues from .. e - 1 run on them, as the replay ran them,
// into e's slot (the spare one). Out of line, so the replay's code is one
// copy more, not one a map.
template <int DV, int KR, typename T>
__device__ __noinline__ void recompute_map_input(const int* sp,
                                                 const long long* gp,
                                                 int ebase, int from, int e,
                                                 T* save, unsigned qb,
                                                 unsigned chunk,
                                                 int outer_bits) {
  T u[DV][KR];
  unsigned m[DV][KR];   // no compare bits are kept
  const int* fe = sp + ebase + from * kEpiWords;
  const int* ee = sp + ebase + e * kEpiWords;
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    const T* at = map_save_at<KR>(save, fe[EP_MAP_SLOT] * DV + c, chunk,
                                  outer_bits);
#pragma unroll
    for (int i = 0; i < KR; ++i) u[c][i] = at[i * REPRO_THREADS];
  }
  run_epilogues<false, true, true>(sp, gp, ebase, from, e, true, u, m, qb,
                                   chunk, outer_bits, (T*)nullptr);
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    T* at = map_save_at<KR>(save, ee[EP_MAP_SLOT] * DV + c, chunk,
                            outer_bits);
#pragma unroll
    for (int i = 0; i < KR; ++i) at[i * REPRO_THREADS] = u[c][i];
  }
}

// The transpose of epilogue e (staged plan sp, device plan gp, records
// from word ebase) on the cotangent registers (see step 4); `save` holds
// the maps' inputs.
template <bool kCmp, bool kMaps, int DV, int KR, typename T>
__device__ __forceinline__ void transposed_epilogue(
    const int* sp, const long long* gp, int ebase, int e, T (&v)[DV][KR],
    const unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits, T* save) {
  const int* ep = sp + ebase + e * kEpiWords;
  const long long* gep = gp + ebase + e * kEpiWords;
  if constexpr (kMaps) {
    if (ep[EP_KIND] == kKindMap) {
      if (ep[EP_MAP_FROM] >= 0)
        recompute_map_input<DV, KR>(sp, gp, ebase, ep[EP_MAP_FROM], e, save,
                                    qb, chunk, outer_bits);
      const int* tape = sp + ep[EP_MAP_TAPE];
#ifdef REPRO_MAP_EXT
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const T* at = map_save_at<KR>(save, ep[EP_MAP_SLOT] * DV + c, chunk,
                                      outer_bits);
        if constexpr (!std::is_same_v<T, double>) {
          if (ep[EP_MAP_TYPED] == 2) {
            map_vjp_mixed(tape, ep[EP_MAP_LEN], v[c], at);
            continue;
          }
        }
        if (ep[EP_MAP_TYPED])
          map_vjp_of_typed(tape, ep[EP_MAP_LEN], v[c], at);
        else
          map_vjp_regs(tape, ep[EP_MAP_LEN], v[c], at);
      }
#else
#pragma unroll
      for (int c = 0; c < DV; ++c)
        map_vjp_regs(tape, ep[EP_MAP_LEN], v[c],
                     map_save_at<KR>(save, ep[EP_MAP_SLOT] * DV + c, chunk,
                                     outer_bits));
#endif
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
      using TW = typename TwOf<T>::type;
      const TW* w = reinterpret_cast<const TW*>(__ldg(gep + EP_W));
      unsigned tw[KR];
      tw_index(ep, tw_thread(ep, chunk, outer_bits), tw);
      REPRO_VREG_SWITCH(vreg, (tr_bfly_regs<VR>(v, hi_bits(ep, qb), vlane, w,
                                                tw)))
    }
  }
}

// Make the compare-bit words of set `sid` (group * chunks + chunk) the
// ones in registers, m. With `spill` (more than two sets) the words of the
// other sets wait in shared memory, one word per set, tail value, register
// and thread; with two sets or one, the other set waits in registers
// (alt), swapped with m. A set's first phase starts from zeros.
template <int DV, int KR>
__device__ __forceinline__ void use_masks(unsigned (&m)[DV][KR],
                                          unsigned (&alt)[DV][KR], int& cur,
                                          int sid, bool fresh,
                                          unsigned* spill) {
  if (sid == cur) return;
  if (spill != nullptr) {
    if (cur >= 0) {
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
  } else {
#pragma unroll
    for (int c = 0; c < DV; ++c)
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const unsigned w = alt[c][i];
        alt[c][i] = m[c][i];
        m[c][i] = fresh ? 0u : w;
      }
  }
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

// The replay and the transposed sweep of one work item on its tiles (x in
// tv, ct as loaded in cv; the result left in tv), from the staged plan sp
// (device plan gp). kCmp: the cluster has compares (their bits in m, and
// a second set in alt); kMaps: it has maps, `save` the room for their
// inputs. The replay needs x alone: the cotangent's copies are waited for
// (all but `ct_pending` of the thread's newest commit groups) only before
// the first transposed phase, so they land under the replay.
template <typename T, int DV, int KR, bool kCmp, bool kMaps>
__device__ __forceinline__ void bwd_phases(const TileView& tv,
                                           const TileView& cv, const int* sp,
                                           const long long* gp, int d,
                                           const int* __restrict__ inv_src0,
                                           const int* s_xl, int rpt_shift,
                                           unsigned* spill, T* save,
                                           int ct_pending) {
  const int n_phases = sp[0], outer_bits = sp[2];
  const unsigned chunks = 1u << outer_bits;
  const int* phases = sp + kHdrWords;
  const int ebase = kHdrWords + n_phases * kPhaseWords;
  T v[DV][KR];
  unsigned m[DV][KR], alt[DV][KR];
#pragma unroll
  for (int c = 0; c < DV; ++c)
#pragma unroll
    for (int i = 0; i < KR; ++i) alt[c][i] = 0u;
  for (int k = 0; k < d; k += DV) {
    int cur = -1;
    // replay, keeping the compare bits
    for (int p = 0; p < n_phases; ++p) {
      __syncthreads();  // the x tile (or the previous phase) complete
      const int* ph = phases + p * kPhaseWords;
      const PhaseRegs pr(ph);
      const int group = ph[PH_GROUP];
      const bool first = ph[PH_FIRST] != 0;
      for (unsigned c = 0; c < chunks; ++c) {
        const unsigned qb = pr.qt ^ image_of(ph + PH_IMG_OUT, c, outer_bits);
        if (kCmp && group >= 0)
          use_masks<DV>(m, alt, cur, group * (int)chunks + (int)c, first,
                        spill);
        load_regs<DV, true>(v, tv, qb, pr.qr, pr.valid, k);
        phase_epilogues<kCmp, kMaps, true>(ph, sp, gp, ebase, v, m, qb, c,
                                           outer_bits, save);
        if (p + 1 < n_phases)
          store_regs<DV, true>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
    cp_async_wait_n(ct_pending);
    // the transposed epilogues, last phase first; the last phase's
    // positions are the replay's own, and it reads the cotangent through
    // the un-gather
    for (int p = n_phases - 1; p >= 0; --p) {
      __syncthreads();  // the ct tile landed (or the previous phase)
      const int* ph = phases + p * kPhaseWords;
      const PhaseRegs pr(ph);
      const int e0 = ph[PH_E0], e1 = ph[PH_E1], group = ph[PH_GROUP];
      for (unsigned c = 0; c < chunks; ++c) {
        const unsigned qb = pr.qt ^ image_of(ph + PH_IMG_OUT, c, outer_bits);
        if (kCmp && group >= 0)
          use_masks<DV>(m, alt, cur, group * (int)chunks + (int)c, false,
                        spill);
        if (p + 1 == n_phases)
          load_ungathered<DV>(v, cv, qb, pr.qr, pr.valid, k, inv_src0, s_xl,
                              rpt_shift);
        else
          load_regs<DV, true>(v, tv, qb, pr.qr, pr.valid, k);
        for (int e = e1 - 1; e >= e0; --e)
          transposed_epilogue<kCmp, kMaps>(sp, gp, ebase, e, v, m, qb, c,
                                           outer_bits, save);
        store_regs<DV, true>(v, tv, qb, pr.qr, pr.valid, k);
      }
    }
  }
}

// A block of K5: `groups` work items (k5_schedule), `n_buf` of them in
// flight, each in an x tile and a ct tile.
template <typename T, int DV, int KR, bool kCmp, bool kMaps, int MB>
__global__ void __launch_bounds__(REPRO_THREADS, MB)
tile_bwd_kernel(const typename ElemWord<T>::type* __restrict__ x,
                const typename ElemWord<T>::type* __restrict__ ct,
                typename ElemWord<T>::type* __restrict__ out,
                const EpiTileArgs a) {
  using W = typename ElemWord<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = a.per_cta << a.rpt_shift;      // tile rows of an item
  const int rows_shift = a.per_cta_shift + a.rpt_shift;
  const unsigned row_words = (1u << a.t) * (unsigned)a.wpe;
  const unsigned span = (unsigned)rows * row_words;
  const unsigned stride = (unsigned)a.stride;
  const long long batch_words = (long long)a.n_rows * row_words;
  const ItemTables s = carve_items(smem, a, rows);
  const size_t tb = item_tile_bytes(rows, a.stride, (int)sizeof(W));
  unsigned char* after = s.tiles + 2 * (size_t)a.n_buf * tb;
  unsigned* spill = a.n_spill ? reinterpret_cast<unsigned*>(after) : nullptr;
  T* save = nullptr;
  if constexpr (kMaps)
    save = reinterpret_cast<T*>(after + (size_t)a.n_spill * DV * KR *
                                            REPRO_THREADS * 4);
  const long long w0 = (long long)blockIdx.x * a.groups;
  const int nw = (int)min((long long)a.groups, a.n_work - w0);
  stage_items(s, a, w0, nw, rows, rows_shift, batch_words);
  __syncthreads();

  // item k's x tile and ct tile
  auto xt = [&](int k) {
    return s.tiles + (a.n_buf > 1 && (k & 1) ? 2 * tb : 0);
  };
  // its x rows, then its ct rows: two commit groups
  auto load = [&](int k) {
    load_item_rows(reinterpret_cast<W*>(xt(k)), x + s.base[k],
                   s.in + (k << rows_shift), span, row_words, a.row_shift,
                   stride, a.vec);
    load_item_rows(reinterpret_cast<W*>(xt(k) + tb), ct + s.base[k],
                   s.out + (k << rows_shift), span, row_words, a.row_shift,
                   stride, a.vec);
  };
  load(0);
  if (a.n_buf > 1 && nw > 1) load(1);
  const TileView tv0{xt(0), stride * (unsigned)sizeof(W),
                     (unsigned)a.wpe * (unsigned)sizeof(W),
                     (1u << a.t) - 1, a.t};
  for (int k = 0; k < nw; ++k) {
    const bool next = a.n_buf > 1 && k + 1 < nw;   // item k + 1 in flight
    cp_async_wait_n(next ? 3 : 1);                 // item k's x rows
    use_item_bases(s, k, a.n_epi);
    TileView tv = tv0, cv = tv0;
    tv.bytes = xt(k);
    cv.bytes = xt(k) + tb;
    bwd_phases<T, DV, KR, kCmp, kMaps>(
        tv, cv, s.plan, a.plan, a.d, a.src0, s.xl + (k << a.per_cta_shift),
        a.rpt_shift, spill, save, next ? 2 : 0);
    __syncthreads();
    // whole rows back where the forward read them
    copy_out_item(out + s.base[k], reinterpret_cast<const W*>(tv.bytes),
                  s.in + (k << rows_shift), span, row_words, a.row_shift,
                  stride, a.vec);
    if (k + a.n_buf < nw) {
      __syncthreads();   // every thread is done with the item's tiles
      load(k + a.n_buf);
    }
  }
}

template <typename T, int DV, int KR, bool kCmp, bool kMaps, int MB>
static int launch_bwd(const void* x, const void* ct, void* out,
                      const EpiTileArgs& a, cudaStream_t s) {
  using W = typename ElemWord<T>::type;
  if (a.word_bytes != (int)sizeof(W)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(tile_bwd_kernel<T, DV, KR, kCmp, kMaps, MB>,
                             (size_t)a.smem);
  if (e != cudaSuccess) return (int)e;
  tile_bwd_kernel<T, DV, KR, kCmp, kMaps, MB>
      <<<(unsigned)a.grid, REPRO_THREADS, (size_t)a.smem, s>>>(
          (const W*)x, (const W*)ct, (W*)out, a);
  return (int)cudaGetLastError();
}

// Blocks per SM of K5 on float64: compares on single values, and planar
// butterflies. The fastest of a sweep on the H100 (tools/fused_ab.py
// --wide; PERF.md; device ms): the largest 2^24 sort cluster at 2 / 3 / 4
// blocks an SM 0.5630 / 0.5030 / 0.5225 (80 registers and 48 bytes of
// spills at 3); the 2^22 FFT's planar cluster at 1 / 2 / 3 0.4447 /
// 0.3237 / 0.4320 (128 registers, no spills at 2).
#define REPRO_MB_BWD_F64 3
#define REPRO_MB_BWD_F64_PLANAR 2

#ifndef REPRO_NO_EPI_ENTRY_POINTS   // as in tile_fused.cu

#ifdef REPRO_MAP_EXT
// An ext library's map kernel of class T with DV values a register slot:
// instantiated in the library of its part (kExtPart, REPRO_MAP_EXT = 1
// to 4), refused in the others.
template <typename T, int DV, bool kCmp, int MB>
static int launch_bwd_ext(const void* x, const void* ct, void* out,
                          const EpiTileArgs& a, cudaStream_t s) {
  if constexpr (kExtPart<T, DV> == REPRO_MAP_EXT)
    return launch_bwd<T, DV, 8, kCmp, true, MB>(x, ct, out, a, s);
  else
    return (int)cudaErrorInvalidValue;
}
#endif

// One K5 launch under the schedule *a (EpiTileArgs; k5_schedule in
// bmmc_permute.py): elem_type 1 = float32, 2 = bfloat16, 3 = float16, 11
// = float64 (integers have no gradient); dv as in repro_tile_fused; 8
// registers a
// thread (its compare bits sit beside its values); has_cmp: the cluster
// has compares (dv 1, and a planar cluster with maps, take the compare
// variant either way: a cluster of maps alone has no compare bits to
// keep); n_spill: compare-bit sets kept in shared memory (0: one or two
// sets, all in registers); n_map_sets: maps times chunks times dv, the
// sets of map inputs kept in shared memory.
extern "C" int repro_tile_bwd(const void* x, void* out, const void* ct,
                              const EpiTileArgs* a, void* stream) {
  if (a == nullptr || a->grid <= 0 || a->n_work <= 0 || a->batch <= 0 ||
      a->n_rows <= 0 || a->t < 0 || a->rpt_shift < 0 || a->wpe <= 0 ||
      a->per_cta <= 0 || a->groups <= 0 || a->n_groups <= 0 ||
      (a->n_buf != 1 && a->n_buf != 2) || a->d <= 0 || a->n_spill < 0 ||
      a->n_map_sets < 0 || a->plan == nullptr || a->n_words < kHdrWords ||
      a->n_epi < 0 || a->regs != 8 ||
      !(a->elem_type == 11 || (a->elem_type >= 1 && a->elem_type <= 3)) ||
      (a->dv == 2 && a->d != 2) ||
      (a->vec && a->wpe != a->dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(T, DV, CMP, MAPS, MB) REPRO_BWD_##MAPS(T, DV, CMP, MB)
#define REPRO_BWD_true(T, DV, CMP, MB) \
  return launch_bwd<T, DV, 8, CMP, true, MB>(x, ct, out, *a, s)
#ifdef REPRO_MAP_EXT   // an ext library holds its part's map kernels only
#undef REPRO_BWD_true
#define REPRO_BWD_true(T, DV, CMP, MB) \
  return launch_bwd_ext<T, DV, CMP, MB>(x, ct, out, *a, s)
#define REPRO_BWD_false(T, DV, CMP, MB) return (int)cudaErrorInvalidValue
#else
#define REPRO_BWD_false(T, DV, CMP, MB) \
  return launch_bwd<T, DV, 8, CMP, false, MB>(x, ct, out, *a, s)
#endif
  // the last argument: blocks per SM, the fastest of a sweep on the H100
  // (tools/fused_ab.py; PERF.md): compares at 4 (float32, 64 registers)
  // and 3 (bfloat16, 80) ran faster than at 3 and 2, with no spills
  // (float16 takes bfloat16's)
  if (a->dv == 2) {
#define REPRO_PLANAR(T)                                     \
  if (a->n_map_sets) REPRO_BWD(T, 2, true, true, 2);        \
  if (a->has_cmp) REPRO_BWD(T, 2, true, false, 2);          \
  REPRO_BWD(T, 2, false, false, 3);                         \
  break
    switch (a->elem_type) {
      case 1: REPRO_PLANAR(float);
      case 2: REPRO_PLANAR(Bf16);
      case 3: REPRO_PLANAR(F16);
      case 11:   // float64: its own blocks per SM
        if (a->n_map_sets) REPRO_BWD(double, 2, true, true, 2);
        if (a->has_cmp) REPRO_BWD(double, 2, true, false, 2);
        REPRO_BWD(double, 2, false, false, REPRO_MB_BWD_F64_PLANAR);
      default: break;
    }
#undef REPRO_PLANAR
    return (int)cudaErrorInvalidValue;
  }
  if (a->dv != 1) return (int)cudaErrorInvalidValue;
  if (a->n_map_sets) {   // 2 blocks an SM: the map code spills at 3
    if (a->elem_type == 1) REPRO_BWD(float, 1, true, true, 2);
    if (a->elem_type == 2) REPRO_BWD(Bf16, 1, true, true, 2);
    if (a->elem_type == 3) REPRO_BWD(F16, 1, true, true, 2);
    if (a->elem_type == 11) REPRO_BWD(double, 1, true, true, 2);
    return (int)cudaErrorInvalidValue;
  }
  if (a->elem_type == 1) REPRO_BWD(float, 1, true, false, 4);
  if (a->elem_type == 2) REPRO_BWD(Bf16, 1, true, false, 3);
  if (a->elem_type == 3) REPRO_BWD(F16, 1, true, false, 3);
  if (a->elem_type == 11) REPRO_BWD(double, 1, true, false, REPRO_MB_BWD_F64);
  return (int)cudaErrorInvalidValue;
#undef REPRO_BWD
#undef REPRO_BWD_true
#undef REPRO_BWD_false
}

#endif  // REPRO_NO_EPI_ENTRY_POINTS
