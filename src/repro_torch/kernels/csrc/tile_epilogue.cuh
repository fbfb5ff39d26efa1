// The compute epilogues of a fused tiled pass, run in registers, shared by
// K4b (tile_fused.cu), which applies them on the way out of a tile, and K5
// (tile_bwd.cu), which replays them on the saved input to recover the
// compare bits of its transposed compares. One copy of this code is what
// makes the replay bit-equal to the forward pass.
//
// What bounds the epilogues on the H100 is instructions and latency, not
// bytes: a 2^24-element pass moves 128 MiB in about 0.06 ms, and each
// epilogue adds a few operations per element (PERF.md, PR 14). The design
// keeps the count small and the data in registers:
//   * layout: the host (epilogue_plan.py) splits a block's 2^B tile
//     positions into KR = 16 (or 8) register positions a thread, 5 lane
//     bits, 3 warp bits and, past 2^12 (2^11) positions, outer bits run
//     as chunks; a run of epilogues (a phase) whose partner XORs lie in
//     the register and lane bits runs on registers, and only a new phase
//     passes through the shared-memory tile, behind one barrier;
//   * partners: the XOR's register part selects the partner register at
//     compile time (one case per value: the array never goes to local
//     memory), its lane part is one __shfl_xor_sync per element;
//   * no tables: hi(q) is the parity of q & hmask XOR hi_base[g0], so a
//     thread takes the hi bits of all its registers from one word and one
//     popc; a butterfly's twiddle index is a GF(2) product over the
//     position bits (images in the plan) XOR tw_base[g0]; the plan itself
//     is staged in shared memory once per block, hi_base[g0] and
//     tw_base[g0] in it (g0 the first tile of the block, or, in the
//     work-item kernels, of the work item whose phases run:
//     tile_items.cuh stages every item's entries and puts each item's in
//     the plan before its phases);
//   * every position computes its own output (no pair owner): cmp as
//     hi ? max(self, partner) : min(self, partner), the butterfly from its
//     own and its partner's values;
//   * floats compare as integer keys (the float order, -0 < +0) in every
//     warp whose values hold no NaN, so a float32, bfloat16 or float16
//     compare costs what an int32 one does (float64 as a 64-bit key); a
//     warp with a NaN takes the float selects. Integers of 8 to 64 bits
//     (signed or unsigned; bool is uint8) always compare as int keys. NaN,
//     -0 and the no-FMA rounding are exactly those of cmp_max, cmp_min and
//     the butterfly in bmmc_permute.py; a bfloat16 or float16 butterfly
//     computes each product and sum in float and rounds it to its type, a
//     float64 one in double;
//   * a map (an element-wise torch function, map_lower.py) runs in the
//     thread on each register as a tape of ops, uniform over the block.
//     A map can make NaNs or move keys, so a phase that holds maps runs
//     its compares in runs between them, each with its own NaN vote and
//     keys, and each map on the values themselves (beside butterflies, on
//     both planar values of a register slot).
//
// Element types: the kernels are instantiated by storage width and
// compare class, not by dtype: I64, U64, double (8 bytes), int, U32 (4),
// I16, U16 (2), I8, U8 (1; bool), float and the half floats Bf16 and F16
// (2, computed through float).
//
// The plan is int64 words in device memory: a header (phases, epilogues,
// outer bits, register bits), then one record per phase and one per
// epilogue, with the offsets below (kept equal to epilogue_plan.py), then
// the maps' tapes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "words.cuh"

struct Bf16 {   // bfloat16 as its bits; compared through float
  uint16_t bits;
};
struct F16 {    // float16 as its bits; compared through float
  uint16_t bits;
};
// Integers as their storage; compared and mapped as int (U32 with its
// sign bit flipped for compares, unsigned in a map's ops)
struct I8 {
  int8_t v;
};
struct U8 {
  uint8_t v;
};
struct I16 {
  int16_t v;
};
struct U16 {
  uint16_t v;
};
struct U32 {
  uint32_t v;
};
struct I64 {
  long long v;
};
struct U64 {
  unsigned long long v;
};

template <typename T>
inline constexpr bool kHalf =
    std::is_same_v<T, Bf16> || std::is_same_v<T, F16>;
template <typename T>
inline constexpr bool kFloatElem =
    std::is_same_v<T, float> || std::is_same_v<T, double> || kHalf<T>;
// The 8-byte classes: 64-bit compare keys, maps on 64-bit values.
template <typename T>
inline constexpr bool kWide = std::is_same_v<T, I64> ||
                              std::is_same_v<T, U64> ||
                              std::is_same_v<T, double>;

__device__ __forceinline__ float as_float(Bf16 v) {
  return __uint_as_float((unsigned)v.bits << 16);
}
__device__ __forceinline__ float as_float(F16 v) {
  return __half2float(__ushort_as_half(v.bits));
}
__device__ __forceinline__ float as_float(float v) { return v; }

__device__ __forceinline__ Bf16 round_bf16(float f) {
  // round to nearest even, as PyTorch rounds float to bfloat16 on the
  // card (__float2bfloat16: a NaN becomes 0x7FFF)
  return Bf16{__bfloat16_as_ushort(__float2bfloat16(f))};
}
__device__ __forceinline__ F16 round_f16(float f) {
  // round to nearest even, as PyTorch rounds float to float16 on the card
  return F16{__half_as_ushort(__float2half_rn(f))};
}

// The compare-exchange output of a position: hi ? max(a, b) : min(a, b)
// with a the position's value and b its partner's. Floats, as selects:
// NaN first (a, then b), then the strict winner, then equal values' AND
// (max: max(-0, +0) = +0) or OR (min) — cmp_max / cmp_min in
// bmmc_permute.py.
__device__ __forceinline__ int cmp_sel(bool hi, int a, int b) {
  return hi ? (a > b ? a : b) : (a < b ? a : b);
}
__device__ __forceinline__ long long cmp_sel(bool hi, long long a,
                                             long long b) {
  return hi ? (a > b ? a : b) : (a < b ? a : b);
}
__device__ __forceinline__ double cmp_sel(bool hi, double a, double b) {
  const long long ia = __double_as_longlong(a), ib = __double_as_longlong(b);
  const bool a_wins = hi ? (a > b) : (a < b);
  const bool b_wins = hi ? (b > a) : (b < a);
  double r = __longlong_as_double(hi ? (ia & ib) : (ia | ib));
  r = b_wins ? b : r;
  r = a_wins ? a : r;
  r = (b != b) ? b : r;
  return (a != a) ? a : r;
}
__device__ __forceinline__ float cmp_sel(bool hi, float a, float b) {
  const int ia = __float_as_int(a), ib = __float_as_int(b);
  const bool a_wins = hi ? (a > b) : (a < b);
  const bool b_wins = hi ? (b > a) : (b < a);
  float r = __int_as_float(hi ? (ia & ib) : (ia | ib));
  r = b_wins ? b : r;
  r = a_wins ? a : r;
  r = (b != b) ? b : r;
  return (a != a) ? a : r;
}
__device__ __forceinline__ Bf16 cmp_sel(bool hi, Bf16 a, Bf16 b) {
  const float fa = as_float(a), fb = as_float(b);
  const bool a_wins = hi ? (fa > fb) : (fa < fb);
  const bool b_wins = hi ? (fb > fa) : (fb < fa);
  uint16_t r = hi ? (uint16_t)(a.bits & b.bits) : (uint16_t)(a.bits | b.bits);
  r = b_wins ? b.bits : r;
  r = a_wins ? a.bits : r;
  r = (fb != fb) ? b.bits : r;
  return Bf16{(fa != fa) ? a.bits : r};
}
__device__ __forceinline__ F16 cmp_sel(bool hi, F16 a, F16 b) {
  const float fa = as_float(a), fb = as_float(b);
  const bool a_wins = hi ? (fa > fb) : (fa < fb);
  const bool b_wins = hi ? (fb > fa) : (fb < fa);
  uint16_t r = hi ? (uint16_t)(a.bits & b.bits) : (uint16_t)(a.bits | b.bits);
  r = b_wins ? b.bits : r;
  r = a_wins ? a.bits : r;
  r = (fb != fb) ? b.bits : r;
  return F16{(fa != fa) ? a.bits : r};
}

// Compare keys: a float (or bfloat16, widened) as an int whose order is
// the float order with -0 < +0, for values that are not NaN. key(key(b))
// = b. On keys a compare is an integer max / min, and max(-0, +0) = +0,
// min = -0, exactly as cmp_sel on the floats (equal keys are equal bits).
struct Key {
  int k;
};
__device__ __forceinline__ int float_key(int b) {
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}
__device__ __forceinline__ Key to_key(float v) {
  return Key{float_key(__float_as_int(v))};
}
__device__ __forceinline__ Key to_key(Bf16 v) {
  return Key{float_key((int)((unsigned)v.bits << 16))};
}
// float16: its sign-magnitude bits as a two's-complement key at 16 bits
// (+0 is 0, -0 is -1, as float_key gives for the wider floats)
__device__ __forceinline__ Key to_key(F16 v) {
  const int b = (int)(int16_t)v.bits;
  return Key{b ^ ((b >> 31) & 0x7FFF)};
}
__device__ __forceinline__ void from_key(Key k, float& v) {
  v = __int_as_float(float_key(k.k));
}
__device__ __forceinline__ void from_key(Key k, Bf16& v) {
  v = Bf16{(uint16_t)((unsigned)float_key(k.k) >> 16)};
}
__device__ __forceinline__ void from_key(Key k, F16& v) {
  v = F16{(uint16_t)(k.k ^ ((k.k >> 31) & 0x7FFF))};
}
// Integer keys: the value as int (uint32 with its sign bit flipped), so
// an int compare orders it; used only where no compare bits are kept.
__device__ __forceinline__ Key to_key(I8 v) { return Key{v.v}; }
__device__ __forceinline__ Key to_key(U8 v) { return Key{v.v}; }
__device__ __forceinline__ Key to_key(I16 v) { return Key{v.v}; }
__device__ __forceinline__ Key to_key(U16 v) { return Key{v.v}; }
__device__ __forceinline__ Key to_key(U32 v) {
  return Key{(int)(v.v ^ 0x80000000u)};
}
__device__ __forceinline__ void from_key(Key k, I8& v) { v.v = (int8_t)k.k; }
__device__ __forceinline__ void from_key(Key k, U8& v) { v.v = (uint8_t)k.k; }
__device__ __forceinline__ void from_key(Key k, I16& v) {
  v.v = (int16_t)k.k;
}
__device__ __forceinline__ void from_key(Key k, U16& v) {
  v.v = (uint16_t)k.k;
}
__device__ __forceinline__ void from_key(Key k, U32& v) {
  v.v = (unsigned)k.k ^ 0x80000000u;
}
// 64-bit keys: float64 as float_key's 64-bit twin, int64 as itself,
// uint64 with its sign bit flipped.
struct Key64 {
  long long k;
};
__device__ __forceinline__ long long double_key(long long b) {
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}
__device__ __forceinline__ Key64 to_key(double v) {
  return Key64{double_key(__double_as_longlong(v))};
}
__device__ __forceinline__ void from_key(Key64 k, double& v) {
  v = __longlong_as_double(double_key(k.k));
}
__device__ __forceinline__ Key64 to_key(I64 v) { return Key64{v.v}; }
__device__ __forceinline__ void from_key(Key64 k, I64& v) { v.v = k.k; }
__device__ __forceinline__ Key64 to_key(U64 v) {
  return Key64{(long long)(v.v ^ 0x8000000000000000ull)};
}
__device__ __forceinline__ void from_key(Key64 k, U64& v) {
  v.v = (unsigned long long)k.k ^ 0x8000000000000000ull;
}
// The key type of an element class.
template <typename T>
struct KeyOf {
  using type = std::conditional_t<kWide<T>, Key64, Key>;
};
__device__ __forceinline__ bool is_nan(double v) { return v != v; }
__device__ __forceinline__ bool is_nan(float v) { return v != v; }
__device__ __forceinline__ bool is_nan(Bf16 v) {
  return as_float(v) != as_float(v);
}
__device__ __forceinline__ bool is_nan(F16 v) {
  return as_float(v) != as_float(v);
}
__device__ __forceinline__ Key cmp_sel(bool hi, Key a, Key b) {
  return Key{cmp_sel(hi, a.k, b.k)};
}
__device__ __forceinline__ Key shfl_x(Key v, int m) {
  return Key{__shfl_xor_sync(0xffffffffu, v.k, m)};
}
__device__ __forceinline__ Key64 cmp_sel(bool hi, Key64 a, Key64 b) {
  return Key64{cmp_sel(hi, a.k, b.k)};
}
__device__ __forceinline__ Key64 shfl_x(Key64 v, int m) {
  return Key64{__shfl_xor_sync(0xffffffffu, v.k, m)};
}

// One result rounded to T (float32, or a half float), kept in float.
template <typename T>
__device__ __forceinline__ float rnd(float f) {
  if constexpr (std::is_same_v<T, Bf16>) return as_float(round_bf16(f));
  if constexpr (std::is_same_v<T, F16>) return as_float(round_f16(f));
  return f;
}
__device__ __forceinline__ void narrow_to(float f, float& v) { v = f; }
__device__ __forceinline__ void narrow_to(float f, Bf16& v) {
  v = round_bf16(f);
}
__device__ __forceinline__ void narrow_to(float f, F16& v) {
  v = round_f16(f);
}

// One butterfly output, exactly as the reference writes it: `hi` says
// whether this position holds the pair's "hi" member. Each product and
// sum is rounded on its own (no contraction into FMAs), to T for a half
// float, the twiddles (float32 values already rounded to T) included.
template <typename T>
__device__ __forceinline__ void bfly_out(bool hi, T v_re, T v_im, T p_re,
                                         T p_im, float wr, float wi, T* o) {
  const float lo_re = as_float(hi ? p_re : v_re);
  const float lo_im = as_float(hi ? p_im : v_im);
  const float hr = as_float(hi ? v_re : p_re);
  const float him = as_float(hi ? v_im : p_im);
  const float t_re = rnd<T>(__fsub_rn(rnd<T>(__fmul_rn(wr, hr)),
                                      rnd<T>(__fmul_rn(wi, him))));
  const float t_im = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(wr, him)),
                                      rnd<T>(__fmul_rn(wi, hr))));
  narrow_to(hi ? __fsub_rn(lo_re, t_re) : __fadd_rn(lo_re, t_re), o[0]);
  narrow_to(hi ? __fsub_rn(lo_im, t_im) : __fadd_rn(lo_im, t_im), o[1]);
}
// The same in double (float64 twiddles; nvcc would contract a * b + c).
__device__ __forceinline__ void bfly_out(bool hi, double v_re, double v_im,
                                         double p_re, double p_im, double wr,
                                         double wi, double* o) {
  const double lo_re = hi ? p_re : v_re, lo_im = hi ? p_im : v_im;
  const double hr = hi ? v_re : p_re, him = hi ? v_im : p_im;
  const double t_re = __dsub_rn(__dmul_rn(wr, hr), __dmul_rn(wi, him));
  const double t_im = __dadd_rn(__dmul_rn(wr, him), __dmul_rn(wi, hr));
  o[0] = hi ? __dsub_rn(lo_re, t_re) : __dadd_rn(lo_re, t_re);
  o[1] = hi ? __dsub_rn(lo_im, t_im) : __dadd_rn(lo_im, t_im);
}
// A butterfly's twiddle pair as the plan's table holds it: float32 values
// (rounded to a half type where the tile holds one), float64 for double.
template <typename T>
struct TwOf {
  using type = float2;
};
template <>
struct TwOf<double> {
  using type = double2;
};

__device__ __forceinline__ int shfl_x(int v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ float shfl_x(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ double shfl_x(double v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ Bf16 shfl_x(Bf16 v, int m) {
  return Bf16{(uint16_t)__shfl_xor_sync(0xffffffffu, (unsigned)v.bits, m)};
}
__device__ __forceinline__ F16 shfl_x(F16 v, int m) {
  return F16{(uint16_t)__shfl_xor_sync(0xffffffffu, (unsigned)v.bits, m)};
}

// ---------------------------------------------------------------------
// The plan (epilogue_plan.py)
// ---------------------------------------------------------------------
// The positions a thread holds, KR, are a template parameter of the code
// below: 16, or 8 (the host's choice, epilogue_plan.regs_for).
constexpr int kHdrWords = 4, kPhaseWords = 32, kEpiWords = 32;
enum {   // phase record
  PH_E0 = 0, PH_E1, PH_REG_VALID, PH_TID_INVALID, PH_GROUP, PH_FIRST,
  PH_MAPS, PH_IMG_REG = 8, PH_IMG_THR = 12, PH_IMG_OUT = 20
};
enum {   // epilogue record
  EP_KIND = 0, EP_VREG, EP_VLANE, EP_HREG, EP_HMASK, EP_HI_BASE, EP_TW_BASE,
  EP_W, EP_SHIFT, EP_TW_REG = 12, EP_TW_THR = 16, EP_TW_OUT = 24
};

// The plan in shared memory, as ints, for the block whose first tile is
// g0: the per-tile table words (pointers in device memory) replaced by the
// block's entries hi_base[g0] and tw_base[g0]. The caller's next barrier
// makes it visible; its loads overlap the tile's.
__device__ __forceinline__ void stage_plan(int* s_plan,
                                           const long long* __restrict__ plan,
                                           int n_words, long long g0) {
  const int ebase = kHdrWords + (int)__ldg(plan) * kPhaseWords;
  const int eend = ebase + (int)__ldg(plan + 1) * kEpiWords;   // then tapes
  for (int i = threadIdx.x; i < n_words; i += REPRO_THREADS) {
    long long w = __ldg(plan + i);
    const int f = (i - ebase) % kEpiWords;
    if (i >= ebase && i < eend && (f == EP_HI_BASE || f == EP_TW_BASE) &&
        w != 0)
      w = __ldg(reinterpret_cast<const int*>(w) + g0);
    s_plan[i] = (int)w;
  }
}

// Bytes of the staged plan, 16-aligned.
__host__ __device__ __forceinline__ size_t plan_bytes(int n_words) {
  return ((size_t)n_words * 4 + 15) & ~(size_t)15;
}

// Position offsets of a thread's registers: register i holds the XOR of
// the images of the set bits of i (compile-time i only).
struct RegImages {
  unsigned i0, i1, i2, i3;
  __device__ __forceinline__ explicit RegImages(const int* img)
      : i0((unsigned)img[0]), i1((unsigned)img[1]), i2((unsigned)img[2]),
        i3((unsigned)img[3]) {}
  __device__ __forceinline__ unsigned operator()(int i) const {
    return ((i & 1) ? i0 : 0u) ^ ((i & 2) ? i1 : 0u) ^ ((i & 4) ? i2 : 0u) ^
           ((i & 8) ? i3 : 0u);
  }
};

// The image of `bits` under the images at img[0..nb).
__device__ __forceinline__ unsigned image_of(const int* img, unsigned bits,
                                             int nb) {
  unsigned q = 0;
  for (int b = 0; b < nb; ++b)
    if ((bits >> b) & 1u) q ^= (unsigned)img[b];
  return q;
}

// The typed view of a block's tile in shared memory: position q (tile row
// << t | lane) of element type T, element k of its tail.
struct TileView {
  unsigned char* bytes;
  unsigned stride_bytes, elem_bytes, lane_mask;
  int t;

  template <typename T>
  __device__ __forceinline__ T* at(unsigned q, int k) const {
    return reinterpret_cast<T*>(bytes + (q >> t) * stride_bytes +
                                (q & lane_mask) * elem_bytes) + k;
  }
  // The same for rows padded by `pad` bytes (stride_bytes - the row's
  // bytes): the position's bytes plus its row's padding.
  template <typename T>
  __device__ __forceinline__ T* at_padded(unsigned q, int k,
                                          unsigned pad) const {
    return reinterpret_cast<T*>(bytes + q * elem_bytes + (q >> t) * pad) + k;
  }
};

// Registers of a phase: tail values k .. k + DV - 1 of the thread's
// positions qb ^ qr(i). Registers the layout leaves empty hold zeros.
// kFast (the work-item kernels): addresses as at_padded, and every
// register loads (an empty register's position is one of the thread's
// others, inside the tile) and selects; stores are predicated.
template <int DV, bool kFast = false, int KR, typename T>
__device__ __forceinline__ void load_regs(T (&v)[DV][KR],
                                          const TileView& tv, unsigned qb,
                                          const RegImages& qr,
                                          unsigned valid, int k) {
  if constexpr (kFast) {
    const unsigned pad = tv.stride_bytes - (tv.elem_bytes << tv.t);
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const T val = *tv.at_padded<T>(qb ^ qr(i), k + c, pad);
        v[c][i] = ((valid >> i) & 1u) ? val : T{};
      }
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int c = 0; c < DV; ++c)
        v[c][i] = ((valid >> i) & 1u) ? *tv.at<T>(qb ^ qr(i), k + c) : T{};
  }
}

template <int DV, bool kFast = false, int KR, typename T>
__device__ __forceinline__ void store_regs(const T (&v)[DV][KR],
                                           const TileView& tv, unsigned qb,
                                           const RegImages& qr,
                                           unsigned valid, int k) {
  if constexpr (kFast) {
    const unsigned pad = tv.stride_bytes - (tv.elem_bytes << tv.t);
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int c = 0; c < DV; ++c)
        if ((valid >> i) & 1u)
          *tv.at_padded<T>(qb ^ qr(i), k + c, pad) = v[c][i];
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int c = 0; c < DV; ++c)
        if ((valid >> i) & 1u) *tv.at<T>(qb ^ qr(i), k + c) = v[c][i];
  }
}

// Run CALL with the compile-time constant VR equal to `vreg` (0..KR-1,
// KR the registers of the calling function).
#define REPRO_VR_CASE(k, CALL)   \
  case k:                        \
    if constexpr (k < KR) {      \
      constexpr int VR = k;      \
      CALL;                      \
    }                            \
    break;
#define REPRO_VREG_SWITCH(vreg, CALL)                                   \
  switch (vreg) {                                                       \
    REPRO_VR_CASE(0, CALL) REPRO_VR_CASE(1, CALL) REPRO_VR_CASE(2, CALL) \
    REPRO_VR_CASE(3, CALL) REPRO_VR_CASE(4, CALL) REPRO_VR_CASE(5, CALL) \
    REPRO_VR_CASE(6, CALL) REPRO_VR_CASE(7, CALL) REPRO_VR_CASE(8, CALL) \
    REPRO_VR_CASE(9, CALL) REPRO_VR_CASE(10, CALL)                      \
    REPRO_VR_CASE(11, CALL) REPRO_VR_CASE(12, CALL)                     \
    REPRO_VR_CASE(13, CALL) REPRO_VR_CASE(14, CALL)                     \
    REPRO_VR_CASE(15, CALL)                                             \
    default: break;                                                     \
  }

// partner[i] = the value at the partner of register i: register i ^ VR of
// this thread, or of lane ^ vlane when vlane != 0.
template <int VR, int KR, typename T>
__device__ __forceinline__ void partners(const T (&v)[KR], int vlane,
                                         T (&p)[KR]) {
  if (vlane) {
#pragma unroll
    for (int i = 0; i < KR; ++i) p[i] = shfl_x(v[i ^ VR], vlane);
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i) p[i] = v[i ^ VR];
  }
}

// The two compare bits of one element: (self == out) | (partner == out) << 1,
// equality as floats.
template <typename T>
__device__ __forceinline__ unsigned eq_bits(T a, T p, T o) {
  const float fo = as_float(o);
  return (unsigned)(as_float(a) == fo) | ((unsigned)(as_float(p) == fo) << 1);
}
// The same on keys: the output is the self or the partner bit for bit, so
// both bits are set when the two are equal as floats (equal keys, or both
// zeros: keys 0 and -1), and otherwise exactly the winner's.
__device__ __forceinline__ unsigned eq_bits(Key a, Key p, Key o) {
  const bool tie =
      (a.k == p.k) | ((((unsigned)a.k + 1u) | ((unsigned)p.k + 1u)) <= 1u);
  return tie ? 3u : 2u - (unsigned)(a.k == o.k);
}
__device__ __forceinline__ unsigned eq_bits(double a, double p, double o) {
  return (unsigned)(a == o) | ((unsigned)(p == o) << 1);
}
__device__ __forceinline__ unsigned eq_bits(Key64 a, Key64 p, Key64 o) {
  const unsigned long long ua = (unsigned long long)a.k + 1ull;
  const unsigned long long up = (unsigned long long)p.k + 1ull;
  const bool tie = (a.k == p.k) | ((ua | up) <= 1ull);
  return tie ? 3u : 2u - (unsigned)(a.k == o.k);
}

// Compare epilogue on registers; with kMask, the compare bits of each
// element go to bits `shift`, `shift` + 1 of m. hx: bit i says whether
// register i holds its pair's "hi" member.
template <int VR, bool kMask, int DV, int KR, typename T>
__device__ __forceinline__ void cmp_regs(T (&v)[DV][KR],
                                         unsigned (&m)[DV][KR],
                                         unsigned hx, int vlane, int shift) {
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    T p[KR];
    partners<VR>(v[c], vlane, p);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const T o = cmp_sel((hx >> i) & 1u, v[c][i], p[i]);
      if constexpr (kMask) m[c][i] |= eq_bits(v[c][i], p[i], o) << shift;
      v[c][i] = o;
    }
  }
}

// cmp_regs for integer values and keys (min and max the same either way
// round), with in-register partners taken as pairs: each pair's min and
// max once, then each register's pick; shuffled partners as cmp_regs
// takes them, without its copies. The work-item kernels run it.
template <int VR, bool kMask, int DV, int KR, typename T>
__device__ __forceinline__ void cmp_pairs(T (&v)[DV][KR],
                                          unsigned (&m)[DV][KR],
                                          unsigned hx, int vlane, int shift) {
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    if (vlane == 0) {
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int j = i ^ VR;
        if (i < j) {
          const T a = v[c][i], b = v[c][j];
          const T lo = cmp_sel(false, a, b), hi = cmp_sel(true, a, b);
          const T oi = ((hx >> i) & 1u) ? hi : lo;
          const T oj = ((hx >> j) & 1u) ? hi : lo;
          if constexpr (kMask) {
            m[c][i] |= eq_bits(a, b, oi) << shift;
            m[c][j] |= eq_bits(b, a, oj) << shift;
          }
          v[c][i] = oi;
          v[c][j] = oj;
        }
      }
    } else {
      T p[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) p[i] = shfl_x(v[c][i ^ VR], vlane);
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const T lo = cmp_sel(false, v[c][i], p[i]);
        const T hi = cmp_sel(true, v[c][i], p[i]);
        const T o = ((hx >> i) & 1u) ? hi : lo;
        if constexpr (kMask) m[c][i] |= eq_bits(v[c][i], p[i], o) << shift;
        v[c][i] = o;
      }
    }
  }
}

// Twiddle indices of a thread's registers for one butterfly epilogue.
template <int KR>
__device__ __forceinline__ void tw_index(const int* ep, unsigned tw0,
                                         unsigned (&tw)[KR]) {
  const RegImages img(ep + EP_TW_REG);
#pragma unroll
  for (int i = 0; i < KR; ++i) tw[i] = tw0 ^ img(i);
}

// The twiddle index of the thread's register 0 (tw_base[g0] staged).
__device__ __forceinline__ unsigned tw_thread(const int* ep, unsigned chunk,
                                              int outer_bits) {
  return (unsigned)ep[EP_TW_BASE] ^ image_of(ep + EP_TW_THR, threadIdx.x, 8) ^
         image_of(ep + EP_TW_OUT, chunk, outer_bits);
}

// Butterfly epilogue on registers (planar float32, bfloat16, float16 or
// float64: v[0] re, v[1] im).
template <int VR, int KR, typename T>
__device__ __forceinline__ void bfly_regs(T (&v)[2][KR], unsigned hx,
                                          int vlane,
                                          const typename TwOf<T>::type* w,
                                          const unsigned (&tw)[KR]) {
  T pr[KR], pi[KR];
  partners<VR>(v[0], vlane, pr);
  partners<VR>(v[1], vlane, pi);
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const typename TwOf<T>::type wv = __ldg(w + tw[i]);
    T o[2];
    bfly_out((hx >> i) & 1u, v[0][i], v[1][i], pr[i], pi[i], wv.x, wv.y, o);
    v[0][i] = o[0];
    v[1][i] = o[1];
  }
}

// The "hi" bits of a thread's registers for epilogue ep (staged): bit i
// for register i, from the 16-bit word of the register part and the
// parity of the thread's position bits qb under the hi mask.
__device__ __forceinline__ unsigned hi_bits(const int* ep, unsigned qb) {
  const unsigned h = (__popc(qb & (unsigned)ep[EP_HMASK]) ^
                      (unsigned)ep[EP_HI_BASE]) & 1u;
  return (unsigned)ep[EP_HREG] ^ (0u - h);
}

// ---------------------------------------------------------------------
// Map epilogues: the tape of map_lower.py, a DAG of at most kTapeMax ops.
// Each value of the tape is a slot: slot 0 the map's input, slot s + 1 op
// s's result. An op reads up to three operands, each a slot or a
// constant of the tape's pool. Each op computes what PyTorch's CUDA
// kernel for its aten op computes: a float32 op in float (no contraction
// into FMAs where PyTorch's kernel has none; a / c as a * (1 / c),
// PyTorch's CUDA division by a number), a float64 op the same in double,
// a bfloat16 or float16 op in float rounded to its type once an op, an
// integer op in int (long long for int64 and uint64) wrapped at its
// type's width (uint32 and uint64 compared, shifted and divided as
// unsigned). PyTorch's fused kernels (gelu, silu, softplus and their
// backward) are written as PyTorch writes them, so nvcc contracts them as
// it contracts PyTorch's. Comparisons and the logical ops make 0 and 1.
// The record: kind 2, the tape's length, the map's slot in K5's saved
// inputs, the epilogue K5 recomputes its input from (-1: none), and the
// plan word of its tape (EP_MAP_TAPE, past EP_HI_BASE and EP_TW_BASE,
// which the kernels read as pointers). The tape (map_lower.tape_words):
// the gradient mask (bit s: op s's backward runs), a word an op (op | keep
// << 7 | a << 8 | b << 16 | c << 24; an operand byte is a slot, 0x40 | k
// constant k, or 0xC0 none; keep: a later op other than the next reads
// the result), then two words a constant (low, high). EP_MAP_TYPED: 1
// for a typed tape (map_lower.Tape.typed: a type word an op after its op
// words), which the ext build runs (below, REPRO_MAP_EXT).
// The tape runs one register at a time: the running value and the input
// in registers, the results a later op reads again in a per-thread array.
// ---------------------------------------------------------------------
constexpr int kKindMap = 2;
constexpr int kTapeMax = 32;
enum { EP_MAP_LEN = 1, EP_MAP_SLOT = 2, EP_MAP_FROM = 3, EP_MAP_TAPE = 8,
       EP_MAP_TYPED = 9 };
enum {   // opcodes (map_lower.py)
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_NEG, OP_ABS, OP_MAXC, OP_MINC, OP_RELU,
  OP_EXP, OP_EXPM1, OP_LOG, OP_LOG1P, OP_SQRT, OP_RSQRT, OP_TANH, OP_SIGMOID,
  OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR, OP_SIN, OP_COS,
  OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_LNOT, OP_LAND, OP_LOR,
  OP_WHERE, OP_MAXIMUM, OP_MINIMUM, OP_POW, OP_RECIP, OP_FLOOR, OP_CEIL,
  OP_TRUNC, OP_ROUND, OP_SIGN, OP_ERF, OP_LOG2, OP_EXP2, OP_GELU,
  OP_GELU_TANH, OP_SILU, OP_SOFTPLUS, OP_LEAKY, OP_HARDTANH, OP_FLOORDIV,
  OP_TRUNCDIV, OP_REM, OP_FMOD,
  OP_CAST, OP_ISNAN, OP_ISINF, OP_SIGNBIT, OP_NAN_TO_NUM, OP_COPYSIGN,
  OP_POWT, OP_ATAN2, OP_HYPOT, OP_LERP, OP_ADDCMUL, OP_ADDCDIV, OP_ELU,
  OP_ELU_SCALED, OP_HARDSIGMOID, OP_HARDSWISH, OP_MISH, OP_LOGSIGMOID,
  OP_HARDSHRINK, OP_SOFTSHRINK, OP_THRESHOLD, OP_LOGIT, OP_TAN, OP_ATAN,
  OP_ASIN, OP_ACOS, OP_SINH, OP_COSH, OP_ASINH, OP_ACOSH, OP_ATANH,
  OP_ERFC, OP_ERFINV, OP_LOG10, OP_XLOGY, OP_SINC, OP_ROUND_DEC
};
constexpr int kOpndConst = 0x40;   // operand byte: a constant (0x80: none)
// A value's dtype in a typed tape's type words (map_lower.TYPE_CODE)
enum { TY_I32, TY_F32, TY_BF16, TY_F16, TY_I8, TY_U8, TY_I16, TY_U16,
       TY_U32, TY_I64, TY_U64, TY_F64, TY_BOOL };

// The value type a tape computes in: float for the float types of 32 bits
// and less, int for the integers of 32 bits and less, double and long long
// for the 64-bit ones.
template <typename T>
struct MapOf {
  using type = std::conditional_t<
      kWide<T>, std::conditional_t<std::is_same_v<T, double>, double,
                                   long long>,
      std::conditional_t<kFloatElem<T>, float, int>>;
};
__device__ __forceinline__ int widen(int v) { return v; }
__device__ __forceinline__ int widen(I8 v) { return v.v; }
__device__ __forceinline__ int widen(U8 v) { return v.v; }
__device__ __forceinline__ int widen(I16 v) { return v.v; }
__device__ __forceinline__ int widen(U16 v) { return v.v; }
__device__ __forceinline__ int widen(U32 v) { return (int)v.v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(Bf16 v) { return as_float(v); }
__device__ __forceinline__ float widen(F16 v) { return as_float(v); }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ long long widen(I64 v) { return v.v; }
__device__ __forceinline__ long long widen(U64 v) { return (long long)v.v; }
__device__ __forceinline__ void narrow_to(double f, double& v) { v = f; }
__device__ __forceinline__ void narrow_to(long long f, I64& v) { v.v = f; }
__device__ __forceinline__ void narrow_to(long long f, U64& v) {
  v.v = (unsigned long long)f;
}
__device__ __forceinline__ void narrow_to(int f, int& v) { v = f; }
__device__ __forceinline__ void narrow_to(int f, I8& v) { v.v = (int8_t)f; }
__device__ __forceinline__ void narrow_to(int f, U8& v) { v.v = (uint8_t)f; }
__device__ __forceinline__ void narrow_to(int f, I16& v) {
  v.v = (int16_t)f;
}
__device__ __forceinline__ void narrow_to(int f, U16& v) {
  v.v = (uint16_t)f;
}
__device__ __forceinline__ void narrow_to(int f, U32& v) {
  v.v = (unsigned)f;
}
// An integer op's result wrapped at T's width (sign- or zero-extended).
template <typename T>
__device__ __forceinline__ int wrap(int f) {
  if constexpr (std::is_same_v<T, I8>) return (int8_t)f;
  if constexpr (std::is_same_v<T, U8>) return (uint8_t)f;
  if constexpr (std::is_same_v<T, I16>) return (int16_t)f;
  if constexpr (std::is_same_v<T, U16>) return (uint16_t)f;
  return f;
}
// The same for a tape value of either integer width (64 bits: itself).
template <typename T, typename F>
__device__ __forceinline__ F map_wrap(F f) {
  if constexpr (std::is_same_v<F, int>) return wrap<T>(f);
  else return f;
}

// A constant's 64 bits: its low word and its high word.
__device__ __forceinline__ long long wide_const(int lo, int hi) {
  return (long long)(((unsigned long long)(unsigned)hi << 32) |
                     (unsigned long long)(unsigned)lo);
}
// Constant k of a tape's pool in the tape's value type F.
template <typename F>
__device__ __forceinline__ F map_const(const int* pool, int k) {
  const int lo = pool[2 * k], hi = pool[2 * k + 1];
  if constexpr (std::is_same_v<F, double>)
    return __longlong_as_double(wide_const(lo, hi));
  else if constexpr (std::is_same_v<F, long long>)
    return wide_const(lo, hi);
  else if constexpr (std::is_same_v<F, float>)
    return __int_as_float(lo);
  else
    return lo;
}
// sin and cos (CUDA's sinf and cosf: a large argument reduces through a
// local-memory array). Out of line, so that their code and stack frame
// stay out of map_elem_op's other ops.
__device__ __noinline__ float map_trig(int op, float a) {
  return op == OP_SIN ? sinf(a) : cosf(a);
}
__device__ __noinline__ double map_trig(int op, double a) {
  return op == OP_SIN ? sin(a) : cos(a);
}

// x ** e as PyTorch's CUDA pow by a number computes it for T (float, a
// half float, or double F): 0 and 1 fill and copy, 0.5, -0.5 and -1 are
// sqrt, rsqrt and reciprocal, and past them the exponent is cast to T
// and 2, 3 and -2 are products (each rounded to T), anything else pow.
template <typename T, typename F>
__device__ __forceinline__ F map_pow(F x, double e) {
  if constexpr (std::is_same_v<F, double>) {
    if (e == 0.0) return 1.0;
    if (e == 1.0) return x;
    if (e == 0.5) return __dsqrt_rn(x);
    if (e == -0.5) return rsqrt(x);
    if (e == -1.0) return __ddiv_rn(1.0, x);
    if (e == 2.0) return __dmul_rn(x, x);
    if (e == 3.0) return __dmul_rn(__dmul_rn(x, x), x);
    if (e == -2.0) return __ddiv_rn(1.0, __dmul_rn(x, x));
    return pow(x, e);
  } else {
    if (e == 0.0) return 1.0f;
    if (e == 1.0) return x;
    if (e == 0.5) return rnd<T>(sqrtf(x));
    if (e == -0.5) return rnd<T>(rsqrtf(x));
    if (e == -1.0) return rnd<T>(__fdiv_rn(1.0f, x));
    const float et = rnd<T>((float)e);
    if (et == 2.0f) return rnd<T>(__fmul_rn(x, x));
    if (et == 3.0f) return rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(x, x)), x));
    if (et == -2.0f) return rnd<T>(__fdiv_rn(1.0f, rnd<T>(__fmul_rn(x, x))));
    return rnd<T>(powf(x, et));
  }
}

// The constants of math.h's M_SQRT1_2, M_SQRT2, M_2_SQRTPI, M_PI, M_LN2.
constexpr double kSqrt1_2 = 0.70710678118654752440;
constexpr double kSqrt2 = 1.41421356237309504880;
constexpr double k2SqrtPi = 1.12837916709551257390;
constexpr double kPi = 3.14159265358979323846;
constexpr double kLn2 = 0.69314718055994530942;

// The activations PyTorch fuses into one kernel, in its compute type F
// (float for the half floats), as PyTorch's CUDA kernels write them.
template <typename F>
__device__ __forceinline__ F gelu_erf(F x) {
  constexpr F kAlpha = kSqrt1_2;
  return x * F(0.5) * (F(1) + erf(x * kAlpha));
}
template <typename F>
__device__ __forceinline__ F gelu_tanh(F x) {
  constexpr F kBeta = kSqrt2 * k2SqrtPi * F(0.5);
  constexpr F kKappa = 0.044715;
  auto x_cube = x * x * x;
  auto inner = kBeta * (x + kKappa * x_cube);
  return F(0.5) * x * (F(1) + tanh(inner));
}
template <typename F>
__device__ __forceinline__ F silu_f(F x) {
  return x / (F(1) + exp(-x));
}
template <typename F>
__device__ __forceinline__ F softplus_f(F a, F beta, F threshold) {
  return (a * beta) > threshold ? a : (log1p(exp(a * beta))) / beta;
}
// floor_divide and div(..., rounding_mode="floor") by a number: PyTorch's
// CUDA kernel multiplies by the number's reciprocal, the result held in T
// where it writes T.
template <typename T, typename F>
__device__ __forceinline__ F floor_div(F a, F b) {
  if (b == F(0)) return a / b;
  const F inv_b = F(1) / b;
  const F mod = fmod(a, b);
  F div = (a - mod) * inv_b;
  if ((mod != F(0)) && (b < F(0)) != (mod < F(0))) div -= F(1);
  F fd;
  if (div != F(0)) {
    if constexpr (std::is_same_v<F, double>) {
      fd = floor(div);
      if (div - fd > 0.5) fd += 1.0;
    } else {
      fd = rnd<T>(floorf(div));
      if (div - fd > 0.5f) fd = rnd<T>(fd + 1.0f);
    }
  } else {
    fd = copysign(F(0), a * inv_b);
  }
  return fd;
}

// One float op (float32, bfloat16 or float16 T) on resolved operands; w
// its word (the op in the low 7 bits), pool its tape's constants. The ops
// map_step runs inline are not here.
template <typename T>
__device__ __forceinline__ float map_op(int w, float a, float b, float c,
                                        const int* pool) {
  const int op = w & 0x7F;
  float y;
  switch (op) {
    case OP_DIV: y = __fdiv_rn(a, b); break;
    case OP_EXP: y = expf(a); break;
    case OP_EXPM1: y = expm1f(a); break;
    case OP_LOG: y = logf(a); break;
    case OP_LOG1P: y = log1pf(a); break;
    case OP_SQRT: y = sqrtf(a); break;
    case OP_RSQRT: y = rsqrtf(a); break;
    case OP_TANH: y = tanhf(a); break;
    case OP_SIGMOID: y = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a))); break;
    case OP_SIN:
    case OP_COS: y = map_trig(op, a); break;
    case OP_POW:
      return map_pow<T>(a, __longlong_as_double(wide_const(
                               pool[2 * ((w >> 16) & 0x3F)],
                               pool[2 * ((w >> 16) & 0x3F) + 1])));
    case OP_RECIP: y = __fdiv_rn(1.0f, a); break;
    case OP_ERF: y = erff(a); break;
    case OP_LOG2: y = log2f(a); break;
    case OP_EXP2: y = exp2f(a); break;
    case OP_GELU: y = gelu_erf(a); break;
    case OP_GELU_TANH: y = gelu_tanh(a); break;
    case OP_SILU: y = silu_f(a); break;
    case OP_SOFTPLUS: y = softplus_f(a, b, c); break;
    case OP_FLOORDIV: y = floor_div<T>(a, b); break;
    case OP_TRUNCDIV: y = truncf(__fmul_rn(a, __fdiv_rn(1.0f, b))); break;
    case OP_REM: {
      y = fmodf(a, b);
      if (y != 0.0f && ((b < 0.0f) != (y < 0.0f))) y = __fadd_rn(y, b);
      break;
    }
    case OP_FMOD: y = fmodf(a, b); break;
    default: y = a; break;
  }
  return rnd<T>(y);
}

// One float64 op on resolved operands, as eager PyTorch computes it on
// the card in double (one rounding an op). The ops map_step runs inline
// are not here.
__device__ __forceinline__ double map_op(int w, double a, double b, double c,
                                         const int* pool) {
  const int op = w & 0x7F;
  switch (op) {
    case OP_DIV: return __ddiv_rn(a, b);
    case OP_EXP: return exp(a);
    case OP_EXPM1: return expm1(a);
    case OP_LOG: return log(a);
    case OP_LOG1P: return log1p(a);
    case OP_SQRT: return __dsqrt_rn(a);
    case OP_RSQRT: return rsqrt(a);
    case OP_TANH: return tanh(a);
    case OP_SIGMOID: return __ddiv_rn(1.0, __dadd_rn(1.0, exp(-a)));
    case OP_SIN:
    case OP_COS: return map_trig(op, a);
    case OP_POW: return map_pow<double>(a, b);
    case OP_RECIP: return __ddiv_rn(1.0, a);
    case OP_ERF: return erf(a);
    case OP_LOG2: return log2(a);
    case OP_EXP2: return exp2(a);
    case OP_GELU: return gelu_erf(a);
    case OP_GELU_TANH: return gelu_tanh(a);
    case OP_SILU: return silu_f(a);
    case OP_SOFTPLUS: return softplus_f(a, b, c);
    case OP_FLOORDIV: return floor_div<double>(a, b);
    case OP_TRUNCDIV: return trunc(__dmul_rn(a, __ddiv_rn(1.0, b)));
    case OP_REM: {
      double m = fmod(a, b);
      if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m = __dadd_rn(m, b);
      return m;
    }
    case OP_FMOD: return fmod(a, b);
    default: return a;
  }
}

// One integer op of int (32 bits) or long long (64), wrapping (kUnsigned:
// uint32's or uint64's bits, compared, shifted and divided as unsigned).
// A divisor of -1 negates (floor and trunc) or leaves 0 (remainder, fmod),
// as PyTorch's kernels give the type's least value divided by -1.
template <bool kUnsigned = false, typename I>
__device__ __forceinline__ I map_op_int(int op, I a, I b, I c) {
  using U = std::make_unsigned_t<I>;
  constexpr int kShift = 8 * (int)sizeof(I) - 1;
  const U ua = (U)a, ub = (U)b;
  if constexpr (kUnsigned) {
    switch (op) {
      case OP_ABS: return a;
      case OP_MAXC:
      case OP_MAXIMUM: return (I)(ua > ub ? ua : ub);
      case OP_MINC:
      case OP_MINIMUM: return (I)(ua < ub ? ua : ub);
      case OP_RELU: return a;
      case OP_SHR: return (I)(ua >> (b & kShift));
      case OP_LT: return ua < ub;
      case OP_LE: return ua <= ub;
      case OP_GT: return ua > ub;
      case OP_GE: return ua >= ub;
      case OP_SIGN: return ua != 0;
      case OP_HARDTANH: {
        const U lo = ua > ub ? ua : ub;
        return (I)(lo < (U)c ? lo : (U)c);
      }
      case OP_FLOORDIV:
      case OP_TRUNCDIV: return (I)(ua / ub);
      case OP_REM:
      case OP_FMOD: return (I)(ua % ub);
      default: break;
    }
  }
  switch (op) {
    case OP_ADD: return (I)(ua + ub);
    case OP_SUB: return (I)(ua - ub);
    case OP_MUL: return (I)(ua * ub);
    case OP_NEG: return (I)((U)0 - ua);
    case OP_ABS: return a < 0 ? (I)((U)0 - ua) : a;
    case OP_MAXC:
    case OP_MAXIMUM: return a > b ? a : b;
    case OP_MINC:
    case OP_MINIMUM: return a < b ? a : b;
    case OP_RELU: return a > 0 ? a : (I)0;
    case OP_NOT: return ~a;
    case OP_AND: return a & b;
    case OP_OR: return a | b;
    case OP_XOR: return a ^ b;
    case OP_SHL: return (I)(ua << (b & kShift));
    case OP_SHR: return a >> (b & kShift);
    case OP_EQ: return a == b;
    case OP_NE: return a != b;
    case OP_LT: return a < b;
    case OP_LE: return a <= b;
    case OP_GT: return a > b;
    case OP_GE: return a >= b;
    case OP_LNOT: return a == 0;
    case OP_LAND: return (a != 0) && (b != 0);
    case OP_LOR: return (a != 0) || (b != 0);
    case OP_WHERE: return a != 0 ? b : c;
    case OP_POW: {   // b >= 0 (the lowering takes no other)
      U r = 1, base = ua;
      for (U e = ub; e; e >>= 1) {
        if (e & 1) r *= base;
        base *= base;
      }
      return (I)r;
    }
    case OP_SIGN: return (I)((0 < a) - (a < 0));
    case OP_HARDTANH: {
      const I lo = a > b ? a : b;
      return lo < c ? lo : c;
    }
    case OP_FLOORDIV: {
      if (b == (I)-1) return (I)((U)0 - ua);
      const I q = a / b, r = a % b;
      return (r != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
    }
    case OP_TRUNCDIV: return b == (I)-1 ? (I)((U)0 - ua) : a / b;
    case OP_REM: {
      if (b == (I)-1) return 0;
      I r = a % b;
      if (r != 0 && ((r < 0) != (b < 0))) r += b;
      return r;
    }
    case OP_FMOD: return b == (I)-1 ? (I)0 : a % b;
    default: return a;   // floor, ceil, trunc, round: the value itself
  }
}

// Tape op w on resolved operands a, b, c (pool: the tape's constants),
// for the ops map_step does not run inline (a division by a number is
// one of those it does). Out of line, so the switch and its math
// functions are one copy for all of a thread's registers: inlined into
// each unrolled register they made the map kernels' code 1.3-1.7x larger
// and K5 on a tanh cluster 0.61 ms instead of 0.36 on the H100 (PERF.md).
template <typename T>
__device__ __noinline__ typename MapOf<T>::type map_elem_op(
    int w, typename MapOf<T>::type a, typename MapOf<T>::type b,
    typename MapOf<T>::type c, const int* pool) {
  if constexpr (std::is_same_v<T, int>) {
    return map_op_int(w & 0x7F, a, b, c);
  } else if constexpr (std::is_same_v<T, double>) {
    return map_op(w, a, b, c, pool);
  } else if constexpr (kFloatElem<T>) {
    return map_op<T>(w, a, b, c, pool);
  } else if constexpr (kWide<T>) {
    return map_op_int<std::is_same_v<T, U64>>(w & 0x7F, a, b, c);
  } else {
    return wrap<T>(map_op_int<std::is_same_v<T, U32>>(w & 0x7F, a, b, c));
  }
}

// Tape op w on the thread's registers at once: y[i] = op(a[i], b[i],
// c[i]), as PyTorch's CUDA kernel for the op computes it. The op is
// uniform over the block, so the switch runs once an op; the ops whose
// code is a few instructions run inline across the registers, and the
// others call map_elem_op (out of line) once a register: with every op
// out of line, a where map cost K4b and K5 2.6-2.9x their time on the
// H100 (PERF.md).
#define REPRO_MAP_ALL(EXPR)                 \
  {                                         \
    _Pragma("unroll") for (int i = 0; i < KR; ++i) y[i] = (EXPR); \
  }                                         \
  return;
template <typename T, int KR, typename F>
__device__ __forceinline__ void map_step(int w, const F (&a)[KR],
                                         const F (&b)[KR], const F (&c)[KR],
                                         F (&y)[KR], const int* pool) {
  const int op = w & 0x7F;
  const bool b_const = ((w >> 16) & 0xC0) == kOpndConst;
  if constexpr (std::is_same_v<F, float>) {
    switch (op) {
      case OP_ADD: REPRO_MAP_ALL(rnd<T>(__fadd_rn(a[i], b[i])))
      case OP_SUB: REPRO_MAP_ALL(rnd<T>(__fsub_rn(a[i], b[i])))
      case OP_MUL: REPRO_MAP_ALL(rnd<T>(__fmul_rn(a[i], b[i])))
      case OP_DIV:
        if (b_const) {   // PyTorch: a * (1 / c)
          const float inv = __fdiv_rn(1.0f, b[0]);
          REPRO_MAP_ALL(rnd<T>(__fmul_rn(a[i], inv)))
        }
        break;
      case OP_NEG: REPRO_MAP_ALL(rnd<T>(-a[i]))
      case OP_ABS: REPRO_MAP_ALL(rnd<T>(fabsf(a[i])))
      case OP_MAXC:
        REPRO_MAP_ALL(rnd<T>((a[i] != a[i]) ? a[i] : fmaxf(a[i], b[i])))
      case OP_MINC:
        REPRO_MAP_ALL(rnd<T>((a[i] != a[i]) ? a[i] : fminf(a[i], b[i])))
      case OP_RELU:
        REPRO_MAP_ALL(rnd<T>((a[i] != a[i]) ? a[i] : fmaxf(a[i], 0.0f)))
      case OP_EQ: REPRO_MAP_ALL((float)(a[i] == b[i]))
      case OP_NE: REPRO_MAP_ALL((float)(a[i] != b[i]))
      case OP_LT: REPRO_MAP_ALL((float)(a[i] < b[i]))
      case OP_LE: REPRO_MAP_ALL((float)(a[i] <= b[i]))
      case OP_GT: REPRO_MAP_ALL((float)(a[i] > b[i]))
      case OP_GE: REPRO_MAP_ALL((float)(a[i] >= b[i]))
      case OP_LNOT: REPRO_MAP_ALL((float)(a[i] == 0.0f))
      case OP_LAND: REPRO_MAP_ALL((float)((a[i] != 0.0f) && (b[i] != 0.0f)))
      case OP_LOR: REPRO_MAP_ALL((float)((a[i] != 0.0f) || (b[i] != 0.0f)))
      case OP_WHERE: REPRO_MAP_ALL(a[i] != 0.0f ? b[i] : c[i])
      case OP_MAXIMUM:
        REPRO_MAP_ALL(rnd<T>((a[i] != a[i]) ? a[i]
                             : ((b[i] != b[i]) ? b[i] : fmaxf(a[i], b[i]))))
      case OP_MINIMUM:
        REPRO_MAP_ALL(rnd<T>((a[i] != a[i]) ? a[i]
                             : ((b[i] != b[i]) ? b[i] : fminf(a[i], b[i]))))
      case OP_FLOOR: REPRO_MAP_ALL(rnd<T>(floorf(a[i])))
      case OP_CEIL: REPRO_MAP_ALL(rnd<T>(ceilf(a[i])))
      case OP_TRUNC: REPRO_MAP_ALL(rnd<T>(truncf(a[i])))
      case OP_ROUND: REPRO_MAP_ALL(rnd<T>(rintf(a[i])))
      case OP_SIGN:
        REPRO_MAP_ALL(rnd<T>((float)((0.0f < a[i]) - (a[i] < 0.0f))))
      case OP_LEAKY: REPRO_MAP_ALL(rnd<T>(a[i] > 0.0f ? a[i] : a[i] * b[i]))
      case OP_HARDTANH: {
        const float lo = rnd<T>(b[0]), hi = rnd<T>(c[0]);
        REPRO_MAP_ALL(rnd<T>((a[i] != a[i]) ? a[i]
                             : fminf(fmaxf(a[i], lo), hi)))
      }
      default: break;
    }
  } else if constexpr (std::is_same_v<F, double>) {
    switch (op) {
      case OP_ADD: REPRO_MAP_ALL(__dadd_rn(a[i], b[i]))
      case OP_SUB: REPRO_MAP_ALL(__dsub_rn(a[i], b[i]))
      case OP_MUL: REPRO_MAP_ALL(__dmul_rn(a[i], b[i]))
      case OP_DIV:
        if (b_const) {
          const double inv = __ddiv_rn(1.0, b[0]);
          REPRO_MAP_ALL(__dmul_rn(a[i], inv))
        }
        break;
      case OP_NEG: REPRO_MAP_ALL(-a[i])
      case OP_ABS: REPRO_MAP_ALL(fabs(a[i]))
      case OP_MAXC: REPRO_MAP_ALL((a[i] != a[i]) ? a[i] : fmax(a[i], b[i]))
      case OP_MINC: REPRO_MAP_ALL((a[i] != a[i]) ? a[i] : fmin(a[i], b[i]))
      case OP_RELU: REPRO_MAP_ALL((a[i] != a[i]) ? a[i] : fmax(a[i], 0.0))
      case OP_EQ: REPRO_MAP_ALL((double)(a[i] == b[i]))
      case OP_NE: REPRO_MAP_ALL((double)(a[i] != b[i]))
      case OP_LT: REPRO_MAP_ALL((double)(a[i] < b[i]))
      case OP_LE: REPRO_MAP_ALL((double)(a[i] <= b[i]))
      case OP_GT: REPRO_MAP_ALL((double)(a[i] > b[i]))
      case OP_GE: REPRO_MAP_ALL((double)(a[i] >= b[i]))
      case OP_LNOT: REPRO_MAP_ALL((double)(a[i] == 0.0))
      case OP_LAND: REPRO_MAP_ALL((double)((a[i] != 0.0) && (b[i] != 0.0)))
      case OP_LOR: REPRO_MAP_ALL((double)((a[i] != 0.0) || (b[i] != 0.0)))
      case OP_WHERE: REPRO_MAP_ALL(a[i] != 0.0 ? b[i] : c[i])
      case OP_MAXIMUM:
        REPRO_MAP_ALL((a[i] != a[i]) ? a[i]
                      : ((b[i] != b[i]) ? b[i] : fmax(a[i], b[i])))
      case OP_MINIMUM:
        REPRO_MAP_ALL((a[i] != a[i]) ? a[i]
                      : ((b[i] != b[i]) ? b[i] : fmin(a[i], b[i])))
      case OP_FLOOR: REPRO_MAP_ALL(floor(a[i]))
      case OP_CEIL: REPRO_MAP_ALL(ceil(a[i]))
      case OP_TRUNC: REPRO_MAP_ALL(trunc(a[i]))
      case OP_ROUND: REPRO_MAP_ALL(rint(a[i]))
      case OP_SIGN: REPRO_MAP_ALL((double)((0.0 < a[i]) - (a[i] < 0.0)))
      case OP_LEAKY: REPRO_MAP_ALL(a[i] > 0.0 ? a[i] : a[i] * b[i])
      case OP_HARDTANH:
        REPRO_MAP_ALL((a[i] != a[i]) ? a[i] : fmin(fmax(a[i], b[i]), c[i]))
      default: break;
    }
  } else if constexpr (!std::is_same_v<T, U32> && !std::is_same_v<T, U64>) {
    // signed integers, and the narrow unsigned ones held as int
    using U = std::make_unsigned_t<F>;
    switch (op) {
      case OP_ADD: REPRO_MAP_ALL(map_wrap<T>((F)((U)a[i] + (U)b[i])))
      case OP_SUB: REPRO_MAP_ALL(map_wrap<T>((F)((U)a[i] - (U)b[i])))
      case OP_MUL: REPRO_MAP_ALL(map_wrap<T>((F)((U)a[i] * (U)b[i])))
      case OP_NEG: REPRO_MAP_ALL(map_wrap<T>((F)((U)0 - (U)a[i])))
      case OP_NOT: REPRO_MAP_ALL(map_wrap<T>(~a[i]))
      case OP_AND: REPRO_MAP_ALL(map_wrap<T>(a[i] & b[i]))
      case OP_OR: REPRO_MAP_ALL(map_wrap<T>(a[i] | b[i]))
      case OP_XOR: REPRO_MAP_ALL(map_wrap<T>(a[i] ^ b[i]))
      case OP_MAXC:
      case OP_MAXIMUM: REPRO_MAP_ALL(a[i] > b[i] ? a[i] : b[i])
      case OP_MINC:
      case OP_MINIMUM: REPRO_MAP_ALL(a[i] < b[i] ? a[i] : b[i])
      case OP_EQ: REPRO_MAP_ALL((F)(a[i] == b[i]))
      case OP_NE: REPRO_MAP_ALL((F)(a[i] != b[i]))
      case OP_LT: REPRO_MAP_ALL((F)(a[i] < b[i]))
      case OP_LE: REPRO_MAP_ALL((F)(a[i] <= b[i]))
      case OP_GT: REPRO_MAP_ALL((F)(a[i] > b[i]))
      case OP_GE: REPRO_MAP_ALL((F)(a[i] >= b[i]))
      case OP_LNOT: REPRO_MAP_ALL((F)(a[i] == 0))
      case OP_LAND: REPRO_MAP_ALL((F)((a[i] != 0) && (b[i] != 0)))
      case OP_LOR: REPRO_MAP_ALL((F)((a[i] != 0) || (b[i] != 0)))
      case OP_WHERE: REPRO_MAP_ALL(a[i] != 0 ? b[i] : c[i])
      case OP_FLOOR:
      case OP_CEIL:
      case OP_TRUNC:
      case OP_ROUND: REPRO_MAP_ALL(a[i])
      default: break;
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) y[i] = map_elem_op<T>(w, a[i], b[i], c[i], pool);
}

// The operand byte d of op s for every register: the running values r
// (slot s), the inputs u (slot 0), a kept result (vals) or a constant.
template <int KR, typename F>
__device__ __forceinline__ void map_args(int d, int s, const F (&r)[KR],
                                         const F (&u)[KR],
                                         const F (*vals)[KR],
                                         const int* pool, F (&x)[KR]) {
  if (d & 0x80) {
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = F(0);
  } else if (d & kOpndConst) {
    const F k = map_const<F>(pool, d & 0x3F);
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = k;
  } else if (d == s) {
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = r[i];
  } else if (d == 0) {
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = u[i];
  } else {
#pragma unroll
    for (int i = 0; i < KR; ++i) x[i] = vals[d - 1][i];
  }
}

// A map epilogue (its tape's words at tape, n ops) on a thread's
// registers, op by op: the running values and the inputs in registers,
// the results a later op reads again (their keep bit) in a per-thread
// array. Out of line: one copy of the tape code a kernel, not one a
// planar value and call site (the registers pass through local memory
// once a map).
template <int KR, typename T>
__device__ __noinline__ void map_regs(const int* tape, int n, T (&v)[KR]) {
  using F = typename MapOf<T>::type;
  const int* ops = tape + 1;
  const int* pool = ops + n;
  F u[KR], r[KR], vals[kTapeMax][KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) r[i] = u[i] = widen(v[i]);
  for (int s = 0; s < n; ++s) {
    const int w = ops[s];
    F a[KR], b[KR], c[KR];
    map_args((w >> 8) & 0xFF, s, r, u, vals, pool, a);
    map_args((w >> 16) & 0xFF, s, r, u, vals, pool, b);
    map_args((w >> 24) & 0xFF, s, r, u, vals, pool, c);
    map_step<T>(w, a, b, c, r, pool);
    if (w & 0x80) {
#pragma unroll
      for (int i = 0; i < KR; ++i) vals[s][i] = r[i];
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) narrow_to(r[i], v[i]);
}

#ifdef REPRO_MAP_EXT
// =====================================================================
// The ext build (compiled with -DREPRO_MAP_EXT=1 and =2 into the
// libraries tile_fused_ext1/2 and tile_bwd_ext1/2, which hold the map
// kernels only; the base libraries hold no code of this path): typed
// tapes (map_lower.Tape.typed), which hold casts, values of other dtypes
// than the map's and the ops past the register path's list. The base
// kernels have every map op's code cloned into each map kernel (ptxas
// compiles a kernel's callees with it); this path in every one of them
// cost the base build 58-70 % more (PERF.md), so it lives in kernels of
// its own, built beside the others, split in two parts by element class
// so that no ext library takes longer to build than its base library.
// =====================================================================
// The part of the ext build that instantiates class T's map kernels
// (build.ext_library picks the library by the same rule): 1 for int32,
// float32 and bfloat16, 2 for the other classes.
template <typename T>
inline constexpr int kExtPart = (std::is_same_v<T, int> ||
                                 std::is_same_v<T, float> ||
                                 std::is_same_v<T, Bf16>) ? 1 : 2;
// A float result rounded as the compute type rk holds it: 0 float32 (as
// it is), 1 bfloat16, 2 float16; float64 as it is.
__device__ __forceinline__ float rnd_k(float f, int rk) {
  return rk == 1 ? as_float(round_bf16(f))
                 : (rk == 2 ? as_float(round_f16(f)) : f);
}
__device__ __forceinline__ double rnd_k(double f, int) { return f; }
template <typename T>
inline constexpr int kRk = std::is_same_v<T, Bf16> ? 1
                           : (std::is_same_v<T, F16> ? 2 : 0);

// floor division of two values, as c10's div_floor_floating computes it
// in its type (a half float's every op rounded: the kernel's arithmetic
// is on c10::BFloat16 / c10::Half)
template <typename F>
__device__ __forceinline__ F floor_div_tt(F a, F b, int rk) {
  if (b == F(0)) return rnd_k(a / b, rk);
  const F mod = fmod(a, b);
  F div = rnd_k(rnd_k(a - mod, rk) / b, rk);
  if ((mod != F(0)) && (b < F(0)) != (mod < F(0))) div = rnd_k(div - F(1), rk);
  F fd;
  if (div != F(0)) {
    fd = floor(div);
    if (rnd_k(div - fd, rk) > F(0.5)) fd = rnd_k(fd + F(1), rk);
  } else {
    fd = copysign(F(0), rnd_k(a / b, rk));
  }
  return fd;
}

// The math functions of the ops past PyTorch's one-op activations, each
// out of line once a translation unit for float and for double (CUDA's
// float and double versions: tanf, tan, ...), shared by the forward ops
// and K5's derivative formulas: inlined into every switch they cost the
// build more than the kernels (PERF.md).
#define REPRO_MATH1(NAME, EXPR)                                        \
  __device__ __noinline__ float NAME(float a) { return EXPR; }         \
  __device__ __noinline__ double NAME(double a) { return EXPR; }
#define REPRO_MATH2(NAME, EXPR)                                        \
  __device__ __noinline__ float NAME(float a, float b) { return EXPR; } \
  __device__ __noinline__ double NAME(double a, double b) { return EXPR; }
REPRO_MATH1(m_tan, tan(a))
REPRO_MATH1(m_atan, atan(a))
REPRO_MATH1(m_asin, asin(a))
REPRO_MATH1(m_acos, acos(a))
REPRO_MATH1(m_sinh, sinh(a))
REPRO_MATH1(m_cosh, cosh(a))
REPRO_MATH1(m_asinh, asinh(a))
REPRO_MATH1(m_acosh, acosh(a))
REPRO_MATH1(m_atanh, atanh(a))
REPRO_MATH1(m_erfc, erfc(a))
REPRO_MATH1(m_log10, log10(a))
REPRO_MATH1(m_log, log(a))
REPRO_MATH1(m_exp, exp(a))
REPRO_MATH1(m_expm1, expm1(a))
REPRO_MATH1(m_sin, sin(a))
REPRO_MATH1(m_cos, cos(a))
REPRO_MATH1(m_rsqrt, rsqrt(a))
REPRO_MATH1(m_softplus_tanh, tanh(log1p(exp(a))))   // mish's tanh(softplus)
REPRO_MATH2(m_pow, pow(a, b))
REPRO_MATH2(m_atan2, atan2(a, b))
REPRO_MATH2(m_hypot, hypot(a, b))
__device__ __noinline__ float m_erfinv(float a) { return erfinvf(a); }
__device__ __noinline__ double m_erfinv(double a) { return erfinv(a); }
#undef REPRO_MATH1
#undef REPRO_MATH2

// The ops past PyTorch's one-op activations, in the compute type F (float
// for the types of 32 bits and less, before the caller rounds to the type;
// double for float64), as PyTorch's CUDA kernels write them (rk: the half
// float whose arithmetic a kernel rounds inside, kRk). d is a fourth
// operand (addcmul's and addcdiv's value, nan_to_num's -inf). Out of line
// (map_ext): one copy a translation unit and compute type.
template <typename F>
__device__ __forceinline__ F map_ext_f(int op, int rk, F a, F b, F c, F d) {
  const F kInf = F(INFINITY);
  const F zero(0.0f), three(3.0f), six(6.0f);
  const F one_sixth(1.0f / 6.0f);
  switch (op) {
    case OP_NAN_TO_NUM:
      return a != a ? b : (a == kInf ? c : (a == -kInf ? d : a));
    case OP_COPYSIGN: return copysign(a, b);
    case OP_POWT: return m_pow(a, b);
    case OP_ATAN2: return m_atan2(a, b);
    case OP_HYPOT: return m_hypot(a, b);
    case OP_LERP:
      return (fabs(c) < F(0.5)) ? a + c * (b - a)
                                : b - (b - a) * (F(1) - c);
    case OP_ADDCMUL:   // PyTorch's pointwise_op_impl: explicit FMAs
      return d == F(1) ? fma(b, c, a) : fma(d, b * c, a);
    case OP_ADDCDIV: return d == F(1) ? a + b / c : fma(d, b / c, a);
    case OP_ELU: return a > F(0) ? a : m_expm1(a * c) * b;
    case OP_ELU_SCALED: {
      const F negcoef = b * c;
      return a > F(0) ? a * c : m_expm1(a) * negcoef;
    }
    case OP_HARDSIGMOID: {   // std::min(std::max(a + 3, 0), 6) / 6
      const F lo = (a + three < zero) ? zero : a + three;
      return ((six < lo) ? six : lo) * one_sixth;
    }
    case OP_HARDSWISH: {
      const F lo = (a + three < zero) ? zero : a + three;
      return a * ((six < lo) ? six : lo) * one_sixth;
    }
    case OP_MISH: return a * m_softplus_tanh(a);
    case OP_LOGSIGMOID: {
      const F mn = (a < F(0)) ? a : F(0);
      const F z = m_exp(-fabs(a));
      return mn - log1p(z);
    }
    case OP_HARDSHRINK: return (a >= -b && a <= b) ? F(0) : a;
    case OP_SOFTSHRINK:
      return a != a ? a : (a > b ? a - b : (a < -b ? a + b : F(0)));
    case OP_THRESHOLD: return a <= b ? c : a;
    case OP_LOGIT: {
      if (b < F(0)) return m_log(a / (F(1) - a));
      const F hi = F(1) - b;
      const F z = a < b ? b : (a > hi ? hi : a);
      return m_log(z / (F(1) - z));
    }
    case OP_TAN: return m_tan(a);
    case OP_ATAN: return m_atan(a);
    case OP_ASIN: return m_asin(a);
    case OP_ACOS: return m_acos(a);
    case OP_SINH: return m_sinh(a);
    case OP_COSH: return m_cosh(a);
    case OP_ASINH: return m_asinh(a);
    case OP_ACOSH: return m_acosh(a);
    case OP_ATANH: return m_atanh(a);
    case OP_ERFC: return m_erfc(a);
    case OP_ERFINV: return m_erfinv(a);
    case OP_LOG10: return m_log10(a);
    case OP_XLOGY:
      if (b != b) return F(NAN);
      if (a == F(0)) return F(0);
      return a * m_log(b);
    case OP_SINC: {
      if (a == F(0)) return F(1);
      const F product = F(kPi) * a;
      return m_sin(product) / product;
    }
    case OP_ROUND_DEC: {   // in the type (a half float rounds each op)
      const F ten = rnd_k(b, rk);
      return c != F(0) ? rnd_k(nearbyint(rnd_k(a / ten, rk)), rk) * ten
                       : nearbyint(rnd_k(a * ten, rk)) / ten;
    }
    default: return a;   // not reached: map_op takes the others
  }
}
__device__ __noinline__ float map_ext(int op, int rk, float a, float b,
                                      float c, float d) {
  return map_ext_f(op, rk, a, b, c, d);
}
__device__ __noinline__ double map_ext(int op, int rk, double a, double b,
                                       double c, double d) {
  return map_ext_f(op, rk, a, b, c, d);
}

// ---------------------------------------------------------------------
// Typed tapes: each value a 64-bit word read as its own dtype: a float
// type of 32 bits and less as float32's bits (a half float's value
// exactly), float64's bits, an integer of 32 bits and less as int's bits
// (its wrapped value; bool 0 or 1), int64 as itself. Type word s (after
// the op words): the op's result and compute dtypes (TY_*, bits 0-3 and
// 4-7), which of its first three operands are bool values read as 0 or 1
// (bits 8-10) and a fourth operand's byte (bits 16-23). An op runs in one
// of four families, each one copy of the register path's ops for one
// element class: float32's (a half float rounded once at the end, as its
// class rounds each op; pow and floor division, which round inside, by
// the half float's rules), float64's, int's (wrapped to the type's width
// at the end, as the narrow classes wrap) and int64's; the ops past the
// list through map_ext; a cast as c10::convert casts: static_cast
// (saturating on the card, NaN to 0), into uint8 through int64, into the
// half floats through float32, into bool as x != 0. uint32 and uint64
// compute no op here (map_lower refuses them: they compare unsigned).
// ---------------------------------------------------------------------
using Word = unsigned long long;

template <typename T>
inline constexpr int kTypeOf =
    std::is_same_v<T, float> ? TY_F32
    : std::is_same_v<T, Bf16> ? TY_BF16
    : std::is_same_v<T, F16> ? TY_F16
    : std::is_same_v<T, double> ? TY_F64
    : std::is_same_v<T, I8> ? TY_I8
    : std::is_same_v<T, U8> ? TY_U8
    : std::is_same_v<T, I16> ? TY_I16
    : std::is_same_v<T, U16> ? TY_U16
    : std::is_same_v<T, U32> ? TY_U32
    : std::is_same_v<T, I64> ? TY_I64
    : std::is_same_v<T, U64> ? TY_U64 : TY_I32;

template <typename F>
__device__ __forceinline__ F word_as(Word w) {
  if constexpr (std::is_same_v<F, float>) return __uint_as_float((unsigned)w);
  else if constexpr (std::is_same_v<F, double>)
    return __longlong_as_double((long long)w);
  else if constexpr (std::is_same_v<F, int>) return (int)(unsigned)w;
  else return (long long)w;
}
__device__ __forceinline__ Word as_word(float v) { return __float_as_uint(v); }
__device__ __forceinline__ Word as_word(double v) {
  return (Word)__double_as_longlong(v);
}
__device__ __forceinline__ Word as_word(int v) { return (unsigned)v; }
__device__ __forceinline__ Word as_word(long long v) { return (Word)v; }
template <typename T>
__device__ __forceinline__ Word to_word(T v) { return as_word(widen(v)); }
template <typename T>
__device__ __forceinline__ void from_word(Word w, T& v) {
  narrow_to(word_as<typename MapOf<T>::type>(w), v);
}

// Value s of source type S cast to dtype `to`, as a word.
template <typename S>
__device__ __forceinline__ Word cast_from(S s, int to) {
  switch (to) {
    case TY_F32: return as_word(static_cast<float>(s));
    case TY_BF16: return as_word(as_float(round_bf16(static_cast<float>(s))));
    case TY_F16: return as_word(as_float(round_f16(static_cast<float>(s))));
    case TY_F64: return as_word(static_cast<double>(s));
    case TY_I32: return as_word(static_cast<int>(s));
    case TY_I8: return as_word((int)static_cast<int8_t>(s));
    case TY_U8:
      return as_word((int)static_cast<uint8_t>(static_cast<long long>(s)));
    case TY_I16: return as_word((int)static_cast<int16_t>(s));
    case TY_U16: return as_word((int)static_cast<uint16_t>(s));
    case TY_U32: return as_word((int)static_cast<unsigned>(s));
    case TY_I64: return as_word(static_cast<long long>(s));
    case TY_U64: return (Word)static_cast<unsigned long long>(s);
    default: return s != S(0);   // bool
  }
}
// Word w of dtype `from` cast to dtype `to`.
__device__ __noinline__ Word cast_word(Word w, int from, int to) {
  switch (from) {
    case TY_F32:
    case TY_BF16:
    case TY_F16: return cast_from(word_as<float>(w), to);
    case TY_F64: return cast_from(word_as<double>(w), to);
    case TY_U32: return cast_from((unsigned)w, to);
    case TY_I64: return cast_from((long long)w, to);
    case TY_U64: return cast_from((unsigned long long)w, to);
    default: return cast_from(word_as<int>(w), to);   // int, narrow, bool
  }
}

// A typed op's fourth operand (type word tw: its byte at bits 16-23), a
// constant, or 0 where it has none.
template <typename F>
__device__ __forceinline__ F fourth(int tw, const int* pool) {
  return ((tw >> 16) & 0xC0) == kOpndConst
             ? map_const<F>(pool, (tw >> 16) & 0x3F) : F(0);
}
// Operand i of a typed op (byte d, its value v) in the compute type F.
template <typename F>
__device__ __forceinline__ F typed_arg(int d, int tw, int i, Word v,
                                       const int* pool) {
  d &= 0xFF;
  if (d & 0x80) return F(0);
  if (d & kOpndConst) return map_const<F>(pool, d & 0x3F);
  if ((tw >> (8 + i)) & 1) return F((int)(v & 1u));   // a bool as 0 or 1
  return word_as<F>(v);
}

// map_pow<T> and floor_div<T, float> with T's rounding (rk) at run time.
__device__ __forceinline__ float map_pow_rk(float x, double e, int rk) {
  if (e == 0.0) return 1.0f;
  if (e == 1.0) return x;
  if (e == 0.5) return rnd_k(sqrtf(x), rk);
  if (e == -0.5) return rnd_k(rsqrtf(x), rk);
  if (e == -1.0) return rnd_k(__fdiv_rn(1.0f, x), rk);
  const float et = rnd_k((float)e, rk);
  if (et == 2.0f) return rnd_k(__fmul_rn(x, x), rk);
  if (et == 3.0f) return rnd_k(__fmul_rn(rnd_k(__fmul_rn(x, x), rk), x), rk);
  if (et == -2.0f)
    return rnd_k(__fdiv_rn(1.0f, rnd_k(__fmul_rn(x, x), rk)), rk);
  return rnd_k(powf(x, et), rk);
}
__device__ __forceinline__ float floor_div_rk(float a, float b, int rk) {
  if (b == 0.0f) return a / b;
  const float inv_b = 1.0f / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) * inv_b;
  if ((mod != 0.0f) && (b < 0.0f) != (mod < 0.0f)) div -= 1.0f;
  float fd;
  if (div != 0.0f) {
    fd = rnd_k(floorf(div), rk);
    if (div - fd > 0.5f) fd = rnd_k(fd + 1.0f, rk);
  } else {
    fd = copysignf(0.0f, a * inv_b);
  }
  return fd;
}

// The integer ops past the list, in int or long long.
template <typename I>
__device__ __forceinline__ I int_ext(int op, I a, I b, I c) {
  using U = std::make_unsigned_t<I>;
  switch (op) {
    case OP_POWT: {   // PyTorch's powi: a negative power of 1, -1 or 0
      if (b < 0) return a == 1 ? (I)1 : (a == -1 ? ((b & 1) ? a : (I)1) : (I)0);
      U r = 1, base = (U)a;
      for (U e = (U)b; e; e >>= 1) {
        if (e & 1) r *= base;
        base *= base;
      }
      return (I)r;
    }
    case OP_SIGNBIT: return a < 0;
    case OP_THRESHOLD: return a <= b ? c : a;
    default: return 0;   // isnan, isinf
  }
}
// An int value wrapped to the width of integer dtype t.
__device__ __forceinline__ int wrap_ty(int f, int t) {
  switch (t) {
    case TY_I8: return (int8_t)f;
    case TY_U8:
    case TY_BOOL: return (uint8_t)f;
    case TY_I16: return (int16_t)f;
    case TY_U16: return (uint16_t)f;
    default: return f;
  }
}

// One typed op in the float family: float32, bfloat16 or float16 (rk).
__device__ __noinline__ Word typed_float(int w, int tw, Word a, Word b,
                                         Word c, const int* pool) {
  const int op = w & 0x7F, ct = (tw >> 4) & 0xF;
  const int rk = ct == TY_BF16 ? 1 : (ct == TY_F16 ? 2 : 0);
  float x[1] = {typed_arg<float>(w >> 8, tw, 0, a, pool)};
  float y[1] = {typed_arg<float>(w >> 16, tw, 1, b, pool)};
  float z[1] = {typed_arg<float>(w >> 24, tw, 2, c, pool)};
  float r[1];
  if (op == OP_ISNAN) {
    r[0] = x[0] != x[0];
  } else if (op == OP_ISINF) {
    r[0] = fabsf(x[0]) == INFINITY;
  } else if (op == OP_SIGNBIT) {
    r[0] = signbit(x[0]);
  } else if (op > OP_SIGNBIT) {
    const float d = fourth<float>(tw, pool);
    r[0] = rnd_k(map_ext(op, rk, x[0], y[0], z[0], d), rk);
  } else if (op == OP_POW) {
    const int k = (w >> 16) & 0x3F;
    r[0] = map_pow_rk(x[0], __longlong_as_double(wide_const(
                                pool[2 * k], pool[2 * k + 1])), rk);
  } else if (op == OP_FLOORDIV) {
    r[0] = rnd_k(floor_div_rk(x[0], y[0], rk), rk);
  } else {
    map_step<float>(w, x, y, z, r, pool);
    r[0] = rnd_k(r[0], rk);
  }
  return (tw & 0xF) == TY_BOOL ? Word(r[0] != 0.0f) : as_word(r[0]);
}
// ... in float64
__device__ __noinline__ Word typed_double(int w, int tw, Word a, Word b,
                                          Word c, const int* pool) {
  const int op = w & 0x7F;
  double x[1] = {typed_arg<double>(w >> 8, tw, 0, a, pool)};
  double y[1] = {typed_arg<double>(w >> 16, tw, 1, b, pool)};
  double z[1] = {typed_arg<double>(w >> 24, tw, 2, c, pool)};
  double r[1];
  if (op == OP_ISNAN) {
    r[0] = x[0] != x[0];
  } else if (op == OP_ISINF) {
    r[0] = fabs(x[0]) == (double)INFINITY;
  } else if (op == OP_SIGNBIT) {
    r[0] = signbit(x[0]);
  } else if (op > OP_SIGNBIT) {
    r[0] = map_ext(op, 0, x[0], y[0], z[0],
                   fourth<double>(tw, pool));
  } else {
    map_step<double>(w, x, y, z, r, pool);
  }
  return (tw & 0xF) == TY_BOOL ? Word(r[0] != 0.0) : as_word(r[0]);
}
// ... in int (the integers of 32 bits and less, and bool) or int64
template <typename T, typename I>
__device__ __forceinline__ Word typed_int_of(int w, int tw, Word a, Word b,
                                             Word c, const int* pool) {
  const int op = w & 0x7F;
  I x[1] = {typed_arg<I>(w >> 8, tw, 0, a, pool)};
  I y[1] = {typed_arg<I>(w >> 16, tw, 1, b, pool)};
  I z[1] = {typed_arg<I>(w >> 24, tw, 2, c, pool)};
  I r[1];
  if (op > OP_CAST) r[0] = int_ext(op, x[0], y[0], z[0]);
  else map_step<T>(w, x, y, z, r, pool);
  if constexpr (std::is_same_v<I, int>) r[0] = wrap_ty(r[0], (tw >> 4) & 0xF);
  return (tw & 0xF) == TY_BOOL ? Word(r[0] != 0) : as_word(r[0]);
}
__device__ __noinline__ Word typed_int(int w, int tw, Word a, Word b, Word c,
                                       const int* pool) {
  return typed_int_of<int, int>(w, tw, a, b, c, pool);
}
__device__ __noinline__ Word typed_long(int w, int tw, Word a, Word b,
                                        Word c, const int* pool) {
  return typed_int_of<I64, long long>(w, tw, a, b, c, pool);
}

// Typed op w (type word tw) on one register: a cast, or the op in its
// compute dtype's family.
__device__ __noinline__ Word typed_op(int w, int tw, Word a, Word b, Word c,
                                      const int* pool) {
  const int ct = (tw >> 4) & 0xF;
  if ((w & 0x7F) == OP_CAST) return cast_word(a, ct, tw & 0xF);
  switch (ct) {
    case TY_F32:
    case TY_BF16:
    case TY_F16: return typed_float(w, tw, a, b, c, pool);
    case TY_F64: return typed_double(w, tw, a, b, c, pool);
    case TY_I64: return typed_long(w, tw, a, b, c, pool);
    default: return typed_int(w, tw, a, b, c, pool);
  }
}

// A typed tape (its words at tape, n ops) on a thread's registers as
// words, op by op, every slot's values kept. Out of line, one copy a
// register count.
template <int KR>
__device__ __noinline__ void map_regs_typed(const int* tape, int n,
                                            Word (&v)[KR]) {
  const int* ops = tape + 1;
  const int* tys = ops + n;
  const int* pool = tys + n;
  Word vals[kTapeMax + 1][KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) vals[0][i] = v[i];
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
#pragma unroll
  for (int i = 0; i < KR; ++i) v[i] = vals[n][i];
}

// map_regs for a typed tape: the registers as words and back.
template <int KR, typename T>
__device__ __noinline__ void map_regs_of_typed(const int* tape, int n,
                                               T (&v)[KR]) {
  Word wv[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) wv[i] = to_word(v[i]);
  map_regs_typed<KR>(tape, n, wv);
#pragma unroll
  for (int i = 0; i < KR; ++i) from_word(wv[i], v[i]);
}

// A float-family tape (EP_MAP_TYPED 2: every value float32, bfloat16,
// float16 or bool, the map's dtype one of the three; map_lower's
// Tape.mixed): the register path's code on float registers, each op
// computed as float32's class computes it and rounded once to its type
// (kRk of the type word's compute dtype), a cast as the rounding to its
// result's type, pow and floor division by the half float's own rules,
// the ops past the list through map_ext. The casts around a float32
// computation of a half-float map (tanh(v.float()).to(v.dtype)) take no
// word and no call.
__device__ __forceinline__ int rk_of(int t) {
  return t == TY_BF16 ? 1 : (t == TY_F16 ? 2 : 0);
}
template <int KR>
__device__ __forceinline__ void mixed_step(int w, int tw, const float (&a)[KR],
                                           const float (&b)[KR],
                                           const float (&c)[KR],
                                           float (&y)[KR], const int* pool) {
  const int op = w & 0x7F, rk = rk_of((tw >> 4) & 0xF);
  if (op == OP_CAST) {   // from bool: 0 and 1 as they are
    const int rr = rk_of(tw & 0xF);
#pragma unroll
    for (int i = 0; i < KR; ++i) y[i] = rnd_k(a[i], rr);
  } else if (op == OP_ISNAN) {
#pragma unroll
    for (int i = 0; i < KR; ++i) y[i] = a[i] != a[i];
  } else if (op == OP_ISINF) {
#pragma unroll
    for (int i = 0; i < KR; ++i) y[i] = fabsf(a[i]) == INFINITY;
  } else if (op == OP_SIGNBIT) {
#pragma unroll
    for (int i = 0; i < KR; ++i) y[i] = signbit(a[i]);
  } else if (op > OP_SIGNBIT) {
    const float d = fourth<float>(tw, pool);
#pragma unroll
    for (int i = 0; i < KR; ++i)
      y[i] = rnd_k(map_ext(op, rk, a[i], b[i], c[i], d), rk);
  } else if (op == OP_POW) {
    const int k = (w >> 16) & 0x3F;
    const double e = __longlong_as_double(wide_const(pool[2 * k],
                                                     pool[2 * k + 1]));
#pragma unroll
    for (int i = 0; i < KR; ++i) y[i] = map_pow_rk(a[i], e, rk);
  } else if (op == OP_FLOORDIV) {
#pragma unroll
    for (int i = 0; i < KR; ++i)
      y[i] = rnd_k(floor_div_rk(a[i], b[i], rk), rk);
  } else {
    map_step<float>(w, a, b, c, y, pool);
    if (rk) {
#pragma unroll
      for (int i = 0; i < KR; ++i) y[i] = rnd_k(y[i], rk);
    }
  }
}
// map_regs for a float-family tape, its words at tape (type words after
// the op words): the structure of map_regs.
template <int KR, typename T>
__device__ __noinline__ void map_regs_mixed(const int* tape, int n,
                                            T (&v)[KR]) {
  const int* ops = tape + 1;
  const int* tys = ops + n;
  const int* pool = tys + n;
  float u[KR], r[KR], vals[kTapeMax][KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) r[i] = u[i] = widen(v[i]);
  for (int s = 0; s < n; ++s) {
    const int w = ops[s];
    float a[KR], b[KR], c[KR];
    map_args((w >> 8) & 0xFF, s, r, u, vals, pool, a);
    map_args((w >> 16) & 0xFF, s, r, u, vals, pool, b);
    map_args((w >> 24) & 0xFF, s, r, u, vals, pool, c);
    mixed_step(w, tys[s], a, b, c, r, pool);
    if (w & 0x80) {
#pragma unroll
      for (int i = 0; i < KR; ++i) vals[s][i] = r[i];
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) narrow_to(r[i], v[i]);
}
#endif  // REPRO_MAP_EXT

// Epilogue e of the plan (staged record ep, device record gep) on the
// registers of a thread whose positions are qb ^ qr(i); chunk `chunk`.
// kPairs: integer values and keys compare through cmp_pairs. A butterfly
// runs on planar pairs (DV 2) of float32, bfloat16, float16 or float64.
template <bool kMask, bool kPairs = false, int DV, int KR, typename T>
__device__ __forceinline__ void forward_epilogue(const int* ep,
                                                 const long long* gep,
                                                 T (&v)[DV][KR],
                                                 unsigned (&m)[DV][KR],
                                                 unsigned qb, unsigned chunk,
                                                 int outer_bits) {
  const int vreg = ep[EP_VREG], vlane = ep[EP_VLANE];
  const unsigned hx = hi_bits(ep, qb);
  if (ep[EP_KIND] == 0) {
    const int shift = ep[EP_SHIFT];
    if constexpr (kPairs && (std::is_same_v<T, int> ||
                             std::is_same_v<T, Key> ||
                             std::is_same_v<T, Key64>)) {
      REPRO_VREG_SWITCH(vreg, (cmp_pairs<VR, kMask>(v, m, hx, vlane, shift)))
    } else {
      REPRO_VREG_SWITCH(vreg, (cmp_regs<VR, kMask>(v, m, hx, vlane, shift)))
    }
  } else {
    if constexpr (DV == 2) {
      using TW = typename TwOf<T>::type;
      const TW* w = reinterpret_cast<const TW*>(__ldg(gep + EP_W));
      unsigned tw[KR];
      tw_index(ep, tw_thread(ep, chunk, outer_bits), tw);
      REPRO_VREG_SWITCH(vreg, (bfly_regs<VR>(v, hx, vlane, w, tw)))
    }
  }
}

// Epilogues e0 .. e1 - 1 of a phase (staged plan sp, device plan gp; the
// records from word ebase) on a thread's registers. A compare cluster's
// float, bfloat16, float16 or float64 values run on keys (integer
// compares, as cheap as int32's; 64-bit ones for float64) in every warp
// whose values hold no NaN; a warp holds every partner of its positions
// within a phase, so the test is the warp's own. Integers other than int32
// always run on keys (the forward pass only: no compare bits are kept for
// them).
template <bool kMask, bool kPairs, int DV, int KR, typename T>
__device__ __forceinline__ void forward_epilogues_of(
    const int* sp, const long long* gp, int ebase, int e0, int e1,
    T (&v)[DV][KR], unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits);

template <bool kMask, bool kPairs = false, int DV, int KR, typename T>
__device__ __forceinline__ void forward_epilogues(
    const int* sp, const long long* gp, int ebase, int e0, int e1,
    T (&v)[DV][KR], unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits) {
  if constexpr (!kFloatElem<T> && !std::is_same_v<T, int>) {
    static_assert(DV == 1 && !kMask, "integers: single values, forward");
    typename KeyOf<T>::type kv[1][KR];
#pragma unroll
    for (int i = 0; i < KR; ++i) kv[0][i] = to_key(v[0][i]);
    for (int e = e0; e < e1; ++e) {
      const int off = ebase + e * kEpiWords;
      forward_epilogue<kMask, kPairs>(sp + off, gp + off, kv, m, qb, chunk,
                                      outer_bits);
    }
#pragma unroll
    for (int i = 0; i < KR; ++i) from_key(kv[0][i], v[0][i]);
    return;
  } else {
    forward_epilogues_of<kMask, kPairs>(sp, gp, ebase, e0, e1, v, m, qb,
                                        chunk, outer_bits);
  }
}

// forward_epilogues for int32 and the float types.
template <bool kMask, bool kPairs, int DV, int KR, typename T>
__device__ __forceinline__ void forward_epilogues_of(
    const int* sp, const long long* gp, int ebase, int e0, int e1,
    T (&v)[DV][KR], unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits) {
  if constexpr (DV == 1 && !std::is_same_v<T, int>) {
    bool nan = false;
#pragma unroll
    for (int i = 0; i < KR; ++i) nan |= is_nan(v[0][i]);
    if (!__any_sync(0xffffffffu, nan)) {
      typename KeyOf<T>::type kv[1][KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) kv[0][i] = to_key(v[0][i]);
      for (int e = e0; e < e1; ++e) {
        const int off = ebase + e * kEpiWords;
        forward_epilogue<kMask, kPairs>(sp + off, gp + off, kv, m, qb,
                                        chunk, outer_bits);
      }
#pragma unroll
      for (int i = 0; i < KR; ++i) from_key(kv[0][i], v[0][i]);
      return;
    }
  }
  for (int e = e0; e < e1; ++e) {
    const int off = ebase + e * kEpiWords;
    forward_epilogue<kMask, kPairs>(sp + off, gp + off, v, m, qb, chunk,
                                    outer_bits);
  }
}

// Where K5 keeps map slot `slot`'s input values of chunk `chunk`: one
// value per register and thread (beside butterflies, slot 2 * map + c for
// planar value c).
template <int KR, typename T>
__device__ __forceinline__ T* map_save_at(T* save, int slot, unsigned chunk,
                                          int outer_bits) {
  return save + ((((size_t)slot << outer_bits) + chunk) * KR) *
                    REPRO_THREADS + threadIdx.x;
}

// Epilogues e0 .. e1 - 1 of one phase on the registers. With kMaps, the
// compares and butterflies between two maps run as forward_epilogues runs
// them, with their own NaN vote and keys, and each map on the values (on
// both planar values of a butterfly cluster's register slots); K5 passes
// `save`: the input values of each map that keeps them (map_save_at; a
// map with EP_MAP_FROM >= 0 keeps none), for its transposed sweep.
template <bool kMask, bool kMaps, bool kPairs = false, int DV, int KR,
          typename T>
__device__ __forceinline__ void run_epilogues(
    const int* sp, const long long* gp, int ebase, int e0, int e1,
    bool maps, T (&v)[DV][KR], unsigned (&m)[DV][KR], unsigned qb,
    unsigned chunk, int outer_bits, T* save) {
  if constexpr (!kMaps) {
    forward_epilogues<kMask, kPairs>(sp, gp, ebase, e0, e1, v, m, qb, chunk,
                                     outer_bits);
  } else {
    int e = e0;
    for (;;) {
      int s = e1;   // the run e .. s - 1 ends at the next map
      if (maps) {
        s = e;
        while (s < e1 && sp[ebase + s * kEpiWords + EP_KIND] != kKindMap) ++s;
      }
      if (s > e)
        forward_epilogues<kMask, kPairs>(sp, gp, ebase, e, s, v, m, qb,
                                         chunk, outer_bits);
      if (s == e1) return;
      const int* ep = sp + ebase + s * kEpiWords;
      const int* tape = sp + ep[EP_MAP_TAPE];
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        if (save != nullptr && ep[EP_MAP_FROM] < 0) {
          T* at = map_save_at<KR>(save, ep[EP_MAP_SLOT] * DV + c, chunk,
                                  outer_bits);
#pragma unroll
          for (int i = 0; i < KR; ++i) at[i * REPRO_THREADS] = v[c][i];
        }
#ifdef REPRO_MAP_EXT
        if (ep[EP_MAP_TYPED]) {
          if constexpr (kFloatElem<T> && !std::is_same_v<T, double>) {
            if (ep[EP_MAP_TYPED] == 2) {
              map_regs_mixed(tape, ep[EP_MAP_LEN], v[c]);
              continue;
            }
          }
          map_regs_of_typed(tape, ep[EP_MAP_LEN], v[c]);
          continue;
        }
#endif
        map_regs(tape, ep[EP_MAP_LEN], v[c]);
      }
      e = s + 1;
    }
  }
}

// A phase's epilogues (staged record ph). The kernels are compiled
// without maps (kMaps false: exactly the compare and butterfly code) and,
// for clusters that hold maps, with them: the map code's registers would
// otherwise cost the map-free clusters 3-8 % of their time on the H100
// (PERF.md).
template <bool kMask, bool kMaps, bool kPairs = false, int DV, int KR,
          typename T>
__device__ __forceinline__ void phase_epilogues(
    const int* ph, const int* sp, const long long* gp, int ebase,
    T (&v)[DV][KR], unsigned (&m)[DV][KR], unsigned qb, unsigned chunk,
    int outer_bits, T* save) {
  run_epilogues<kMask, kMaps, kPairs>(sp, gp, ebase, ph[PH_E0], ph[PH_E1],
                                      ph[PH_MAPS] != 0, v, m, qb, chunk,
                                      outer_bits, save);
}

// A thread's place in a phase (staged record ph): its position bits,
// which registers hold a position (none when the layout leaves one of its
// lane or warp bits empty) and the register images.
struct PhaseRegs {
  unsigned qt, valid;
  RegImages qr;
  __device__ __forceinline__ explicit PhaseRegs(const int* ph)
      : qt(image_of(ph + PH_IMG_THR, threadIdx.x, 8)),
        valid((threadIdx.x & (unsigned)ph[PH_TID_INVALID])
                  ? 0u : (unsigned)ph[PH_REG_VALID]),
        qr(ph + PH_IMG_REG) {}
};

// The word a tile of T moves in (its own width: the kernels with
// epilogues are compiled once per element class).
template <typename T>
struct ElemWord {
  using type = std::conditional_t<
      sizeof(T) == 1, uint8_t,
      std::conditional_t<
          sizeof(T) == 2, uint16_t,
          std::conditional_t<sizeof(T) == 4, uint32_t,
                             unsigned long long>>>;
};
