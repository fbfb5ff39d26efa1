// The compute epilogues of a fused tiled pass, shared by K4b
// (tile_fused.cu), which applies them on the way out of a tile, and K5
// (tile_bwd.cu), which replays them on the saved input to recover the
// masks of its transposed compares. One copy of this code is what makes
// the replay bit-equal to the forward pass.
//
// An epilogue descriptor is kEpiWords int64 words in device memory:
// kind (0 cmp, 1 bfly), the partner XOR (vr, vc), then seven table
// pointers (hi_row, hi_lane, hi_base, tw_row, tw_lane, tw_base, w). A
// block stages each epilogue's row, lane and per-tile tables in shared
// memory (stage_epi_tables) before its tile.
#pragma once

#include "words.cuh"

struct Bf16 {   // bfloat16 as its bits; compared through float
  uint16_t bits;
};

__device__ __forceinline__ float as_float(Bf16 v) {
  return __uint_as_float((unsigned)v.bits << 16);
}
__device__ __forceinline__ float as_float(float v) { return v; }

__device__ __forceinline__ int cmp_max(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int cmp_min(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float cmp_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

__device__ __forceinline__ float cmp_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return __int_as_float(__float_as_int(a) | __float_as_int(b));
}

__device__ __forceinline__ Bf16 cmp_max(Bf16 a, Bf16 b) {
  const float fa = as_float(a), fb = as_float(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  if (fa > fb) return a;
  if (fb > fa) return b;
  return Bf16{(uint16_t)(a.bits & b.bits)};
}

__device__ __forceinline__ Bf16 cmp_min(Bf16 a, Bf16 b) {
  const float fa = as_float(a), fb = as_float(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  if (fa < fb) return a;
  if (fb < fa) return b;
  return Bf16{(uint16_t)(a.bits | b.bits)};
}

constexpr int kEpiWords = 10;   // kind, vr, vc, hi_row, hi_lane, hi_base,
                                // tw_row, tw_lane, tw_base, w

// One butterfly output, exactly as the reference writes it: `hi` says
// whether this position holds the pair's "hi" member.
__device__ __forceinline__ void bfly_out(bool hi, float v_re, float v_im,
                                         float p_re, float p_im, float wr,
                                         float wi, float* o) {
  const float lo_re = hi ? p_re : v_re, lo_im = hi ? p_im : v_im;
  const float hr = hi ? v_re : p_re, him = hi ? v_im : p_im;
  const float t_re = __fsub_rn(__fmul_rn(wr, hr), __fmul_rn(wi, him));
  const float t_im = __fadd_rn(__fmul_rn(wr, him), __fmul_rn(wi, hr));
  o[0] = hi ? __fsub_rn(lo_re, t_re) : __fadd_rn(lo_re, t_re);
  o[1] = hi ? __fsub_rn(lo_im, t_im) : __fadd_rn(lo_im, t_im);
}

// Ints of one epilogue's tables staged in shared memory: hi_row[rpt],
// hi_lane[2^t], hi_base[tiles of the block], then the same three for the
// twiddle index (bfly).
__host__ __device__ __forceinline__ int epi_slot(int rpt, int t,
                                                 int tiles_per_cta) {
  return 2 * (rpt + (1 << t) + tiles_per_cta);
}

__host__ __device__ __forceinline__ int epi_table_bytes(int n_epi, int rpt,
                                                        int t,
                                                        int tiles_per_cta) {
  return (n_epi * epi_slot(rpt, t, tiles_per_cta) * 4 + 15) & ~15;
}

// Every epilogue's row, lane and tile tables (hi, then twiddle index) into
// shared memory at s_epi, for the tiles g0.. of this block.
__device__ __forceinline__ void stage_epi_tables(int* s_epi,
                                                 const long long* epis,
                                                 int n_epi, int rpt,
                                                 int row_len, int slot,
                                                 long long g0) {
  const int half = slot / 2;
  for (int e = 0; e < n_epi; ++e) {
    const long long* ep = epis + (long long)e * kEpiWords;
    const bool bfly = __ldg(ep + 0) == 1;
    int* dst = s_epi + e * slot;
    for (int part = 0; part < (bfly ? 2 : 1); ++part) {
      const int* row_t = reinterpret_cast<const int*>(__ldg(ep + 3 + 3 * part));
      const int* lane_t = reinterpret_cast<const int*>(__ldg(ep + 4 + 3 * part));
      const int* base_t = reinterpret_cast<const int*>(__ldg(ep + 5 + 3 * part));
      int* o = dst + part * half;
      for (int i = threadIdx.x; i < half; i += REPRO_THREADS)
        o[i] = i < rpt ? __ldg(row_t + i)
                       : (i < rpt + row_len ? __ldg(lane_t + (i - rpt))
                                            : __ldg(base_t + g0 + (i - rpt - row_len)));
    }
  }
}

// The typed view of a block's tile in shared memory: position q (tile row
// << t | lane) of element type T, with `d` elements per position, each row
// `stride_bytes` apart.
struct TileView {
  unsigned char* bytes;
  unsigned stride_bytes, elem_bytes, lane_mask, rpt_mask;
  int t, rpt_shift, rpt, row_len;

  // element k of tile position q
  template <typename T>
  __device__ __forceinline__ T* at(unsigned q, int k) const {
    return reinterpret_cast<T*>(bytes + (q >> t) * stride_bytes +
                                (q & lane_mask) * elem_bytes) + k;
  }
  // the table entry of position q: row, lane and tile terms XORed
  __device__ __forceinline__ int term(const int* tb, unsigned q) const {
    const unsigned r = q >> t;
    return tb[r & rpt_mask] ^ tb[rpt + (q & lane_mask)] ^
           tb[rpt + row_len + (r >> rpt_shift)];
  }
};

// A hook that sees nothing: K4b's. K5 passes one that records, for each
// compare, which inputs equal each output.
struct NoHook {
  template <typename T>
  __device__ __forceinline__ void operator()(unsigned, unsigned, T, T, T,
                                             T) const {}
};

// The pair that thread-step `pi` owns under partner XOR v: the position
// whose bit at the lowest set bit of v (`below` = the bits under it) is 0.
__device__ __forceinline__ unsigned pair_owner(unsigned pi, unsigned below) {
  return ((pi & ~below) << 1) | (pi & below);
}

// Forward epilogue e (descriptor `ep`, staged tables `tab`) on the tile:
// position (r, c) pairs with (r ^ vr, c ^ vc);
//   cmp:  v = hi ? max(v, partner) : min(v, partner), over the tail d;
//   bfly: the planar butterfly with twiddle w[tw_row ^ tw_lane ^ tw_base].
// One thread owns each pair and writes both members. For every compare
// `hook(flat index of q, of p, in_q, in_p, out_q, out_p)` runs after the
// pair is written (flat index = position * d + k).
template <typename T, typename Hook>
__device__ __forceinline__ void forward_epilogue(const TileView& tv,
                                                 const long long* ep,
                                                 const int* tab, int half,
                                                 unsigned pairs, int d,
                                                 const Hook& hook) {
  const int kind = (int)__ldg(ep + 0);
  const unsigned vr = (unsigned)__ldg(ep + 1), vc = (unsigned)__ldg(ep + 2);
  const unsigned v = (vr << tv.t) | vc;            // partner XOR of q
  const int low = __ffs((int)v) - 1;               // its lowest set bit
  const unsigned below = (1u << low) - 1;
  if (kind == 0) {
    const unsigned work = pairs * (unsigned)d;
    for (unsigned i = threadIdx.x; i < work; i += REPRO_THREADS) {
      const unsigned pi = d == 1 ? i : i / (unsigned)d;
      const int k = (int)(i - pi * (unsigned)d);
      const unsigned q = pair_owner(pi, below);
      const unsigned p = q ^ v;
      const T a = *tv.at<T>(q, k), c = *tv.at<T>(p, k);
      const T oq = tv.term(tab, q) ? cmp_max(a, c) : cmp_min(a, c);
      const T op = tv.term(tab, p) ? cmp_max(c, a) : cmp_min(c, a);
      *tv.at<T>(q, k) = oq;
      *tv.at<T>(p, k) = op;
      hook(q * (unsigned)d + k, p * (unsigned)d + k, a, c, oq, op);
    }
  } else {
    const float2* w = reinterpret_cast<const float2*>(__ldg(ep + 9));
    const int* tw = tab + half;
    for (unsigned pi = threadIdx.x; pi < pairs; pi += REPRO_THREADS) {
      const unsigned q = pair_owner(pi, below);
      const unsigned p = q ^ v;
      float* fq = tv.at<float>(q, 0);
      float* fp = tv.at<float>(p, 0);
      const float q_re = fq[0], q_im = fq[1], p_re = fp[0], p_im = fp[1];
      const float2 wq = __ldg(w + tv.term(tw, q)), wp = __ldg(w + tv.term(tw, p));
      float oq[2], op[2];
      bfly_out(tv.term(tab, q) != 0, q_re, q_im, p_re, p_im, wq.x, wq.y, oq);
      bfly_out(tv.term(tab, p) != 0, p_re, p_im, q_re, q_im, wp.x, wp.y, op);
      fq[0] = oq[0];
      fq[1] = oq[1];
      fp[0] = op[0];
      fp[1] = op[1];
    }
  }
}
