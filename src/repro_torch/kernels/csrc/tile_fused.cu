// K4b: the one-pass tiled BMMC with fused compute epilogues (DESIGN.md
// §10): compare-exchange (cmp) and radix-2 butterfly (bfly) stages run on
// the tile in shared memory, in order, before the intra-tile gather.
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
// then gathers out.flat[r * 2^t + l] = tile.flat[src0.flat[r * 2^t +
// (l ^ xor_low[g])]] into whole rows at out_rows[g].
//
// Bound on the H100: bytes. Each element is read once and written once;
// the row tables add 8 bytes per row, the epilogue tables a few bytes
// per row and lane, and a butterfly reads one 8-byte twiddle per pair
// (the table itself, 2^(n-1) x 8 bytes, stays in the 50 MB L2 cache).
// The arithmetic is a few operations per element per epilogue, far below
// the card's rate.
//
// This design: the load and the gather are K4a's (tile_common.cuh), so a
// fused pass moves its bytes exactly as a plain tiled pass does. Between
// them the block runs the epilogues on its tile:
//   * one thread owns each pair — the position whose bit at the lowest
//     set bit of the combined XOR (vr << t | vc) is 0 — reads both
//     members, computes both outputs and writes both, so no pair is read
//     after its partner was rewritten; a __syncthreads() separates the
//     epilogues and the last one from the gather;
//   * elements are typed (T = int32, float, or bfloat16 kept as its bits)
//     while the load and the gather move raw words;
//   * min and max propagate NaN (fmaxf/fminf would drop it) and order
//     -0 below +0: equal operands give their bitwise AND (max) or OR
//     (min), as cmp_max / cmp_min in bmmc_permute.py do;
//   * the butterfly rounds every product and sum on its own
//     (__fmul_rn/__fadd_rn/__fsub_rn: no contraction into FMAs), so it
//     is bit-equal to the plain PyTorch version on the card;
//   * the epilogue descriptors (kind, vr, vc and seven table pointers,
//     int64 each) are read from device memory, so a cluster may carry any
//     number of epilogues; each epilogue's row, lane and per-tile tables
//     are staged in shared memory once per block, before the tile.
#include "tile_common.cuh"

struct Bf16 {   // bfloat16 as its bits; compared through float
  uint16_t bits;
};

__device__ __forceinline__ float as_float(Bf16 v) {
  return __uint_as_float((unsigned)v.bits << 16);
}

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

template <typename W, typename T>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_fused_kernel(const W* __restrict__ x, W* __restrict__ out,
                  const int* __restrict__ in_rows,
                  const int* __restrict__ out_rows,
                  const int* __restrict__ xor_low,
                  const int* __restrict__ src0,
                  const long long* __restrict__ epis, int n_epi, int n_rows,
                  int rpt_shift, int tiles_per_cta, int t, int wpe,
                  int wpe_shift, int row_shift, int pad_words,
                  long long batch, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rpt = 1 << rpt_shift;
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  int* s_epi = reinterpret_cast<int*>(smem + tab_bytes);
  unsigned char* tile_bytes =
      smem + tab_bytes + epi_table_bytes(n_epi, rpt, t, tiles_per_cta);
  W* tile = reinterpret_cast<W*>(tile_bytes);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  const unsigned stride_bytes = stride * (unsigned)sizeof(W);
  const unsigned elem_bytes = (unsigned)wpe * (unsigned)sizeof(W);
  const unsigned lane_mask = (1u << t) - 1, rpt_mask = (1u << rpt_shift) - 1;
  const int slot = epi_slot(rpt, t, tiles_per_cta);
  const int half = slot / 2;
  // element k of tile position q (q = tile row << t | lane)
  auto at = [&](unsigned q, int k) -> T* {
    return reinterpret_cast<T*>(tile_bytes + (q >> t) * stride_bytes +
                                (q & lane_mask) * elem_bytes) + k;
  };
  REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low, g0,
                         rpt_shift, rows, tiles_per_cta)
  // every epilogue's row, lane and tile tables (hi, then twiddle index)
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
  const unsigned span = (unsigned)rows * row_words;
  const unsigned pairs = ((unsigned)rows << t) >> 1;
  const long long batch_words = (long long)n_rows * row_words;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const W* xb = x + b * batch_words;
    W* ob = out + b * batch_words;
    __syncthreads();  // tables ready; the previous batch row's reads done
    REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift,
                         stride)
    for (int e = 0; e < n_epi; ++e) {
      __syncthreads();  // the tile (or the previous epilogue) complete
      const long long* ep = epis + (long long)e * kEpiWords;
      const int kind = (int)__ldg(ep + 0);
      const unsigned vr = (unsigned)__ldg(ep + 1), vc = (unsigned)__ldg(ep + 2);
      const int* tab = s_epi + e * slot;
      const unsigned v = (vr << t) | vc;           // partner XOR of q
      const int low = __ffs((int)v) - 1;           // its lowest set bit
      const unsigned below = (1u << low) - 1;
      // the table entry of position q: row, lane and tile terms XORed
      auto term = [&](const int* tb, unsigned q) -> int {
        const unsigned r = q >> t;
        return tb[r & rpt_mask] ^ tb[rpt + (q & lane_mask)] ^
               tb[rpt + row_len + (r >> rpt_shift)];
      };
      if (kind == 0) {
        const unsigned work = pairs * (unsigned)d;
        for (unsigned i = threadIdx.x; i < work; i += REPRO_THREADS) {
          const unsigned pi = d == 1 ? i : i / (unsigned)d;
          const int k = (int)(i - pi * (unsigned)d);
          const unsigned q = ((pi & ~below) << 1) | (pi & below);
          const unsigned p = q ^ v;
          const T a = *at(q, k), c = *at(p, k);
          *at(q, k) = term(tab, q) ? cmp_max(a, c) : cmp_min(a, c);
          *at(p, k) = term(tab, p) ? cmp_max(c, a) : cmp_min(c, a);
        }
      } else {
        const float2* w = reinterpret_cast<const float2*>(__ldg(ep + 9));
        const int* tw = tab + half;
        for (unsigned pi = threadIdx.x; pi < pairs; pi += REPRO_THREADS) {
          const unsigned q = ((pi & ~below) << 1) | (pi & below);
          const unsigned p = q ^ v;
          float* fq = reinterpret_cast<float*>(at(q, 0));
          float* fp = reinterpret_cast<float*>(at(p, 0));
          const float q_re = fq[0], q_im = fq[1], p_re = fp[0], p_im = fp[1];
          const float2 wq = __ldg(w + term(tw, q)), wp = __ldg(w + term(tw, p));
          float oq[2], op[2];
          bfly_out(term(tab, q) != 0, q_re, q_im, p_re, p_im, wq.x, wq.y, oq);
          bfly_out(term(tab, p) != 0, p_re, p_im, q_re, q_im, wp.x, wp.y, op);
          fq[0] = oq[0];
          fq[1] = oq[1];
          fp[0] = op[0];
          fp[1] = op[1];
        }
      }
    }
    __syncthreads();
    REPRO_TILE_GATHER_STORE(ob, tile, s_out, s_xl, src0, span, row_words,
                            row_shift, wpe, wpe_shift, t, rpt_shift,
                            rpt_mask, row_len, stride)
  }
}

template <typename T>
static int launch_fused(const void* x, void* out, const int* in_rows,
                        const int* out_rows, const int* xor_low,
                        const int* src0, const long long* epis, int n_epi,
                        int n_tiles, int n_rows, int rpt_shift,
                        int tiles_per_cta, int t, int wpe, int wpe_shift,
                        int row_shift, int pad_words, long long batch,
                        int word_bytes, int d, cudaStream_t s) {
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem =
        REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words) +
        (size_t)epi_table_bytes(n_epi, 1 << rpt_shift, t, tiles_per_cta);
    cudaError_t e = allow_smem(tile_fused_kernel<W, T>, smem);
    if (e != cudaSuccess) return (int)e;
    tile_fused_kernel<W, T><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, epis, n_epi,
        n_rows, rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift,
        pad_words, batch, d);
  });
  return (int)cudaGetLastError();
}

// elem_type: 0 = int32, 1 = float32, 2 = bfloat16.
extern "C" int repro_tile_fused(const void* x, void* out, const int* in_rows,
                                const int* out_rows, const int* xor_low,
                                const int* src0, const long long* epis,
                                int n_epi, int n_tiles, int n_rows,
                                int rpt_shift, int tiles_per_cta, int t,
                                int wpe, int wpe_shift, int row_shift,
                                int pad_words, long long batch,
                                int word_bytes, int elem_type, int d,
                                void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 ||
      n_epi <= 0 || d <= 0 || epis == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_type) {
    case 0:
      return launch_fused<int>(x, out, in_rows, out_rows, xor_low, src0, epis,
                               n_epi, n_tiles, n_rows, rpt_shift,
                               tiles_per_cta, t, wpe, wpe_shift, row_shift,
                               pad_words, batch, word_bytes, d, s);
    case 1:
      return launch_fused<float>(x, out, in_rows, out_rows, xor_low, src0,
                                 epis, n_epi, n_tiles, n_rows, rpt_shift,
                                 tiles_per_cta, t, wpe, wpe_shift, row_shift,
                                 pad_words, batch, word_bytes, d, s);
    case 2:
      return launch_fused<Bf16>(x, out, in_rows, out_rows, xor_low, src0,
                                epis, n_epi, n_tiles, n_rows, rpt_shift,
                                tiles_per_cta, t, wpe, wpe_shift, row_shift,
                                pad_words, batch, word_bytes, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
