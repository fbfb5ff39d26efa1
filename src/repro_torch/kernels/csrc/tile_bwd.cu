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
//   2. replays C1..Cm on the x tile (K4b's own code, tile_epilogue.cuh),
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
// once, 3 * size bytes over 3.35 TB/s, plus the tables; the arithmetic is
// a few operations per element per epilogue.
//
// This design: as K4a/K4b, the tiles are split among blocks that run in
// parallel, a block taking about 16 KiB of tiles per stream, loading and
// storing whole rows (coalesced) through tile_common.cuh's macros. The
// reference kept every intermediate tile of the replay; here a block
// keeps only the compare bits, one 32-bit word per element for up to 16
// compares (u == o in bit 2j, partner(u) == o in bit 2j + 1 of compare
// j), so a 12-compare cluster needs 16 KiB beside its two 16 KiB tiles.
// The x tile is free once the bits are taken, and the un-gathered
// cotangent takes its place. As in K4b one thread owns each pair and a
// barrier separates the epilogues.
#include "tile_common.cuh"
#include "tile_epilogue.cuh"

__device__ __forceinline__ Bf16 round_bf16(float f) {
  // round to nearest even, NaN as 0x7FC0: PyTorch's float -> bfloat16
  const unsigned u = __float_as_uint(f);
  if (f != f) return Bf16{(uint16_t)0x7FC0};
  return Bf16{(uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16)};
}

// a * ma + b * mb, each product and the sum rounded to T on their own
__device__ __forceinline__ float madd(float a, float ma, float b, float mb) {
  return __fadd_rn(__fmul_rn(a, ma), __fmul_rn(b, mb));
}
__device__ __forceinline__ Bf16 madd(Bf16 a, float ma, Bf16 b, float mb) {
  const Bf16 x = round_bf16(__fmul_rn(as_float(a), ma));
  const Bf16 y = round_bf16(__fmul_rn(as_float(b), mb));
  return round_bf16(__fadd_rn(as_float(x), as_float(y)));
}

// The compare bits of one element: bit 0 = (u == o), bit 1 = (P(u) == o).
__device__ __forceinline__ float mask_self(unsigned b) {    // m1
  return (b & 1u) ? ((b & 2u) ? 0.5f : 1.0f) : 0.0f;
}
__device__ __forceinline__ float mask_cross(unsigned b) {   // m2
  return (b & 2u) ? ((b & 1u) ? 0.5f : 1.0f) : 0.0f;
}

// Records the compare bits of one replayed compare into `m` at `bit`.
struct MaskHook {
  unsigned* m;
  int bit;
  template <typename T>
  __device__ __forceinline__ void operator()(unsigned eq, unsigned ep, T a,
                                             T c, T oq, T op) const {
    const float fa = as_float(a), fc = as_float(c);
    const float foq = as_float(oq), fop = as_float(op);
    m[eq] |= ((unsigned)(fa == foq) | ((unsigned)(fc == foq) << 1)) << bit;
    m[ep] |= ((unsigned)(fc == fop) | ((unsigned)(fa == fop) << 1)) << bit;
  }
};

// Transposed epilogue e on the cotangent tile (see step 4 above); `m` and
// `bit` locate its compare bits.
template <typename T>
__device__ __forceinline__ void transposed_epilogue(
    const TileView& tv, const long long* ep, const int* tab, int half,
    unsigned pairs, int d, const unsigned* m, int bit) {
  const int kind = (int)__ldg(ep + 0);
  const unsigned vr = (unsigned)__ldg(ep + 1), vc = (unsigned)__ldg(ep + 2);
  const unsigned v = (vr << tv.t) | vc;
  const unsigned below = (1u << (__ffs((int)v) - 1)) - 1;
  if (kind == 0) {
    const unsigned work = pairs * (unsigned)d;
    for (unsigned i = threadIdx.x; i < work; i += REPRO_THREADS) {
      const unsigned pi = d == 1 ? i : i / (unsigned)d;
      const int k = (int)(i - pi * (unsigned)d);
      const unsigned q = pair_owner(pi, below);
      const unsigned p = q ^ v;
      const unsigned bq = (m[q * (unsigned)d + k] >> bit) & 3u;
      const unsigned bp = (m[p * (unsigned)d + k] >> bit) & 3u;
      const T cq = *tv.at<T>(q, k), cp = *tv.at<T>(p, k);
      *tv.at<T>(q, k) = madd(cq, mask_self(bq), cp, mask_cross(bp));
      *tv.at<T>(p, k) = madd(cp, mask_self(bp), cq, mask_cross(bq));
    }
  } else {
    const float2* w = reinterpret_cast<const float2*>(__ldg(ep + 9));
    const int* tw = tab + half;
    for (unsigned pi = threadIdx.x; pi < pairs; pi += REPRO_THREADS) {
      const unsigned q = pair_owner(pi, below);
      const unsigned p = q ^ v;
      float* fq = tv.at<float>(q, 0);
      float* fp = tv.at<float>(p, 0);
      const float c[2][2] = {{fq[0], fq[1]}, {fp[0], fp[1]}};
      float o[2][2];
      for (int s = 0; s < 2; ++s) {        // s = 0: position q, 1: p
        const float* me = c[s];
        const float* pa = c[1 - s];
        if (tv.term(tab, s ? p : q)) {     // the pair's "hi" member
          const float2 wv = __ldg(w + tv.term(tw, s ? p : q));
          const float s_re = __fsub_rn(pa[0], me[0]);
          const float s_im = __fsub_rn(pa[1], me[1]);
          o[s][0] = __fadd_rn(__fmul_rn(wv.x, s_re), __fmul_rn(wv.y, s_im));
          o[s][1] = __fsub_rn(__fmul_rn(wv.x, s_im), __fmul_rn(wv.y, s_re));
        } else {
          o[s][0] = __fadd_rn(me[0], pa[0]);
          o[s][1] = __fadd_rn(me[1], pa[1]);
        }
      }
      fq[0] = o[0][0];
      fq[1] = o[0][1];
      fp[0] = o[1][0];
      fp[1] = o[1][1];
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

template <typename W, typename T>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_bwd_kernel(const W* __restrict__ x, const W* __restrict__ ct,
                W* __restrict__ out, const int* __restrict__ in_rows,
                const int* __restrict__ out_rows,
                const int* __restrict__ xor_low,
                const int* __restrict__ inv_src0,
                const long long* __restrict__ epis, int n_epi, int n_rows,
                int rpt_shift, int tiles_per_cta, int t, int wpe,
                int wpe_shift, int row_shift, int pad_words,
                long long batch, int d, int mask_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rpt = 1 << rpt_shift;
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  int* s_epi = reinterpret_cast<int*>(smem + tab_bytes);
  const size_t buf = tile_buf_bytes(rows, t, wpe, pad_words, sizeof(W));
  unsigned char* a_bytes =
      smem + tab_bytes + epi_table_bytes(n_epi, rpt, t, tiles_per_cta);
  W* tile = reinterpret_cast<W*>(a_bytes);             // x, then ct_pre
  W* ctile = reinterpret_cast<W*>(a_bytes + buf);      // ct as loaded
  unsigned* masks = reinterpret_cast<unsigned*>(a_bytes + 2 * buf);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  const unsigned rpt_mask = (1u << rpt_shift) - 1;
  const int slot = epi_slot(rpt, t, tiles_per_cta);
  const TileView tv{a_bytes, stride * (unsigned)sizeof(W),
                    (unsigned)wpe * (unsigned)sizeof(W), (1u << t) - 1,
                    rpt_mask, t, rpt_shift, rpt, row_len};
  REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low, g0,
                         rpt_shift, rows, tiles_per_cta)
  stage_epi_tables(s_epi, epis, n_epi, rpt, row_len, slot, g0);
  const unsigned span = (unsigned)rows * row_words;
  const unsigned pairs = ((unsigned)rows << t) >> 1;
  const unsigned elems = ((unsigned)rows << t) * (unsigned)d;
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
    for (unsigned i = threadIdx.x; i < elems * (unsigned)mask_words;
         i += REPRO_THREADS)
      masks[i] = 0u;
    // replay, keeping the compare bits
    int ci = 0;
    for (int e = 0; e < n_epi; ++e) {
      __syncthreads();
      const long long* ep = epis + (long long)e * kEpiWords;
      const MaskHook hook{masks + (size_t)(ci >> 4) * elems, 2 * (ci & 15)};
      forward_epilogue<T>(tv, ep, s_epi + e * slot, slot / 2, pairs, d, hook);
      if (__ldg(ep + 0) == 0) ++ci;
    }
    __syncthreads();
    // un-gather the cotangent into the x tile's place
#pragma unroll 4
    for (unsigned li = threadIdx.x; li < span; li += REPRO_THREADS) {
      const unsigned r = div_by(li, row_words, row_shift);
      const unsigned rem = li - r * row_words;
      const unsigned cp = div_by(rem, (unsigned)wpe, wpe_shift);
      const unsigned w = rem - cp * (unsigned)wpe;
      const unsigned j = r >> rpt_shift, rp = r & rpt_mask;
      const unsigned s =
          (unsigned)__ldg(inv_src0 + ((rp << t) | cp)) ^ (unsigned)s_xl[j];
      const unsigned rs = (j << rpt_shift) | (s >> t);
      const unsigned cs = s & (unsigned)(row_len - 1);
      tile[r * stride + rem] = ctile[rs * stride + cs * (unsigned)wpe + w];
    }
    // the transposed epilogues, last first
    for (int e = n_epi - 1; e >= 0; --e) {
      __syncthreads();
      const long long* ep = epis + (long long)e * kEpiWords;
      if (__ldg(ep + 0) == 0) --ci;
      transposed_epilogue<T>(tv, ep, s_epi + e * slot, slot / 2, pairs, d,
                             masks + (size_t)(ci >> 4) * elems,
                             2 * (ci & 15));
    }
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

template <typename T>
static int launch_bwd(const void* x, const void* ct, void* out,
                      const int* in_rows, const int* out_rows,
                      const int* xor_low, const int* inv_src0,
                      const long long* epis, int n_epi, int n_cmp,
                      int n_tiles, int n_rows, int rpt_shift,
                      int tiles_per_cta, int t, int wpe, int wpe_shift,
                      int row_shift, int pad_words, long long batch,
                      int word_bytes, int d, cudaStream_t s) {
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  const int rows = tiles_per_cta << rpt_shift;
  const int mask_words = (n_cmp + 15) / 16;
  const size_t elems = ((size_t)rows << t) * (size_t)d;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem =
        (size_t)REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta) +
        (size_t)epi_table_bytes(n_epi, 1 << rpt_shift, t, tiles_per_cta) +
        2 * tile_buf_bytes(rows, t, wpe, pad_words, (int)sizeof(W)) +
        (size_t)mask_words * elems * 4;
    cudaError_t e = allow_smem(tile_bwd_kernel<W, T>, smem);
    if (e != cudaSuccess) return (int)e;
    tile_bwd_kernel<W, T><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (const W*)ct, (W*)out, in_rows, out_rows, xor_low,
        inv_src0, epis, n_epi, n_rows, rpt_shift, tiles_per_cta, t, wpe,
        wpe_shift, row_shift, pad_words, batch, d, mask_words);
  });
  return (int)cudaGetLastError();
}

// elem_type: 1 = float32, 2 = bfloat16 (int32 has no gradient).
extern "C" int repro_tile_bwd(const void* x, void* out, const void* ct,
                              const int* in_rows, const int* out_rows,
                              const int* xor_low, const int* inv_src0,
                              const long long* epis, int n_epi, int n_cmp,
                              int n_tiles, int n_rows, int rpt_shift,
                              int tiles_per_cta, int t, int wpe,
                              int wpe_shift, int row_shift, int pad_words,
                              long long batch, int word_bytes, int elem_type,
                              int d, void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 ||
      n_epi <= 0 || n_cmp < 0 || n_cmp > n_epi || d <= 0 || epis == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_type) {
    case 1:
      return launch_bwd<float>(x, ct, out, in_rows, out_rows, xor_low,
                               inv_src0, epis, n_epi, n_cmp, n_tiles, n_rows,
                               rpt_shift, tiles_per_cta, t, wpe, wpe_shift,
                               row_shift, pad_words, batch, word_bytes, d, s);
    case 2:
      return launch_bwd<Bf16>(x, ct, out, in_rows, out_rows, xor_low,
                              inv_src0, epis, n_epi, n_cmp, n_tiles, n_rows,
                              rpt_shift, tiles_per_cta, t, wpe, wpe_shift,
                              row_shift, pad_words, batch, word_bytes, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
