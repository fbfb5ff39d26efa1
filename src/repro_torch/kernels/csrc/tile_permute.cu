// K4a: the one-pass tiled BMMC permutation (paper §4.1, §5.1 and its
// generalisation to witness directions), without compute epilogues.
//
// Replaces: src/repro/kernels/bmmc_permute.py, _tile_kernel with epis=()
// (launched by tiled_permute_tables). Tile g reads rows_per_tile (rpt)
// whole rows at in_rows[g], gathers
//     out.flat[r * 2^t + l] = tile.flat[src0.flat[r * 2^t + (l ^ xor_low[g])]]
// and writes whole rows at out_rows[g].
//
// Bound on the H100: bytes. Each element is read once and written once,
// 2 * size bytes over the 3.35 TB/s of HBM3; the row tables add
// 8 bytes per row, 1/(2^t * itemsize / 4) of the data.
//
// The TPU kernel walked every tile in one sequential loop behind a
// num_buffers-deep DMA pipeline. Here the host (k4a_schedule in
// bmmc_permute.py) picks one of two schedules from the geometry, and
// passes everything a launch needs in one TilePermuteArgs, built once
// per launch record, so a call crosses into C with four arguments.
//
// * narrow (elements under 64 bytes, e.g. 2^30 int32 at t = 6, the
//   sort's passes): a block takes `groups` consecutive work
//   items (a work item is `per_cta` tiles of one batch row, about
//   16 KiB) and keeps two of them in flight in two shared-memory tiles:
//     1. it stages the row ids and lane XORs of all its work items in
//        shared memory (one round trip to memory for the block);
//     2. it loads the rows of work items 0 and 1 with cp.async (16-byte
//        copies, no registers; consecutive threads on consecutive chunks
//        of a row), each item one commit group;
//     3. for each item: waits for its group, then gathers whole output
//        rows in order, each thread 16 bytes (VW = 16 / word bytes
//        consecutive output lanes: their src0 entries read as one int4,
//        their words read from the tile and stored as one 16-byte word),
//        then reloads the freed tile with item k + 2, so the next item's
//        loads overlap this item's gather-store.
//   The grid is one pass (one block a `groups` items, no persistent
//   loop: tools/copy_sweep.py measured persistent grids behind a
//   one-pass grid on this card). The tile keeps each row's 16-byte chunks whole (cp.async
//   needs 16-byte rows) in one of the layouts of the paper's §4.2 study:
//   unpadded (stride = the row's words), padded (one 16-byte chunk more
//   a row) or swizzled (chunk c of row r at c ^ (r & swz)); the host
//   takes swizzled, and padded for tiles of one row, whose gather stays
//   in a row (chip_smoke.py phase 5 times all three). A tensor
//   that is not 16-byte aligned, or a row that is not whole 16-byte
//   chunks, or an element of several narrow words, takes the same
//   schedule one word at a time (kVec false: W-sized copies, cp.async
//   for 4, 8 and 16 bytes, plain loads for 1 and 2).
// * wide (elements of 64 bytes or more, e.g. the serving path's kv-head
//   shuffle at t = 1 with 256-2048-byte elements): no shared-memory
//   tile, whose round trip would make neither side more coalesced
//   (tools/k4a_sweep.py on an H100: from 64-byte elements the wide
//   schedule is as fast or faster at 256 MiB, and faster in L2). A
//   block takes `per_cta` consecutive output elements of `groups`
//   batch rows (about 16 KiB); it computes each element's
//   source from the row tables, xor_low and src0 once per element
//   (staged in shared memory), then every thread copies 16-byte words
//   (the widest both pointers and the element allow), consecutive
//   threads on consecutive words of an element, LoadBatch words loaded
//   before any is stored.
//
// The guarded variant (kGuard, launched by repro_tile_permute_guarded)
// keeps the design K4a had before these schedules (tile_kernel below,
// whose unguarded instantiation now lives only in tools/k4a_sweep.cu as
// the A/B reference): every row id, lane XOR and src0 entry is tested
// before the access it addresses, an entry out of range sets bit 1 of
// *flags (one atomicOr per thread that met one) and its access is
// skipped. Its steps are the guarded macros of tile_common.cuh, which
// the guarded K4b (tile_fused.cu) shares; a tile row there is padded by
// one 4-byte bank. The cp.async steps of the narrow schedule
// (stage_copy, cp_async_commit, cp_async_wait) live in bulk_copy.cuh,
// which K4b's and K5's work-item schedule (tile_items.cuh) shares.
#include "bulk_copy.cuh"
#include "tile_common.cuh"

// ---------------------------------------------------------------------------
// The guarded K4a (ring 2): the design before the two schedules
// ---------------------------------------------------------------------------

template <typename W, bool kGuard>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_kernel(const W* __restrict__ x, W* __restrict__ out,
            const int* __restrict__ in_rows, const int* __restrict__ out_rows,
            const int* __restrict__ xor_low, const int* __restrict__ src0,
            int n_rows, int rpt_shift, int tiles_per_cta, int t, int wpe,
            int wpe_shift, int row_shift, int pad_words, long long batch,
            int* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = tiles_per_cta << rpt_shift;   // tile rows of this block
  int* s_in = reinterpret_cast<int*>(smem);
  int* s_out = s_in + rows;
  int* s_xl = s_out + rows;
  const int tab_bytes = REPRO_TILE_TABLE_BYTES(rows, tiles_per_cta);
  W* tile = reinterpret_cast<W*>(smem + tab_bytes);

  const long long g0 = (long long)blockIdx.x * tiles_per_cta;
  const int row_len = 1 << t;
  const unsigned rpt_mask = (1u << rpt_shift) - 1;
  const unsigned row_words = (unsigned)row_len * (unsigned)wpe;
  const unsigned stride = row_words + (unsigned)pad_words;
  if constexpr (!kGuard) {
    REPRO_TILE_LOAD_TABLES(s_in, s_out, s_xl, in_rows, out_rows, xor_low,
                           g0, rpt_shift, rows, tiles_per_cta)
    const unsigned span = (unsigned)rows * row_words;
    const long long batch_words = (long long)n_rows * row_words;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const W* xb = x + b * batch_words;
      W* ob = out + b * batch_words;
      __syncthreads();  // tables ready; the previous batch row's reads done
      REPRO_TILE_LOAD_ROWS(W, tile, xb, s_in, span, row_words, row_shift,
                           stride)
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
    const unsigned span = (unsigned)rows * row_words;
    const long long batch_words = (long long)n_rows * row_words;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const W* xb = x + b * batch_words;
      W* ob = out + b * batch_words;
      __syncthreads();
      REPRO_TILE_LOAD_ROWS_GUARDED(W, tile, xb, s_in, span, row_words,
                                   row_shift, stride)
      __syncthreads();
      REPRO_TILE_GATHER_STORE_GUARDED(W, ob, tile, s_out, s_xl, src0, span,
                                      row_words, row_shift, wpe, wpe_shift,
                                      t, rpt_shift, rpt_mask, row_len,
                                      stride, bad)
    }
    if (bad) atomicOr(flags, 1);
  }
}

template <bool kGuard>
static int launch_tile(const void* x, void* out, const int* in_rows,
                       const int* out_rows, const int* xor_low,
                       const int* src0, int n_tiles, int n_rows,
                       int rpt_shift, int tiles_per_cta, int t, int wpe,
                       int wpe_shift, int row_shift, int pad_words,
                       long long batch, int word_bytes, int* flags,
                       void* stream) {
  if (n_tiles <= 0 || n_rows <= 0 || rpt_shift < 0 || tiles_per_cta <= 0 ||
      n_tiles % tiles_per_cta || t < 0 || wpe <= 0 || batch <= 0 ||
      (kGuard && flags == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_tiles / tiles_per_cta), batch_grid(batch));
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = tiles_per_cta << rpt_shift;
  REPRO_DISPATCH_WORD(word_bytes, {
    const size_t smem =
        REPRO_TILE_SMEM_BYTES(W, rows, tiles_per_cta, t, wpe, pad_words);
    cudaError_t e = allow_smem(tile_kernel<W, kGuard>, smem);
    if (e != cudaSuccess) return (int)e;
    tile_kernel<W, kGuard><<<grid, REPRO_THREADS, smem, s>>>(
        (const W*)x, (W*)out, in_rows, out_rows, xor_low, src0, n_rows,
        rpt_shift, tiles_per_cta, t, wpe, wpe_shift, row_shift, pad_words,
        batch, flags);
  });
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The two schedules of the unguarded K4a
// ---------------------------------------------------------------------------

// One launch, as the host's launch record holds it (bmmc_permute.py's
// _K4aArgs mirrors this layout field by field).
struct TilePermuteArgs {
  const int* in_rows;
  const int* out_rows;
  const int* xor_low;
  const int* src0;
  long long batch;     // batch rows
  long long n_work;    // narrow: work items, batch * n_groups
  int schedule;        // 0 narrow, 1 wide
  int word_bytes;      // bytes of the word W
  int vec;             // narrow: 16-byte copies and stores (kVec)
  int n_rows;          // rows of one batch row, 2^(n - t)
  int t;               // log2 elements a row
  int rpt_shift;       // log2 rows a tile
  int wpe;             // words an element
  int wpe_shift;       // log2 wpe, or -1
  int row_shift;       // narrow: log2 of a row's words; wide: log2 of a
                       // block's words of one batch row (-1: not a power
                       // of two)
  int per_cta;         // narrow: tiles a work item; wide: elements a block
  int per_cta_shift;   // log2 per_cta (a power of two)
  int groups;          // narrow: work items a block; wide: batch rows a block
  int n_groups;        // narrow: work items a batch row; wide: element
                       // chunks a batch row
  int stride;          // narrow: words a tile row takes in shared memory
  int swz;             // narrow: XOR mask of a row's 16-byte chunks
  int grid;            // blocks
  int smem;            // dynamic shared-memory bytes a block
};

template <typename W, bool kVec>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_narrow_kernel(const W* __restrict__ x, W* __restrict__ out,
                   const TilePermuteArgs a) {
  // words of a 16-byte chunk, and words a thread copies or stores at once
  constexpr int CW = sizeof(W) >= 16 ? 1 : 16 / (int)sizeof(W);
  constexpr int CW_SHIFT = CW == 16 ? 4 : CW == 8 ? 3 : CW == 4 ? 2
                         : CW == 2 ? 1 : 0;
  constexpr int VW = kVec ? CW : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = a.per_cta << a.rpt_shift;        // tile rows an item
  const int rows_shift = a.per_cta_shift + a.rpt_shift;
  const unsigned row_len = 1u << a.t;
  const unsigned lane_mask = row_len - 1;
  const unsigned rpt_mask = (1u << a.rpt_shift) - 1;
  const unsigned row_words = row_len * (unsigned)a.wpe;
  const unsigned span = (unsigned)rows * row_words;
  const unsigned stride = (unsigned)a.stride, swz = (unsigned)a.swz;
  const long long batch_words = (long long)a.n_rows * row_words;

  long long* s_base = reinterpret_cast<long long*>(smem);
  const int base_bytes = (a.groups * 8 + 15) & ~15;
  int* s_in = reinterpret_cast<int*>(smem + base_bytes);
  int* s_out = s_in + a.groups * rows;
  int* s_xl = s_out + a.groups * rows;
  const int tab_bytes =
      base_bytes + ((a.groups * (2 * rows + a.per_cta) * 4 + 15) & ~15);
  const unsigned tile_bytes =
      ((unsigned)rows * stride * sizeof(W) + 15) & ~15u;
  W* const tile0 = reinterpret_cast<W*>(smem + tab_bytes);
  W* const tile1 = reinterpret_cast<W*>(smem + tab_bytes + tile_bytes);

  // 1. the row ids and lane XORs of every work item of the block
  const long long w0 = (long long)blockIdx.x * a.groups;
  const int nw = (int)min((long long)a.groups, a.n_work - w0);
  for (int k = threadIdx.x; k < nw; k += REPRO_THREADS)
    s_base[k] = (w0 + k) / a.n_groups * batch_words;
  for (int i = threadIdx.x; i < (nw << rows_shift); i += REPRO_THREADS) {
    const long long grp = (w0 + (i >> rows_shift)) % a.n_groups;
    const long long at = (grp << rows_shift) + (i & (rows - 1));
    s_in[i] = __ldg(a.in_rows + at);
    s_out[i] = __ldg(a.out_rows + at);
  }
  for (int i = threadIdx.x; i < (nw << a.per_cta_shift);
       i += REPRO_THREADS) {
    const long long grp = (w0 + (i >> a.per_cta_shift)) % a.n_groups;
    s_xl[i] = __ldg(a.xor_low + (grp << a.per_cta_shift) +
                    (i & (a.per_cta - 1)));
  }
  __syncthreads();

  // 2. a work item's rows into a tile, one commit group
  auto load = [&](int k, W* tile) {
    const W* xb = x + s_base[k];
    const int* rin = s_in + (k << rows_shift);
    for (unsigned li = threadIdx.x * VW; li < span;
         li += REPRO_THREADS * VW) {
      const unsigned r = div_by(li, row_words, a.row_shift);
      const unsigned q = li - r * row_words;
      stage_copy<kVec ? 16 : (int)sizeof(W)>(
          tile + r * stride + (q ^ ((r & swz) << CW_SHIFT)),
          xb + (long long)rin[r] * row_words + q);
    }
    cp_async_commit();
  };

  // 3. a work item's output rows from its tile, VW words a thread
  auto gather = [&](int k, const W* tile) {
    W* ob = out + s_base[k];
    const int* rout = s_out + (k << rows_shift);
    const int* xls = s_xl + (k << a.per_cta_shift);
#pragma unroll 2
    for (unsigned li = threadIdx.x * VW; li < span;
         li += REPRO_THREADS * VW) {
      const unsigned r = div_by(li, row_words, a.row_shift);
      const unsigned rem = li - r * row_words;
      const unsigned j = r >> a.rpt_shift, rp = r & rpt_mask;
      const unsigned xl = (unsigned)xls[j];
      W* dst = ob + (long long)rout[r] * row_words + rem;
      if constexpr (VW == 1) {
        const unsigned cp = div_by(rem, (unsigned)a.wpe, a.wpe_shift);
        const unsigned w = rem - cp * (unsigned)a.wpe;
        const unsigned s =
            (unsigned)__ldg(a.src0 + ((rp << a.t) | (cp ^ xl)));
        const unsigned rs = (j << a.rpt_shift) | (s >> a.t);
        const unsigned q = (s & lane_mask) * (unsigned)a.wpe + w;
        *dst = tile[rs * stride + (q ^ ((rs & swz) << CW_SHIFT))];
      } else {
        // one word an element (wpe == 1): lanes rem .. rem + VW - 1, whose
        // src0 entries are those at (rem ^ xl_hi) + m, taken in the
        // order m ^ xl_lo (xl_lo = xl & (VW - 1))
        const int* e = a.src0 + ((rp << a.t) | (rem ^ (xl & ~(VW - 1u))));
        int s[VW];
        if constexpr (VW == 2) {
          const int2 v = __ldg(reinterpret_cast<const int2*>(e));
          s[0] = v.x;
          s[1] = v.y;
        } else {
#pragma unroll
          for (int m = 0; m < VW; m += 4) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(e + m));
            s[m] = v.x;
            s[m + 1] = v.y;
            s[m + 2] = v.z;
            s[m + 3] = v.w;
          }
        }
#pragma unroll
        for (int bit = 1; bit < VW; bit <<= 1) {   // s[m] <- s[m ^ xl_lo]
          const bool flip = xl & bit;
#pragma unroll
          for (int m = 0; m < VW; ++m) {
            if (!(m & bit)) {
              const int lo = s[m], hi = s[m | bit];
              s[m] = flip ? hi : lo;
              s[m | bit] = flip ? lo : hi;
            }
          }
        }
        union {
          W w[VW];
          uint4 v;
        } pack;
#pragma unroll
        for (int m = 0; m < VW; ++m) {
          const unsigned sm = (unsigned)s[m];
          const unsigned rs = (j << a.rpt_shift) | (sm >> a.t);
          pack.w[m] = tile[rs * stride +
                           ((sm & lane_mask) ^ ((rs & swz) << CW_SHIFT))];
        }
        __stcs(reinterpret_cast<uint4*>(dst), pack.v);
      }
    }
  };

  load(0, tile0);
  if (nw > 1) load(1, tile1);
  for (int k = 0; k < nw; ++k) {
    if (k + 1 < nw)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();            // item k's rows are in its tile
    W* const tile = (k & 1) ? tile1 : tile0;
    gather(k, tile);
    if (k + 2 < nw) {
      __syncthreads();          // every thread is done reading that tile
      load(k + 2, tile);
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(REPRO_THREADS)
tile_wide_kernel(const W* __restrict__ x, W* __restrict__ out,
                 const TilePermuteArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int epb = a.per_cta;                 // output elements a block
  int* s_src = reinterpret_cast<int*>(smem);
  int* s_dst = s_src + epb;
  const long long chunk = blockIdx.x % a.n_groups;
  const long long b0 = blockIdx.x / a.n_groups * (long long)a.groups;
  const int nb = (int)min((long long)a.groups, a.batch - b0);
  const unsigned lane_mask = (1u << a.t) - 1;
  const unsigned rpt_mask = (1u << a.rpt_shift) - 1;

  // each element's source and destination, once per element
  for (int i = threadIdx.x; i < epb; i += REPRO_THREADS) {
    const unsigned e = (unsigned)(chunk * epb + i);
    const unsigned r = e >> a.t, l = e & lane_mask;
    const unsigned g = r >> a.rpt_shift, rp = r & rpt_mask;
    const unsigned xl = (unsigned)__ldg(a.xor_low + g);
    const unsigned s = (unsigned)__ldg(a.src0 + ((rp << a.t) | (l ^ xl)));
    s_src[i] = (__ldg(a.in_rows + ((g << a.rpt_shift) | (s >> a.t)))
                << a.t) | (int)(s & lane_mask);
    s_dst[i] = (__ldg(a.out_rows + r) << a.t) | (int)l;
  }
  __syncthreads();

  const long long batch_words = ((long long)a.n_rows << a.t) * a.wpe;
  const W* xb = x + b0 * batch_words;
  W* ob = out + b0 * batch_words;
  const unsigned block_words = (unsigned)epb * (unsigned)a.wpe;
  const unsigned span = (unsigned)nb * block_words;
  constexpr int kBatch = LoadBatch<W>::value;
  for (unsigned base = threadIdx.x; base < span;
       base += kBatch * REPRO_THREADS) {
    W v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const unsigned li = base + k * REPRO_THREADS;
      if (li < span) {
        const unsigned bb = div_by(li, block_words, a.row_shift);
        const unsigned rem = li - bb * block_words;
        const unsigned i = div_by(rem, (unsigned)a.wpe, a.wpe_shift);
        v[k] = xb[bb * batch_words + (long long)s_src[i] * a.wpe +
                  (rem - i * a.wpe)];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const unsigned li = base + k * REPRO_THREADS;
      if (li < span) {
        const unsigned bb = div_by(li, block_words, a.row_shift);
        const unsigned rem = li - bb * block_words;
        const unsigned i = div_by(rem, (unsigned)a.wpe, a.wpe_shift);
        ob[bb * batch_words + (long long)s_dst[i] * a.wpe +
           (rem - i * a.wpe)] = v[k];
      }
    }
  }
}

template <typename W, typename K>
static int launch_with(K kernel, const W* x, W* out, const TilePermuteArgs& a,
                       cudaStream_t s) {
  cudaError_t e = allow_smem(kernel, (size_t)a.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)a.grid, REPRO_THREADS, (size_t)a.smem, s>>>(x, out, a);
  return (int)cudaGetLastError();
}

// The unguarded K4a: the schedule, word and layout the host chose, all in
// *a (see TilePermuteArgs). Returns cudaGetLastError() after the launch.
extern "C" int repro_tile_permute(const void* x, void* out,
                                  const TilePermuteArgs* a, void* stream) {
  if (a == nullptr || a->grid <= 0 || a->batch <= 0 || a->n_rows <= 0 ||
      a->wpe <= 0 || a->t < 0 || a->rpt_shift < 0 || a->per_cta <= 0 ||
      a->groups <= 0 || a->n_groups <= 0 || a->smem < 0 ||
      (a->schedule != 0 && a->schedule != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_WORD(a->word_bytes, {
    if (a->schedule == 1)
      return launch_with(tile_wide_kernel<W>, (const W*)x, (W*)out, *a, s);
    if (a->vec)
      return launch_with(tile_narrow_kernel<W, true>, (const W*)x, (W*)out,
                         *a, s);
    return launch_with(tile_narrow_kernel<W, false>, (const W*)x, (W*)out,
                       *a, s);
  });
  return (int)cudaErrorInvalidValue;
}

// flags: one int32 on the device; bit 1 is set when a table entry lies
// outside its range (row ids [0, n_rows), lane XORs [0, 2^t), src0 the
// tile's rpt * 2^t positions).
extern "C" int repro_tile_permute_guarded(
    const void* x, void* out, const int* in_rows, const int* out_rows,
    const int* xor_low, const int* src0, int n_tiles, int n_rows,
    int rpt_shift, int tiles_per_cta, int t, int wpe, int wpe_shift,
    int row_shift, int pad_words, long long batch, int word_bytes,
    int* flags, void* stream) {
  return launch_tile<true>(x, out, in_rows, out_rows, xor_low, src0,
                           n_tiles, n_rows, rpt_shift, tiles_per_cta, t, wpe,
                           wpe_shift, row_shift, pad_words, batch,
                           word_bytes, flags, stream);
}
