"""Tile-bit partitioning and offline table generation (paper §4.1-4.3, §5.1).

The counterpart of :mod:`repro.core.tiling`, with the same plans, the
same tables and the same names. For a *tiled* BMMC ``(A, c)`` on
``n``-bit indices and tile parameter ``t`` (one "row" = 2^t consecutive
elements), input index bits are partitioned into:

* tile column bits  — the low ``t`` bits (set L),
* tile row bits     — the witness columns ``i_1..i_t`` (set R),
* overlap bits      — R ∩ L (``n_over`` of them),
* thread-block bits — the rest (``n_TB = n - 2t + n_over``), all >= t.

One tile = all index combinations of (L ∪ R) bits with the block bits
fixed: ``2^(t - n_over)`` full input rows, mapping onto as many full
output rows. Per permutation the planners build

* ``in_rows[g, r]``   — input row id read by tile ``g``,
* ``out_rows[g, r']`` — output row id written by tile ``g``,
* ``xor_low[g]``      — per-tile XOR on the intra-tile lane gather,
* ``src0``            — flat intra-tile gather table for tile 0:
  ``out_tile.flat[j] = in_tile.flat[src0[j ^ xor_low[g]]]``.

**Vectorised table builders.** The reference fills these tables with a
Python loop over every row of every tile, which costs minutes per plan
at the paper's size (n = 30). Every table is affine over F2 in the bits
of its indices ``(g, r)``: the entry for an index is a constant XOR the
images of the index's set bits. :func:`_affine_table` builds such a
table by doubling — the table for k bits, then that table XOR the image
of bit k — in O(entries) numpy work with no loop over rows. The tables
are bitwise equal to the reference's at the same ``(bmmc, t)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .bmmc import Bmmc
from . import f2


def _scatter_bits(value: int, positions: list) -> int:
    """Place bit k of ``value`` at ``positions[k]``."""
    out = 0
    for k, pos in enumerate(positions):
        if (value >> k) & 1:
            out |= 1 << pos
    return out


def _gather_bits(value: int, positions: list) -> int:
    """Collect bits of ``value`` at ``positions`` into a compact int."""
    out = 0
    for k, pos in enumerate(positions):
        if (value >> pos) & 1:
            out |= 1 << k
    return out


def _affine_table(images: Sequence[int], const: int = 0) -> np.ndarray:
    """``tab[i] = const ^ XOR(images[k] for the set bits k of i)`` for all
    ``i < 2^len(images)``, as int64, built by doubling."""
    tab = np.array([const], dtype=np.int64)
    for v in images:
        tab = np.concatenate([tab, tab ^ np.int64(v)])
    return tab


def _run_length(rows: np.ndarray) -> int:
    """Largest power-of-two run of consecutive row ids shared by all tiles.

    This is the DMA-merge factor: ``run`` consecutive rows can be copied by a
    single descriptor (the paper's §4.3 amortization).
    """
    n_tiles, rpt = rows.shape
    run = 1
    while run * 2 <= rpt:
        nxt = run * 2
        blocks = rows.reshape(n_tiles, rpt // nxt, nxt)
        diff = blocks - blocks[..., :1]
        if np.array_equal(diff, np.broadcast_to(np.arange(nxt), diff.shape)):
            run = nxt
        else:
            break
    return run


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Offline execution plan for one tiled-BMMC pass.

    ``row_dirs`` are the witness *directions* spanning the tile's row
    structure — full n-bit vectors whose high parts are independent;
    tile slot ``r`` holds rows offset by ``XOR(row_dirs[k] for bits k of
    r)``. For a classically tiled plan (paper §5.1) these are the unit
    vectors of the witness columns above ``t``; the generalized planner
    (:func:`plan_general`) uses any basis of ``ker(A[t:, :])``.
    """

    bmmc: Bmmc
    t: int                      # n_tile: log2 elements per row
    row_cols: tuple             # R, sorted (classic witness; () if general)
    n_over: int
    tb_positions: tuple         # thread-block bit positions, sorted (all >= t)
    in_rows: np.ndarray         # (n_tiles, rows_per_tile) int32
    out_rows: np.ndarray        # (n_tiles, rows_per_tile) int32
    xor_low: np.ndarray         # (n_tiles,) int32
    src0: np.ndarray            # (rows_per_tile, 2^t) int32 flat gather table
    in_run: int                 # input DMA merge run (rows)
    out_run: int                # output DMA merge run (rows)
    row_dirs: tuple = ()        # witness directions, len == log2(rows_per_tile)

    @property
    def n(self) -> int:
        return self.bmmc.n

    @property
    def n_tiles(self) -> int:
        return self.in_rows.shape[0]

    @property
    def rows_per_tile(self) -> int:
        return self.in_rows.shape[1]

    @property
    def row_len(self) -> int:
        return 1 << self.t

    def dma_descriptors(self) -> int:
        """Total modeled DMA descriptors (reads + writes)."""
        per_tile = self.rows_per_tile // self.in_run + self.rows_per_tile // self.out_run
        return self.n_tiles * per_tile

    def bytes_per_descriptor(self, itemsize: int) -> tuple:
        return (self.in_run * self.row_len * itemsize,
                self.out_run * self.row_len * itemsize)

    def audit(self) -> "TilePlan":
        """Descriptor-bounds + semantic audit (guard ring 1). Raises
        :class:`repro_torch.guard.DescriptorOOB`."""
        from ..guard.validate import audit_tile_plan  # lazy: no cycle
        audit_tile_plan(self)
        return self


def _tile_tables(bmmc: Bmmc, t: int, tb: list, in_dirs: list,
                 out_low: list, slot_of) -> tuple:
    """``(in_rows, out_rows, xor_low, src0)`` of a one-pass plan.

    ``tb``: thread-block bit positions; ``in_dirs``: the n-bit direction
    of each tile-row slot bit (its high part moves the input row);
    ``out_low``: the low positions enumerating a tile's output rows;
    ``slot_of(v)``: the tile-row slot (an F2-linear map) that holds
    input row ``v >> t`` of tile 0, or None when none does.
    """
    low_mask = (1 << t) - 1
    mv = lambda v: f2.matvec(bmmc.rows, v)
    # in_rows[g, r] = (base_g ^ dirs(r)) >> t; xor_low[g] = A base_g & low
    g_in = _affine_table([1 << (p - t) for p in tb])
    r_in = _affine_table([d >> t for d in in_dirs])
    xor_low = _affine_table([mv(1 << p) & low_mask for p in tb])
    # out_rows[g, r'] = (A (base_g ^ scatter(r', out_low)) ^ c) >> t
    g_out = _affine_table([mv(1 << p) >> t for p in tb])
    r_out = _affine_table([mv(1 << j) >> t for j in out_low], bmmc.c >> t)
    in_rows = (g_in[:, None] ^ r_in[None, :]).astype(np.int32)
    out_rows = (g_out[:, None] ^ r_out[None, :]).astype(np.int32)

    # src0[r', c'] = slot(x) * 2^t + (x & low), x = A^-1 (out_rows[0, r']
    # << t | c'): affine in the bits of (r', c') — lane bits first, so the
    # flat index r' * 2^t + c' numbers the entries
    ainv = bmmc.inverse()
    x0 = ainv.apply(int(r_out[0]) << t)
    x_imgs = ([f2.matvec(ainv.rows, 1 << k) for k in range(t)]
              + [f2.matvec(ainv.rows, (mv(1 << j) >> t) << t)
                 for j in out_low])

    def src_of(x: int) -> int:
        r = slot_of(x)
        assert r is not None, "tile-0 source must be in tile 0"
        return (r << t) | (x & low_mask)

    # src_of is linear, so the affine table of the images is src0
    src0 = _affine_table([src_of(x) for x in x_imgs], src_of(x0))
    src0 = src0.astype(np.int32).reshape(len(r_in), 1 << t)
    return in_rows, out_rows, xor_low.astype(np.int32), src0


def plan_from_arrays(rows: tuple, c: int, t: int, in_rows, out_rows,
                     xor_low, src0, in_run: int, out_run: int, *,
                     row_cols: tuple = (), n_over: int = 0,
                     tb_positions: tuple = (),
                     row_dirs: tuple = ()) -> TilePlan:
    """A :class:`TilePlan` from another plan's numpy fields — e.g. a
    :mod:`repro.core.tiling` plan's — so the kernels can be driven on
    tables this package's planners did not build."""
    return TilePlan(
        bmmc=Bmmc(tuple(int(r) for r in rows), int(c)), t=int(t),
        row_cols=tuple(row_cols), n_over=int(n_over),
        tb_positions=tuple(tb_positions),
        in_rows=np.asarray(in_rows, dtype=np.int32),
        out_rows=np.asarray(out_rows, dtype=np.int32),
        xor_low=np.asarray(xor_low, dtype=np.int32),
        src0=np.asarray(src0, dtype=np.int32),
        in_run=int(in_run), out_run=int(out_run), row_dirs=tuple(row_dirs))


def plan_tiled(bmmc: Bmmc, t: int) -> Optional[TilePlan]:
    """Build a TilePlan, or None if ``bmmc`` is not tiled for this ``t``."""
    n = bmmc.n
    if 2 * t > n + t:  # t > n: nonsensical
        return None
    cols = bmmc.tiled_columns(t)
    if cols is None:
        return None
    low = set(range(t))
    r_set = set(cols)
    n_over = len(r_set & low)
    if n - 2 * t + n_over < 0:
        return None  # tile would exceed the array; caller falls back
    r_not_l = sorted(r_set - low)           # t - n_over positions, all >= t
    l_not_r = sorted(low - r_set)           # t - n_over positions, all < t
    tb = sorted(set(range(n)) - low - r_set)
    assert len(tb) == n - 2 * t + n_over
    tb_mask = _scatter_bits((1 << len(tb)) - 1, tb)

    def slot_of(x: int) -> Optional[int]:
        return None if x & tb_mask else _gather_bits(x, r_not_l)

    in_rows, out_rows, xor_low, src0 = _tile_tables(
        bmmc, t, tb, [1 << p for p in r_not_l], l_not_r, slot_of)
    return TilePlan(
        bmmc=bmmc, t=t, row_cols=tuple(sorted(cols)), n_over=n_over,
        tb_positions=tuple(tb), in_rows=in_rows, out_rows=out_rows,
        xor_low=xor_low, src0=src0,
        in_run=_run_length(in_rows), out_run=_run_length(out_rows),
        row_dirs=tuple(1 << p for p in r_not_l),
    )


# ---------------------------------------------------------------------------
# Generalized one-pass planning (§5.1 with witness *directions*).
#
# The kernel's requirements — each tile reads whole input rows, writes
# whole output rows, and tiles share one gather table up to a per-tile
# lane XOR — survive replacing the classic witness columns by ANY basis
# of D = ker(A[t:, :]), which has dimension exactly t for every
# invertible A. So any BMMC with n - 2t + a >= 0 (always true for
# 2t <= n) runs in ONE tiled pass; the §5.2 two-pass factorization is the
# fallback for t > n/2.
# ---------------------------------------------------------------------------


def _split_directions(bmmc: Bmmc, t: int) -> tuple:
    """Basis of ``ker(A[t:, :])`` split into (a, row_dirs): ``a`` counts
    the pure-low directions; ``row_dirs`` have independent high parts."""
    d = f2.nullspace(bmmc.rows[t:], bmmc.n)
    assert len(d) == t, "kernel of the high rows must have dimension t"
    row_dirs: list = []
    a = 0
    for v in d:
        h = v >> t
        for w in row_dirs:  # eliminate previously-chosen high pivots
            if h & ((w >> t) & -(w >> t)):
                v ^= w
                h = v >> t
        if h == 0:
            a += 1
        else:
            row_dirs.append(v)
    return a, row_dirs


def _tb_complement(row_dirs: list, t: int, n: int) -> list:
    """High unit positions completing ``{high(row_dirs)}`` to F2^(n-t)."""
    gens = [v >> t for v in row_dirs]
    tb = []
    for pos in range(t, n):
        u = 1 << (pos - t)
        if not f2.in_span(u, gens):
            gens.append(u)
            tb.append(pos)
    return tb


def _out_low_positions(bmmc: Bmmc, t: int, count: int) -> list:
    """Low unit positions whose images under A[t:, :] are independent —
    these enumerate a tile's distinct output rows."""
    chosen: list = []
    imgs: list = []
    for j in range(t):
        img = f2.matvec(bmmc.rows, 1 << j) >> t
        if img and not f2.in_span(img, imgs):
            imgs.append(img)
            chosen.append(j)
            if len(chosen) == count:
                break
    assert len(chosen) == count, "output row images must span"
    return chosen


def _coords(gens: list):
    """The coordinate map of the span of the independent ``gens``:
    ``coord(v)`` is the mask of the generators XORing to ``v``, or None
    when ``v`` lies outside the span."""
    red: list = []                          # (reduced vector, coordinate)
    for k, g in enumerate(gens):
        co = 1 << k
        for rv, rc in red:
            if g & (rv & -rv):
                g ^= rv
                co ^= rc
        assert g, "generators must be independent"
        red.append((g, co))

    def coord(v: int) -> Optional[int]:
        out = 0
        for rv, rc in red:
            if v & (rv & -rv):
                v ^= rv
                out ^= rc
        return out if v == 0 else None
    return coord


def plan_general(bmmc: Bmmc, t: int) -> Optional[TilePlan]:
    """One-pass plan for an arbitrary invertible BMMC (see block comment
    above). Returns None when the tile would exceed the array
    (``n - 2t + a < 0``, only possible for t > n/2)."""
    n = bmmc.n
    if not 0 < t <= n:
        return None
    a, row_dirs = _split_directions(bmmc, t)
    if n - 2 * t + a < 0:
        return None
    tb = _tb_complement(row_dirs, t, n)
    chosen_low = _out_low_positions(bmmc, t, t - a)
    # tile 0 holds input rows high(dirs(r)); the slot of a source x is
    # the coordinate of x >> t in that span
    coord = _coords([d >> t for d in row_dirs])
    in_rows, out_rows, xor_low, src0 = _tile_tables(
        bmmc, t, tb, row_dirs, chosen_low, lambda x: coord(x >> t))
    return TilePlan(
        bmmc=bmmc, t=t, row_cols=(), n_over=a, tb_positions=tuple(tb),
        in_rows=in_rows, out_rows=out_rows, xor_low=xor_low, src0=src0,
        in_run=_run_length(in_rows), out_run=_run_length(out_rows),
        row_dirs=tuple(row_dirs),
    )


# ---------------------------------------------------------------------------
# Fused-compute tables: everything a fused epilogue needs to run a
# CmpHalves / Bfly stage on the tile while it sits in on-chip memory.
#
# The compute pairs intermediate index m with m ^ 2^(n-1), where m = M x
# (+) c_M and M is the composition of the run's perms *before* the
# compute. Pulled back to input space the partner of x is x ^ v with
# v = A_M^-1 e_{n-1}; when v lies in the span of the plan's tile row (R)
# and column (L) bits, the partner is resident in the same tile at
# position (r ^ vr, lane ^ vc). Which element of a pair is the "hi" half
# (bit n-1 of m set) and which twiddle a butterfly pair uses are affine
# in x, so they split into per-row / per-lane tables XORed with one
# per-tile scalar — the same trick as ``xor_low``. Each table is affine
# over F2 in the bits of its index, so it is built by doubling
# (:func:`_affine_table`), where the reference loops over rows, lanes
# and tiles; the tables are bitwise equal to the reference's.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ComputeTables:
    """Offline tables for one on-chip compute applied inside a tiled pass."""

    kind: str                        # "cmp" | "bfly"
    vr: int                          # partner XOR on the tile-row slot
    vc: int                          # partner XOR on the lane
    hi_row: np.ndarray               # (rows_per_tile,) int32 parity bits
    hi_lane: np.ndarray              # (row_len,) int32 parity bits
    hi_base: np.ndarray              # (n_tiles,) int32 per-tile parity bit
    tw_row: Optional[np.ndarray] = None    # (rows_per_tile,) int32 (bfly)
    tw_lane: Optional[np.ndarray] = None   # (row_len,) int32 (bfly)
    tw_base: Optional[np.ndarray] = None   # (n_tiles,) int32 (bfly)


def pairing_vector(prefix: Bmmc) -> int:
    """The input-space partner XOR ``v = A_M^{-1} e_{n-1}`` of a compute
    whose pair bit is n-1 in the output space of ``prefix``."""
    return f2.matvec(f2.inverse(prefix.rows), 1 << (prefix.n - 1))


def _dir_coords(v: int, row_dirs: tuple, t: int) -> Optional[int]:
    """Coordinates ``vr`` with ``high(v) == high(XOR(row_dirs[k] for bits
    k of vr))``, or None when ``high(v)`` escapes the span."""
    red: list = []                          # (high part, coordinate mask)
    for k, d in enumerate(row_dirs):
        hp, co = d >> t, 1 << k
        for rh, rc in red:
            if hp & (rh & -rh):
                hp ^= rh
                co ^= rc
        if hp:
            red.append((hp, co))
    h, coord = v >> t, 0
    for rh, rc in red:
        if h & (rh & -rh):
            h ^= rh
            coord ^= rc
    return coord if h == 0 else None


def compute_tables(plan: TilePlan, prefix: Bmmc,
                   kind: str) -> Optional[ComputeTables]:
    """Build the epilogue tables for one compute, or None if the compute
    is not tile-local under ``plan`` (pairing vector escapes the tile
    span — row directions plus the low lane bits)."""
    n, t = plan.n, plan.t
    dirs = plan.row_dirs
    tb = list(plan.tb_positions)
    low_mask = (1 << t) - 1

    v = pairing_vector(prefix)
    vr = _dir_coords(v, dirs, t)
    if vr is None:
        return None
    vc = v & low_mask   # slot lane == low bits of x, so the lane XOR is raw

    rowvec = prefix.rows[n - 1]            # row n-1 of A_M: hi(x) predicate
    cbit = (prefix.c >> (n - 1)) & 1
    hi_mask = ~low_mask  # slots address rows by direction HIGH parts only

    # hi(x) = <rowvec, x> is F2-linear, so it splits over the tile's
    # decomposition x = base_g ^ high(dirs(r)) ^ lane: per-row (over the
    # direction high parts), per-lane and per-tile tables, each the
    # affine table of the images of its index bits.
    def par(x: int) -> int:
        return f2.parity(rowvec & x)

    def i32(tab: np.ndarray) -> np.ndarray:
        return tab.astype(np.int32)

    hi_row = i32(_affine_table([par(d & hi_mask) for d in dirs]))
    hi_lane = i32(_affine_table([par(1 << k) for k in range(t)]))
    hi_base = i32(_affine_table([par(1 << p) for p in tb], cbit))

    tw_row = tw_lane = tw_base = None
    if kind == "bfly":
        twmask = (1 << (n - 1)) - 1        # pair index: m with bit n-1 dropped

        def tw(x: int) -> int:
            return f2.matvec(prefix.rows, x) & twmask

        tw_row = i32(_affine_table([tw(d & hi_mask) for d in dirs]))
        tw_lane = i32(_affine_table([tw(1 << k) for k in range(t)]))
        tw_base = i32(_affine_table([tw(1 << p) for p in tb],
                                    prefix.c & twmask))
    return ComputeTables(kind=kind, vr=vr, vc=vc, hi_row=hi_row,
                         hi_lane=hi_lane, hi_base=hi_base, tw_row=tw_row,
                         tw_lane=tw_lane, tw_base=tw_base)


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Analytic plan statistics — O(n^2) bit math, no table enumeration.

    Matches TilePlan's n_over / rows_per_tile / n_tiles / in_run / out_run.
    """
    n: int
    t: int
    n_over: int
    n_tiles: int
    rows_per_tile: int
    row_len: int
    in_run: int
    out_run: int

    def dma_descriptors(self) -> int:
        per_tile = (self.rows_per_tile // self.in_run
                    + self.rows_per_tile // self.out_run)
        return self.n_tiles * per_tile

    def bytes_per_descriptor(self, itemsize: int) -> tuple:
        return (self.in_run * self.row_len * itemsize,
                self.out_run * self.row_len * itemsize)


def plan_stats(bmmc: Bmmc, t: int) -> Optional[PlanStats]:
    """Analytic counterpart of ``plan_tiled`` (no per-tile enumeration)."""
    n = bmmc.n
    cols = bmmc.tiled_columns(t)
    if cols is None:
        return None
    low = set(range(t))
    r_set = set(cols)
    n_over = len(r_set & low)
    if n - 2 * t + n_over < 0:
        return None
    r_not_l = sorted(r_set - low)
    l_not_r = sorted(low - r_set)
    tb = sorted(set(range(n)) - low - r_set)
    rpt = 1 << (t - n_over)

    # input-run: rows consecutive iff the low R\L positions are t, t+1, ...
    k_in = 0
    while k_in < len(r_not_l) and r_not_l[k_in] == t + k_in:
        k_in += 1

    # output-run: out_rows[g, r'] is affine in the r' bits. Runs of 2^k are
    # consecutive iff bit i of r' moves y_high by exactly 2^i for i < k and
    # no other contribution (base bits, c) touches the low k bits of y_high.
    deltas = [f2.matvec(bmmc.rows, 1 << pos) >> t for pos in l_not_r]
    others = [f2.matvec(bmmc.rows, 1 << pos) >> t for pos in tb]
    others.append(bmmc.c >> t)
    k_out = 0
    while k_out < len(deltas):
        k = k_out + 1
        mask = (1 << k) - 1
        ok = all(deltas[i] == (1 << i) for i in range(k))
        ok = ok and all((d & mask) == 0 for d in deltas[k:])
        ok = ok and all((o & mask) == 0 for o in others)
        if not ok:
            break
        k_out = k
    return PlanStats(n=n, t=t, n_over=n_over, n_tiles=1 << len(tb),
                     rows_per_tile=rpt, row_len=1 << t,
                     in_run=1 << k_in, out_run=1 << k_out)


def plan_stats_general(bmmc: Bmmc, t: int) -> Optional[PlanStats]:
    """Analytic counterpart of :func:`plan_general` (O(n^2) bit math)."""
    n = bmmc.n
    if not 0 < t <= n:
        return None
    a, row_dirs = _split_directions(bmmc, t)
    if n - 2 * t + a < 0:
        return None
    tb = _tb_complement(row_dirs, t, n)
    rpt = 1 << (t - a)
    chosen_low = _out_low_positions(bmmc, t, t - a)

    hi = [v >> t for v in row_dirs]
    k_in = 0
    while k_in < len(hi):
        k = k_in + 1
        mask = (1 << k) - 1
        ok = all(hi[i] == (1 << i) for i in range(k))
        ok = ok and all((h & mask) == 0 for h in hi[k:])
        ok = ok and all((pos - t) >= k for pos in tb)
        if not ok:
            break
        k_in = k

    deltas = [f2.matvec(bmmc.rows, 1 << pos) >> t for pos in chosen_low]
    others = [f2.matvec(bmmc.rows, 1 << pos) >> t for pos in tb]
    others.append(bmmc.c >> t)
    k_out = 0
    while k_out < len(deltas):
        k = k_out + 1
        mask = (1 << k) - 1
        ok = all(deltas[i] == (1 << i) for i in range(k))
        ok = ok and all((d & mask) == 0 for d in deltas[k:])
        ok = ok and all((o & mask) == 0 for o in others)
        if not ok:
            break
        k_out = k
    return PlanStats(n=n, t=t, n_over=a, n_tiles=1 << len(tb),
                     rows_per_tile=rpt, row_len=1 << t,
                     in_run=1 << k_in, out_run=1 << k_out)


def stats_bmmc(bmmc: Bmmc, t: int) -> list:
    """Analytic stats for the tiled passes of an arbitrary BMMC: one
    (classic or generalized) pass whenever possible, the §5.2 two-pass
    factorization as the fallback."""
    s = plan_stats(bmmc, t)
    if s is not None:
        return [s]
    s = plan_stats_general(bmmc, t)
    if s is not None:
        return [s]
    out = []
    for factor in bmmc.factor_tiled(t):
        s = plan_stats(factor, t) or plan_stats_general(factor, t)
        if s is None:
            raise ValueError(f"factor expected tiled for t={t}")
        out.append(s)
    return out


def plan_bmmc(bmmc: Bmmc, t: int) -> list:
    """Plan an arbitrary BMMC as tiled passes: 1 via the classic witness
    columns (paper §5.1) or the generalized witness directions
    (:func:`plan_general`), else 2 via the §5.2 factorization (only
    reachable for t > n/2)."""
    p = plan_tiled(bmmc, t)
    if p is not None:
        return [p]
    p = plan_general(bmmc, t)
    if p is not None:
        return [p]
    plans = []
    for factor in bmmc.factor_tiled(t):
        p = plan_tiled(factor, t) or plan_general(factor, t)
        if p is None:
            raise ValueError(f"factor expected to be tiled for t={t}: {factor}")
        plans.append(p)
    return plans


def pass_spans(bmmc: Bmmc, t: int) -> Optional[list]:
    """Per-pass tile spans of :func:`plan_bmmc`, without table enumeration.

    Each span is a tuple of generating direction vectors: a vector ``v``
    is tile-local for that pass iff ``v`` lies in the span. The first
    pass's span is the MAXIMAL achievable one, ``ker(A[t:, :]) + low``.
    Returns None when a pass's tile would exceed the array (t > n/2 with
    a deficient direction split).
    """
    n = bmmc.n
    if not 0 < t <= n:
        return None
    low = tuple(1 << j for j in range(t))

    def span_of(b: Bmmc) -> Optional[tuple]:
        a, row_dirs = _split_directions(b, t)
        if n - 2 * t + a < 0:
            return None
        return tuple(row_dirs) + low

    s = span_of(bmmc)
    if s is not None:
        return [s]
    spans = []
    for factor in bmmc.factor_tiled(t):
        s = span_of(factor)
        if s is None:
            return None
        spans.append(s)
    return spans


# ---------------------------------------------------------------------------
# Class fast-path plans. The simplest BMMC classes skip the tiled gather:
#
# * block (tile-index-only): whole aligned 2^b blocks move wholesale —
#   a block-remapped copy, descriptor count identical to the copy
#   baseline's.
# * lane (lane-local): rows stay in place and every row is permuted
#   identically — a single on-chip row gather, no transpose pass.
# ---------------------------------------------------------------------------

_COPY_BLOCK_BITS = 11   # log2(8 rows x 256 lanes): the copy kernel's block


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Block-remapped copy plan: output block ``g`` is input block
    ``src_rows[g]``, each block 2^b consecutive elements."""

    bmmc: Bmmc
    b: int                      # log2 elements per moved block
    src_rows: np.ndarray        # (2^(n-b),) int32

    @property
    def n(self) -> int:
        return self.bmmc.n

    @property
    def n_rows(self) -> int:
        return self.src_rows.shape[0]

    def dma_descriptors(self) -> int:
        """One read + one write per block — the copy kernel's count when
        ``b == _COPY_BLOCK_BITS``."""
        return 2 * self.n_rows

    def audit(self) -> "BlockPlan":
        """Guard ring-1 audit: ``src_rows`` a bounded permutation whose
        block map matches the BMMC. Raises
        :class:`repro_torch.guard.DescriptorOOB`."""
        from ..guard.validate import audit_block_plan  # lazy: no cycle
        audit_block_plan(self)
        return self


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Single-pass row gather: ``out[row, lane] = x[row, src_lane[lane]]``
    — rows never move, so there is no transpose pass."""

    bmmc: Bmmc
    t: int                      # log2 lanes per row
    src_lane: np.ndarray        # (2^t,) int32
    rows_per_block: int         # rows staged on chip per grid step

    @property
    def n(self) -> int:
        return self.bmmc.n

    @property
    def n_rows(self) -> int:
        return 1 << (self.n - self.t)

    def dma_descriptors(self) -> int:
        return 2 * (self.n_rows // self.rows_per_block)

    def audit(self) -> "LanePlan":
        """Guard ring-1 audit: ``src_lane`` a bounded permutation whose
        in-row gather matches the BMMC. Raises
        :class:`repro_torch.guard.DescriptorOOB`."""
        from ..guard.validate import audit_lane_plan  # lazy: no cycle
        audit_lane_plan(self)
        return self


def block_plan_from_arrays(rows: tuple, c: int, b: int,
                           src_rows) -> BlockPlan:
    """A :class:`BlockPlan` from another plan's numpy fields."""
    return BlockPlan(bmmc=Bmmc(tuple(int(r) for r in rows), int(c)),
                     b=int(b), src_rows=np.asarray(src_rows, dtype=np.int32))


def lane_plan_from_arrays(rows: tuple, c: int, t: int, src_lane,
                          rows_per_block: int) -> LanePlan:
    """A :class:`LanePlan` from another plan's numpy fields."""
    return LanePlan(bmmc=Bmmc(tuple(int(r) for r in rows), int(c)),
                    t=int(t), src_lane=np.asarray(src_lane, dtype=np.int32),
                    rows_per_block=int(rows_per_block))


def _block_granularity(bmmc: Bmmc) -> int:
    """log2 elements per moved block: the class granularity capped at
    the copy baseline's block, so descriptor counts match the copy
    kernel's exactly whenever the class allows it."""
    return min(bmmc.block_bits(), _COPY_BLOCK_BITS, bmmc.n - 1)


def _lane_rows_per_block(n: int, t: int) -> int:
    """Rows staged per grid step: one copy-sized block when available."""
    return max(1, min(1 << (n - t), 1 << max(0, _COPY_BLOCK_BITS - t)))


def _linear_images(b: Bmmc) -> list:
    """Images of the unit vectors under ``b``'s matrix."""
    return [f2.matvec(b.rows, 1 << k) for k in range(b.n)]


def plan_block(bmmc: Bmmc, t: int) -> Optional[BlockPlan]:
    """Block-permute plan, or None if not tile-index-only at ``t``."""
    n = bmmc.n
    k = bmmc.block_bits()
    if not (0 < t <= k < n):
        return None
    b = _block_granularity(bmmc)
    # sub-BMMC on the high n-b bits (rows >= b read only columns >= b)
    sub_rows = tuple(bmmc.rows[i] >> b for i in range(b, n))
    sub_inv = Bmmc(sub_rows, bmmc.c >> b).inverse()
    src = _affine_table(_linear_images(sub_inv), sub_inv.c)
    return BlockPlan(bmmc=bmmc, b=b, src_rows=src.astype(np.int32))


def plan_lane(bmmc: Bmmc, t: int) -> Optional[LanePlan]:
    """Lane-permute plan, or None if not lane-local at ``t``."""
    n = bmmc.n
    if not bmmc.is_lane_local(t):
        return None
    low_mask = (1 << t) - 1
    sub_inv = Bmmc(tuple(bmmc.rows[i] & low_mask for i in range(t)),
                   bmmc.c & low_mask).inverse()
    src = _affine_table(_linear_images(sub_inv), sub_inv.c)
    return LanePlan(bmmc=bmmc, t=t, src_lane=src.astype(np.int32),
                    rows_per_block=_lane_rows_per_block(n, t))


def copy_descriptors(n: int) -> int:
    """Modeled descriptor count of the copy baseline for a 2^n array:
    one read + one write per copy block."""
    return 2 * (1 << max(0, n - _COPY_BLOCK_BITS))


def dispatch_kernel(bmmc: Bmmc, t: int) -> str:
    """The kernel the class dispatch selects:

    ``none`` (identity), ``block`` (block-remapped copy, no gather),
    ``lane`` (single on-chip row gather), ``tiled`` (classic §5.1 one-
    pass), ``general`` (generalized witness-direction one-pass), or
    ``general2`` (§5.2 two-pass fallback, t > n/2 only).
    """
    cls = bmmc.bmmc_class(t)
    if cls == "identity":
        return "none"
    if cls == "complement":
        # a high-only complement moves whole blocks; a low-only one
        # permutes lanes; a mixed complement is a BPC -> one tiled pass
        low_part, high_part = bmmc.c & ((1 << t) - 1), bmmc.c >> t
        if low_part and high_part:
            return "tiled"
        return "block" if not low_part else "lane"
    if cls in ("block", "lane", "tiled"):
        return cls
    return "general" if plan_stats_general(bmmc, t) else "general2"


def class_stats(bmmc: Bmmc, t: int) -> dict:
    """Analytic per-class execution stats: the BMMC class, dispatched
    kernel, pass count, modeled DMA descriptors, and the copy-roofline
    ratio (copy descriptors / class descriptors; 1.0 == executes at the
    speed of an array copy, the paper's §2.3 reference point)."""
    n = bmmc.n
    cls = bmmc.bmmc_class(t)
    kernel = dispatch_kernel(bmmc, t)
    copy_desc = copy_descriptors(n)
    if kernel == "none":
        desc, passes = 0, 0
    elif kernel == "block":
        desc, passes = 2 * (1 << (n - _block_granularity(bmmc))), 1
    elif kernel == "lane":
        desc = 2 * ((1 << (n - t)) // _lane_rows_per_block(n, t))
        passes = 1
    else:
        stats = stats_bmmc(bmmc, t)
        desc = sum(s.dma_descriptors() for s in stats)
        passes = len(stats)
    return {"class": cls, "kernel": kernel, "passes": passes,
            "descriptors": desc, "copy_descriptors": copy_desc,
            "roofline_ratio": copy_desc / max(desc, 1) if passes else 1.0}
