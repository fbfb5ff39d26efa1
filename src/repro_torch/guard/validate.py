"""Ring 1 — plan-time validation: the counterpart of the ring-1 subset of
:mod:`repro.guard.validate`.

* **BMMC invertibility** — :func:`verify_bmmc` re-runs the F2 rank
  check on the actual matrix (``__post_init__`` ran it at construction,
  but a matrix reaching the planner through ``object.__setattr__`` never
  went through the constructor).
* **Descriptor-bounds + semantic audit** — :func:`audit_tile_plan` /
  :func:`audit_block_plan` / :func:`audit_lane_plan` check every table
  entry against the geometry (bounds, bijectivity) and then check the
  kernel contract itself against the BMMC: for a tiled pass,

      ``out.flat[j] = tile.flat[src0[j ^ xor_low[g]]]``

  must route every element where ``bmmc.apply`` sends it. Full over all
  tiles up to ``_FULL_AUDIT_TILES``; deterministically sampled beyond.

Unlike the reference, the semantic checks apply the BMMC only to the
indices they audit instead of tabulating all ``2^n`` images first, so an
audit stays cheap at the paper's size (n = 30). The verdicts are the
same. The stage, program and cache audits arrive with the combinator
layer.
"""
from __future__ import annotations

import numpy as np

from ..core import f2
from ..core.bmmc import Bmmc
from ..core.tiling import BlockPlan, LanePlan, TilePlan
from .errors import DescriptorOOB, NotInvertible

_FULL_AUDIT_TILES = 64        # audit every tile up to this many
_SAMPLE_TILES = 16            # strided sample beyond


def _np_parity(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        v ^= v >> s
    return v & 1


def _bmmc_apply(b: Bmmc, idx: np.ndarray) -> np.ndarray:
    """``b.apply`` over an int64 index array."""
    idx = np.asarray(idx, dtype=np.int64)
    out = np.zeros_like(idx)
    for j, row in enumerate(b.rows):
        out |= _np_parity(idx & row) << j
    return out ^ b.c


def verify_bmmc(bmmc: Bmmc) -> Bmmc:
    """Prove ``bmmc`` is a well-formed affine permutation: square
    bit-ranged rows, ``c`` in range, and full F2 rank. Returns the BMMC
    so call sites can validate inline."""
    n = len(bmmc.rows)
    mask = (1 << n) - 1
    bad = [i for i, r in enumerate(bmmc.rows)
           if not isinstance(r, int) or r < 0 or r > mask]
    if bad:
        raise NotInvertible(
            f"BMMC row(s) {bad} fall outside the {n}-bit column range "
            f"(expected 0 <= row <= {mask:#x})")
    if not 0 <= bmmc.c <= mask:
        raise NotInvertible(
            f"BMMC complement {bmmc.c:#x} outside the {n}-bit range")
    r = f2.rank(bmmc.rows)
    if r != n:
        raise NotInvertible(
            f"BMMC matrix is singular over F2: rank {r}, expected {n} "
            f"(a corrupted row makes the 'permutation' lossy)")
    return bmmc


def _bounds(name: str, arr: np.ndarray, lo: int, hi: int, where: str):
    a = np.asarray(arr)
    if a.size and (a.min() < lo or a.max() >= hi):
        raise DescriptorOOB(
            f"{where}: {name} entries fall outside [{lo}, {hi}): "
            f"min {int(a.min())}, max {int(a.max())}")


def _tile_sample(n_tiles: int):
    if n_tiles <= _FULL_AUDIT_TILES:
        return range(n_tiles)
    step = max(1, n_tiles // _SAMPLE_TILES)
    picks = set(range(0, n_tiles, step))
    picks.update((0, n_tiles - 1))
    return sorted(picks)


def audit_tile_plan(plan: TilePlan) -> None:
    """Bounds + semantic audit of one tiled pass against the kernel
    contract ``out.flat[j] = tile.flat[src0[j ^ xor_low[g]]]``."""
    n, t = plan.n, plan.t
    rpt, row_len = plan.rows_per_tile, plan.row_len
    n_rows = 1 << (n - t)
    where = f"TilePlan(n={n}, t={t})"
    for nm, arr, shape in (("in_rows", plan.in_rows, (plan.n_tiles, rpt)),
                           ("out_rows", plan.out_rows, (plan.n_tiles, rpt)),
                           ("xor_low", plan.xor_low, (plan.n_tiles,)),
                           ("src0", plan.src0, (rpt, row_len))):
        if np.asarray(arr).shape != shape:
            raise DescriptorOOB(
                f"{where}: {nm} shape {np.asarray(arr).shape} != "
                f"expected {shape} (truncated or mis-stacked table)")
    _bounds("in_rows", plan.in_rows, 0, n_rows, where)
    _bounds("out_rows", plan.out_rows, 0, n_rows, where)
    _bounds("xor_low", plan.xor_low, 0, row_len, where)
    _bounds("src0", plan.src0, 0, rpt * row_len, where)
    src_flat = plan.src0.reshape(-1).astype(np.int64)
    if np.unique(src_flat).size != src_flat.size:
        raise DescriptorOOB(
            f"{where}: src0 gather table is not a bijection of the tile "
            f"(duplicate sources silently drop elements)")
    j = np.arange(rpt * row_len, dtype=np.int64)
    rp, cp = j // row_len, j % row_len
    for g in _tile_sample(plan.n_tiles):
        src = src_flat[j ^ int(plan.xor_low[g])]
        r, c = src // row_len, src % row_len
        x_glob = plan.in_rows[g, r].astype(np.int64) * row_len + c
        y_glob = plan.out_rows[g, rp].astype(np.int64) * row_len + cp
        img = _bmmc_apply(plan.bmmc, x_glob)
        bad = img != y_glob
        if bad.any():
            k = int(np.argmax(bad))
            raise DescriptorOOB(
                f"{where}: tile {g} routes input {int(x_glob[k])} to "
                f"output {int(y_glob[k])}, but the BMMC maps it to "
                f"{int(img[k])} (swapped/corrupted descriptor)")


def audit_block_plan(plan: BlockPlan) -> None:
    n, b = plan.n, plan.b
    n_rows = 1 << (n - b)
    where = f"BlockPlan(n={n}, b={b})"
    src = np.asarray(plan.src_rows)
    if src.shape != (n_rows,):
        raise DescriptorOOB(f"{where}: src_rows shape {src.shape} != "
                            f"expected {(n_rows,)}")
    _bounds("src_rows", src, 0, n_rows, where)
    if np.unique(src).size != src.size:
        raise DescriptorOOB(f"{where}: src_rows is not a permutation of "
                            f"the {n_rows} blocks")
    blk = 1 << b
    g = np.arange(n_rows, dtype=np.int64)
    offs = sorted({0, 1 % blk, blk // 2, blk - 1})
    for off in offs:
        got = _bmmc_apply(plan.bmmc, src.astype(np.int64) * blk + off)
        want = g * blk + off
        bad = got != want
        if bad.any():
            k = int(np.argmax(bad))
            raise DescriptorOOB(
                f"{where}: block {k} reads input block {int(src[k])}, "
                f"but the BMMC maps element {int(src[k]) * blk + off} to "
                f"{int(got[k])}, not {int(want[k])}")


def audit_lane_plan(plan: LanePlan) -> None:
    n, t = plan.n, plan.t
    row_len = 1 << t
    where = f"LanePlan(n={n}, t={t})"
    src = np.asarray(plan.src_lane)
    if src.shape != (row_len,):
        raise DescriptorOOB(f"{where}: src_lane shape {src.shape} != "
                            f"expected {(row_len,)}")
    _bounds("src_lane", src, 0, row_len, where)
    if np.unique(src).size != src.size:
        raise DescriptorOOB(f"{where}: src_lane is not a permutation of "
                            f"the {row_len} lanes")
    lane = np.arange(row_len, dtype=np.int64)
    for row in sorted({0, plan.n_rows // 2, plan.n_rows - 1}):
        got = _bmmc_apply(plan.bmmc, row * row_len + src.astype(np.int64))
        want = row * row_len + lane
        bad = got != want
        if bad.any():
            k = int(np.argmax(bad))
            raise DescriptorOOB(
                f"{where}: row {row} lane {k} reads lane {int(src[k])}, "
                f"but the BMMC maps it to {int(got[k])}, not "
                f"{int(want[k])}")
