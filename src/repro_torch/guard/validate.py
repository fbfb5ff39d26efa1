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

* **Program audits** — :func:`validate_program` (and its identity-memo
  front :func:`validate_program_fast`, what ``CompiledExpr`` calls when
  the guard is on) proves every stage of a resolved program: the BMMC
  rank, the cached class-dispatch decision re-derived from the matrix
  (:func:`validate_dispatch`), and each fused cluster's composed matrix
  against its member stages, its pass plans and its epilogue tables'
  shapes.
* **Input preconditions** — :func:`validate_input` (shape, power-of-2
  length, dtype known) raising :class:`~.errors.BadInput`.

Every validated plan's tables are fingerprinted (position-sensitive
XOR-fold, so swapping two entries changes the fingerprint);
:func:`check_fingerprints` re-hashes the live tables against the
recorded values so a runtime trap can be classified as
:class:`~.errors.CachePoisoned` (tables mutated *after* validation). The
live tables are the host arrays and every copy of them kept on a device
(the tables a kernel reads); a device copy is brought to the host only
on that failure path.

Unlike the reference, the semantic checks apply the BMMC only to the
indices they audit instead of tabulating all ``2^n`` images first, so an
audit stays cheap at the paper's size (n = 30). The verdicts are the
same.
"""
from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from ..core import f2
from ..core.bmmc import Bmmc
from ..core.tiling import BlockPlan, LanePlan, TilePlan
from .errors import (BadInput, CachePoisoned, ClassMismatch, DescriptorOOB,
                     NotInvertible)

_FULL_AUDIT_TILES = 64        # audit every tile up to this many
_SAMPLE_TILES = 16            # strided sample beyond
_FP_CHUNK = 1 << 22           # elements a fingerprint folds per step

_FP_LOCK = threading.Lock()
_FINGERPRINTS: dict = {}      # plan key -> recorded table fingerprint


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


def validate_input(shape: tuple, dtype, *, batched: bool = False,
                   n: int = None) -> int:
    """Shape/dtype preconditions on a program input. Returns the size
    exponent of the permuted axis; raises :class:`BadInput` otherwise.
    ``dtype`` is a torch or numpy dtype."""
    axis = 1 if batched else 0
    if len(shape) <= axis:
        what = ("a leading batch dim plus the permuted axis" if batched
                else "a permutable leading axis")
        raise BadInput(f"input needs {what}, got shape {tuple(shape)}")
    if len(shape) > axis + 2:
        raise BadInput(
            f"input rank {len(shape)} unsupported: expected "
            f"{'(B, 2^n[, d])' if batched else '(2^n[, d])'}, "
            f"got shape {tuple(shape)}")
    size = shape[axis]
    got_n = int(size).bit_length() - 1
    if size <= 0 or (1 << got_n) != size:
        raise BadInput(
            f"array length {size} on axis {axis} is not a power of 2")
    if n is not None and got_n != n:
        raise BadInput(
            f"program expects a 2^{n}-length axis, got 2^{got_n} "
            f"({size}) in shape {tuple(shape)}")
    if not isinstance(dtype, torch.dtype):
        try:
            np.dtype(dtype)
        except TypeError:
            raise BadInput(f"unknown input dtype {dtype!r}") from None
    return got_n


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


def _audit_compute_tables(ct, plan: TilePlan, where: str) -> None:
    """Shape audit of one epilogue's parity/twiddle tables (the
    truncated-parity-table corruption class)."""
    rpt, row_len, n_tiles = (plan.rows_per_tile, plan.row_len, plan.n_tiles)
    want = {"hi_row": (rpt,), "hi_lane": (row_len,), "hi_base": (n_tiles,),
            "tw_row": (rpt,), "tw_lane": (row_len,), "tw_base": (n_tiles,)}
    for nm, shape in want.items():
        arr = getattr(ct, nm, None)
        if arr is None:
            continue
        got = np.asarray(arr).shape
        if got != shape:
            raise DescriptorOOB(
                f"{where}: epilogue {ct.kind} table {nm} shape {got} != "
                f"expected {shape} (truncated parity/twiddle table)")


# ---------------------------------------------------------------------------
# fingerprints (cache-poisoning detection)
# ---------------------------------------------------------------------------

def _fp_array(arr) -> int:
    """Position-sensitive XOR-fold of an array's entries (as uint64): the
    reference's fingerprint, folded in chunks of ``_FP_CHUNK`` entries so
    a 2^24-entry table costs no 2^24-entry temporaries."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr)).reshape(-1)
    acc = np.uint64(0)
    with np.errstate(over="ignore"):
        for s in range(0, a.size, _FP_CHUNK):
            v = a[s:s + _FP_CHUNK].astype(np.uint64)
            idx = np.arange(s, s + v.size, dtype=np.uint64)
            mixed = (v + np.uint64(0x9E3779B97F4A7C15)) * (
                (idx << np.uint64(1)) | np.uint64(1))
            acc ^= np.bitwise_xor.reduce(mixed)
    return int(acc) ^ (a.size << 1)


def _tables_of(kernel: str, payload) -> list:
    """The table lists of a class-dispatch payload, one per plan."""
    if kernel == "block":
        return [(payload.src_rows,)]
    if kernel == "lane":
        return [(payload.src_lane,)]
    if kernel == "none":
        return []
    return [(p.in_rows, p.out_rows, p.xor_low, p.src0) for p in payload]


def _fold(kernel: str, table_lists) -> int:
    fp = hash(kernel) & 0xFFFFFFFF
    for tabs in table_lists:
        for arr in tabs:
            fp ^= _fp_array(arr)
    return fp


def plan_fingerprint(kernel: str, payload) -> int:
    """Position-sensitive XOR-fold over every table of a class-dispatch
    payload — swapping two entries changes it, unlike a plain XOR."""
    return _fold(kernel, _tables_of(kernel, payload))


def _live_fingerprints(kernel: str, payload) -> dict:
    """The payload's fingerprint over its host tables (key None) and over
    each device's copies of them (key: the device; a copy is brought to
    the host here, on the failure path only)."""
    from ..kernels import bmmc_permute as K

    host = _tables_of(kernel, payload)
    out = {None: _fold(kernel, host)}
    if kernel == "none":
        return out
    plans = payload if kernel not in ("block", "lane") else (payload,)
    copies = [K.device_copies(p, "tables") for p in plans]
    for dev in set().union(*copies):
        out[dev] = _fold(kernel, [c.get(dev, tabs)
                                  for c, tabs in zip(copies, host)])
    return out


def _fused_fold(fps_per_plan) -> int:
    fp = 0
    for f in fps_per_plan:
        fp ^= f ^ hash("tiled")
    return fp ^ hash("tiled")


def _record_fp(key, fp: int) -> None:
    with _FP_LOCK:
        _FINGERPRINTS[key] = fp


def check_fingerprints(prog, t) -> list:
    """Re-hash the LIVE plan tables of every stage against the
    fingerprints recorded at validation; returns the mismatched keys
    (non-empty == the tables were mutated after ring 1 signed off). The
    live tables are the host arrays and each device's copies of them."""
    from ..combinators.optimize import FusedStage
    from ..combinators import execute as _ex
    from ..kernels import ops

    poisoned = []
    for st in prog:
        if isinstance(st, FusedStage):
            key = ("fused", st, t)
            got = _ex._fused_plan_cached(st, t)
            if got is None:
                continue
            per_plan = [_live_fingerprints("tiled", (p,)) for p in got[0]]
            keys = set().union(*per_plan)
            fps = {_fused_fold(d.get(k, d[None]) for d in per_plan)
                   for k in keys}
        elif hasattr(st, "bmmc"):
            key = ("class", st.bmmc.rows, st.bmmc.c, t)
            kernel, payload = ops.class_plan(st.bmmc, t)
            fps = set(_live_fingerprints(kernel, payload).values())
        else:
            continue
        with _FP_LOCK:
            want = _FINGERPRINTS.get(key)
        if want is not None and any(f != want for f in fps):
            poisoned.append(key)
    return poisoned


# ---------------------------------------------------------------------------
# dispatch + whole-program validation (cached)
# ---------------------------------------------------------------------------

def _audit_payload(bmmc: Bmmc, t: int, kernel: str, payload) -> None:
    if kernel == "block":
        if not isinstance(payload, BlockPlan):
            raise ClassMismatch(
                f"kernel 'block' carries a {type(payload).__name__} "
                f"payload, expected BlockPlan")
        if bmmc.block_bits() < payload.b:
            raise ClassMismatch(
                f"plan dispatched as 'block' (b={payload.b}) but the "
                f"matrix is only block-granular to "
                f"{bmmc.block_bits()} bits")
        audit_block_plan(payload)
    elif kernel == "lane":
        if not isinstance(payload, LanePlan):
            raise ClassMismatch(
                f"kernel 'lane' carries a {type(payload).__name__} "
                f"payload, expected LanePlan")
        if not (bmmc.is_lane_local(t) or
                (bmmc.is_complement_only() and bmmc.c >> t == 0)):
            raise ClassMismatch(
                f"plan dispatched as 'lane' but the matrix is not "
                f"lane-local at t={t}")
        audit_lane_plan(payload)
    elif kernel != "none":
        for plan in payload:
            if not isinstance(plan, TilePlan):
                raise ClassMismatch(
                    f"kernel {kernel!r} pass carries a "
                    f"{type(plan).__name__}, expected TilePlan")
            audit_tile_plan(plan)


@functools.lru_cache(maxsize=512)
def validate_dispatch(rows: tuple, c: int, t: int) -> str:
    """Prove the cached class-dispatch decision for ``(bmmc, t)``:
    re-derive the kernel from the matrix, check the payload satisfies
    the class predicate, audit its tables, and record the fingerprint.
    Returns the kernel name."""
    from ..core.tiling import dispatch_kernel
    from ..kernels import ops

    # build without __post_init__ so a singular matrix reaches the rank
    # check here and raises the typed NotInvertible, not a bare error
    bmmc = Bmmc.__new__(Bmmc)
    object.__setattr__(bmmc, "rows", tuple(rows))
    object.__setattr__(bmmc, "c", c)
    verify_bmmc(bmmc)
    kernel, payload = ops.class_plan(bmmc, t)
    fresh = dispatch_kernel(bmmc, t)
    if kernel != fresh:
        raise ClassMismatch(
            f"cached dispatch says kernel {kernel!r} for this matrix at "
            f"t={t}, but re-deriving from the matrix gives {fresh!r} "
            f"(stale or poisoned class-plan cache)")
    _audit_payload(bmmc, t, kernel, payload)
    _record_fp(("class", rows, c, t), plan_fingerprint(kernel, payload))
    return kernel


def _validate_fused(fs, t: int) -> None:
    from ..combinators import execute as _ex
    from ..combinators.optimize import _run_fused

    verify_bmmc(fs.bmmc)
    recomposed = _run_fused(fs.stages, fs.bmmc.n)
    if recomposed.bmmc != fs.bmmc:
        raise ClassMismatch(
            f"FusedStage composed BMMC {fs.bmmc!r} does not equal the "
            f"recomposition of its member stages {recomposed.bmmc!r} "
            f"(fold-free/cluster bookkeeping drift)")
    got = _ex._fused_plan_cached(fs, t)
    if got is None:
        return  # the fused kernel rejects it; executor replays per stage
    plans, entries = got
    for p in plans:
        verify_bmmc(p.bmmc)
        audit_tile_plan(p)
    where = f"FusedStage(n={fs.bmmc.n}, t={t})"
    for e in entries:
        if e[0] in ("cmp", "bfly"):
            _audit_compute_tables(e[2], plans[0], where)
    _record_fp(("fused", fs, t), _fused_fold(
        plan_fingerprint("tiled", (p,)) for p in plans))


@functools.lru_cache(maxsize=1024)
def validate_program(prog: tuple, t) -> int:
    """Ring-1 entry point: prove every stage of a resolved program
    before its plans are trusted (cached per ``(program, t)`` — one
    validation pass per compiled program, not per call). Returns the
    number of stages audited."""
    from ..combinators.ir import Perm
    from ..combinators.optimize import FusedStage

    audited = 0
    for si, st in enumerate(prog):
        try:
            if isinstance(st, Perm):
                verify_bmmc(st.bmmc)
                if t is not None:
                    validate_dispatch(st.bmmc.rows, st.bmmc.c, t)
                audited += 1
            elif isinstance(st, FusedStage):
                if t is not None:
                    _validate_fused(st, t)
                else:
                    verify_bmmc(st.bmmc)
                audited += 1
        except (NotInvertible, ClassMismatch, DescriptorOOB, BadInput,
                CachePoisoned) as e:
            e.args = (f"stage {si}/{len(prog)} "
                      f"({type(st).__name__}): {e.args[0]}",) + e.args[1:]
            raise
    return audited


class IdentityMemo:
    """Bounded identity-keyed front memo with LRU eviction.

    Keys on ``id(owner)`` and stores a strong reference to the owner,
    so a stale id can never alias a different (garbage-collected)
    object: :meth:`lookup`'s ``is`` check proves the key still names
    the memoized owner."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, key, owner):
        hit = self._d.get(key)
        if hit is not None and hit[0] is owner:
            self._d.move_to_end(key)
            self.hits += 1
            return hit[1]
        self.misses += 1
        return None

    def store(self, key, owner, value) -> None:
        self._d[key] = (owner, value)
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()
        self.hits = self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def cache_info(self) -> tuple:
        """(hits, misses, maxsize, currsize) — the lru_cache vocabulary."""
        return (self.hits, self.misses, self.maxsize, len(self._d))


# Identity-keyed front memo over validate_program: resolved program
# tuples are themselves lru-cached (execute._clustered_cached), so the
# same object arrives on every warm call, and an identity hit skips
# hashing the deep (stages x BMMC rows) key.
_VALIDATED_FAST = IdentityMemo(maxsize=2048)


def validate_program_fast(prog: tuple, t) -> None:
    key = (id(prog), t)
    if _VALIDATED_FAST.lookup(key, prog) is None:
        validate_program(prog, t)
        _VALIDATED_FAST.store(key, prog, True)


# ---------------------------------------------------------------------------
# cache hygiene
# ---------------------------------------------------------------------------

def guard_cache_stats() -> dict:
    """Guard-cache stats in the executor's ``CacheStats`` vocabulary —
    merged into :func:`repro_torch.combinators.execute.cache_stats`."""
    from . import runtime as _rt
    out = {"guard_validate": validate_program.cache_info(),
           "guard_dispatch": validate_dispatch.cache_info(),
           "guard_validate_fast": _VALIDATED_FAST.cache_info()}
    out.update(_rt.executable_cache_stats())
    return out


def clear_guard_caches() -> None:
    validate_program.cache_clear()
    validate_dispatch.cache_clear()
    _VALIDATED_FAST.clear()
    with _FP_LOCK:
        _FINGERPRINTS.clear()
    from . import runtime as _rt
    _rt.clear_executables()
