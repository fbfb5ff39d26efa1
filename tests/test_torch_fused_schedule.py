"""K4b's and K5's work-item schedule on the CPU (``k4b_schedule``,
``k5_schedule`` and ``tile_items.cuh``), held against the JAX reference.

The CUDA kernels (``tile_fused.cu``, ``tile_bwd.cu``) run only on the
card. Here their data movement is emulated in numpy from the very launch
descriptor the host builds (``_EpiArgs``), mirroring the kernels' index
arithmetic: the work items a block takes (across batch rows), the rows
copied into a tile padded by one 16-byte chunk (16-byte copies, or one
word), K4b's gather (16 bytes a thread: consecutive lanes whose src0
entries are read at once and taken in XOR order, or one word) and K5's
un-gather of the cotangent and row copy-out. With the epilogues left out,
K4b's movement is the pass's permutation and K5's its transpose, held bit
for bit against the reference's plain gather
(``repro.kernels.ref.bmmc_ref``) of the BMMC and of its inverse on inputs
made with numpy from a seed. Also: the schedules' coverage, shared-memory
and path rules, the bank model of the epilogue plan against a brute-force
count over the tile the copies fill, and each work item's epilogue bases
(the hi bit and twiddle index of every position of a block of several
items) against the tables. The guarded K4b (the same schedule, its tests
where it stages the tables and in the gather) is emulated with one
table entry poisoned, its epilogues run between load and gather, and
held against the guarded plain version and the reference's OOB probe.
Tolerance: none, everything here moves bits or counts.
"""
import functools
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.combinators as rcomb
from repro.combinators import execute as rex
from repro.core.bmmc import Bmmc as RBmmc
from repro.guard import runtime as rrt
from repro.kernels import ref as rref
from repro_torch.combinators import FusedStage, compile_expr
from repro_torch.combinators import execute as pex
from repro_torch.combinators.fft import fft_expr
from repro_torch.combinators.sort import sort_expr
from repro_torch.core import tiling as ptiling
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import epilogue_plan as EP

_UINT = {2: np.uint16, 4: np.uint32}
_SMEM_MAX = 227 * 1024


def _blocks(a):
    """[(batch row, work item of the row)] of each block, as stage_items
    takes them."""
    out = []
    for blk in range(a.grid):
        w0 = blk * a.groups
        out.append([divmod(w, a.n_groups)
                    for w in range(w0, min(w0 + a.groups, a.n_work))])
    return out


def _load(a, xw_b, rows_tab, rows):
    """A work item's rows into a tile (shared-memory words), as
    load_item_rows copies them; also where each row word landed. A row
    staged as -1 (the guarded K4b) is filled with zeros, not read."""
    row_words = (1 << a.t) * a.wpe
    span = rows * row_words
    step = 16 // a.word_bytes if a.vec else 1
    tile = np.zeros(rows * a.stride, xw_b.dtype)
    place = np.full(span, -1, np.int64)
    li = np.arange(0, span, step)
    r, q = li // row_words, li % row_words
    ok = rows_tab[r] >= 0
    for i in range(step):
        at = r * a.stride + q + i
        tile[at] = np.where(ok, xw_b[np.maximum(rows_tab[r], 0) * row_words
                                     + q + i], 0)
        place[li + i] = at
    assert (place >= 0).all() and np.unique(place).size == span
    if a.vec:   # whole 16-byte chunks, to 16-byte aligned rows
        assert (q % step == 0).all() and (a.stride * a.word_bytes) % 16 == 0
    return tile, place


def _staged(tab, hi, guard):
    """A table's entries as stage_items stages them: with ``guard``, an
    entry outside [0, hi) as -1, and whether one was."""
    if not guard:
        return tab, False
    ok = (tab >= 0) & (tab < hi)
    return np.where(ok, tab, -1), bool((~ok).any())


def emulate_k4b(a, xw, tabs, guard=False, phases=None):
    """K4b's data movement under descriptor ``a`` (the phases leave the
    tile as loaded, or ``phases(tile, b, grp)`` runs them on it): with
    ``guard`` the guarded K4b's, in its order (row ids and lane XORs
    tested as they are staged, a row not read loaded as zeros, each src0
    entry the gather reads tested, on the 16-byte path four an int4, a
    tile with a bad lane XOR reading none and storing zeros, a row with a
    bad output id not written). Returns the output words (every word
    written once), or with ``guard`` (output words, written mask, flag)."""
    in_rows, out_rows, xor_low, src0 = (
        np.asarray(v).reshape(-1).astype(np.int64) for v in tabs)
    t, rs_, wpe = a.t, a.rpt_shift, a.wpe
    rpt, lane = 1 << rs_, (1 << t) - 1
    rows = a.per_cta << rs_
    row_words = (1 << t) * wpe
    out = np.zeros_like(xw)
    seen = np.zeros(xw.shape, np.int64)
    bad = False
    for items in _blocks(a):
        for b, grp in items:
            rin, b1 = _staged(in_rows[grp * rows:(grp + 1) * rows],
                              a.n_rows, guard)
            rout, b2 = _staged(out_rows[grp * rows:(grp + 1) * rows],
                               a.n_rows, guard)
            xls, b3 = _staged(xor_low[grp * a.per_cta:
                                      (grp + 1) * a.per_cta], 1 << t, guard)
            bad |= b1 or b2 or b3
            tile, _ = _load(a, xw[b], rin, rows)
            if phases is not None:
                tile = phases(tile, b, grp)
            step = 16 // a.word_bytes if a.vec else 1
            li = np.arange(0, rows * row_words, step)
            r, rem = li // row_words, li % row_words
            j, rp = r >> rs_, r & (rpt - 1)
            xl = xls[j]
            read = xl >= 0        # a tile with a bad lane XOR reads no src0
            xl = np.maximum(xl, 0)
            wr = rout[r] >= 0     # rows written
            dst = np.maximum(rout[r], 0) * row_words + rem
            if a.vec:
                ve = step // a.dv
                m = np.arange(ve)
                l0 = rem // a.dv
                ents = src0[((rp << t) | (l0 ^ (xl & ~(ve - 1))))[:, None]
                            + m]
                sm = np.take_along_axis(ents, m ^ (xl & (ve - 1))[:, None],
                                        axis=1)
                ok = read[:, None] & (sm >= 0) & (sm < rpt << t)
                bad |= bool((read[:, None] & ~ok).any())
                sm = np.where(ok, sm, 0)
                rs = (j[:, None] << rs_) | (sm >> t)
                base = rs * a.stride + (sm & lane) * a.dv
                for w in range(a.dv):
                    at = (dst[:, None] + m * a.dv + w)[wr]
                    out[b, at] = np.where(ok, tile[base + w], 0)[wr]
                    np.add.at(seen[b], at.ravel(), 1)
            else:
                cp, wd = rem // wpe, rem % wpe
                s = src0[(rp << t) | (cp ^ xl)]
                ok = read & (s >= 0) & (s < rpt << t)
                bad |= bool((read & ~ok).any())
                s = np.where(ok, s, 0)
                rs = (j << rs_) | (s >> t)
                val = np.where(ok, tile[rs * a.stride + (s & lane) * wpe
                                        + wd], 0)
                out[b, dst[wr]] = val[wr]
                np.add.at(seen[b], dst[wr], 1)
    if guard:
        assert seen.max() <= 1
        return out, seen == 1, int(bad)
    assert (seen == 1).all()
    return out


def emulate_k5(a, cw, tabs):
    """K5's data movement under descriptor ``a`` with no epilogues: the
    cotangent's rows into the ct tile, the un-gather into the x tile
    (load_ungathered), the x tile's rows copied out where the forward
    read."""
    in_rows, out_rows, xor_low, inv = (
        np.asarray(v).reshape(-1).astype(np.int64) for v in tabs)
    t, rs_, wpe = a.t, a.rpt_shift, a.wpe
    rpt, lane = 1 << rs_, (1 << t) - 1
    rows = a.per_cta << rs_
    row_words = (1 << t) * wpe
    span = rows * row_words
    out = np.zeros_like(cw)
    seen = np.zeros(cw.shape, np.int64)
    for items in _blocks(a):
        for b, grp in items:
            rin = in_rows[grp * rows:(grp + 1) * rows]
            rout = out_rows[grp * rows:(grp + 1) * rows]
            xls = xor_low[grp * a.per_cta:(grp + 1) * a.per_cta]
            ctile, _ = _load(a, cw[b], rout, rows)
            q = np.arange(rows << t)
            r = q >> t
            j = r >> rs_
            s = inv[((r & (rpt - 1)) << t) | (q & lane)] ^ xls[j]
            src_row = (j << rs_) | (s >> t)
            xtile = np.zeros_like(ctile)
            for w in range(wpe):
                xtile[r * a.stride + (q & lane) * wpe + w] = ctile[
                    src_row * a.stride + (s & lane) * wpe + w]
            step = 16 // a.word_bytes if a.vec else 1
            li = np.arange(0, span, step)
            r, qq = li // row_words, li % row_words
            for i in range(step):
                at = rin[r] * row_words + qq + i
                out[b, at] = xtile[r * a.stride + qq + i]
                np.add.at(seen[b], at, 1)
    assert (seen == 1).all()
    return out


def _payload(shape, dtype, seed):
    raw = np.random.default_rng(seed).integers(0, 1 << 30, size=shape,
                                               dtype=np.int64)
    dt = np.dtype(dtype)
    if dt.itemsize == 2:   # below bfloat16's NaNs (XLA canonicalises them)
        return (raw & 0x7F00).astype(np.uint16).view(dt)
    return raw.astype(np.uint32).view(dt)


def _words(arr, wb, batch):
    return np.ascontiguousarray(arr).view(np.uint8).reshape(batch, -1).view(
        _UINT[wb])


def _ref(arr, b, batch):
    return np.ascontiguousarray(np.asarray(rref.bmmc_ref(
        jnp.asarray(arr), RBmmc(b.rows, b.c), batched=True))).reshape(
            (batch, -1) + arr.shape[2:])


_KINDS = {"bitrev": lambda n, rng: PBmmc.bit_reverse(n),
          "bpc": lambda n, rng: PBmmc.random_bpc(n, rng),
          "bmmc": lambda n, rng: PBmmc.random(n, rng)}

# (kind, n, t, dtype, d, dv, batch): one-word elements of 4 and 2 bytes,
# planar float32 pairs (dv = 2), a 3-value tail (the word path), rows of
# fewer than 16 bytes (bfloat16 at t = 2: the word path)
_CASES = [
    ("bitrev", 10, 4, np.float32, 1, 1, 3),
    ("bmmc", 10, 4, np.int32, 1, 1, 1),
    ("bpc", 11, 5, ml_dtypes.bfloat16, 1, 1, 2),
    ("bmmc", 10, 4, np.float32, 2, 2, 2),
    ("bitrev", 9, 3, np.float32, 3, 1, 1),
    ("bmmc", 8, 2, ml_dtypes.bfloat16, 1, 1, 3),
]


@pytest.mark.parametrize("kind,n,t,dtype,d,dv,batch", _CASES)
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_item_movement_matches_the_reference(kind, n, t, dtype, d, dv,
                                             batch, groups):
    """K4b's movement is the pass's BMMC and K5's its inverse, under blocks
    of 1-3 work items that span batch rows, on the 16-byte path (aligned)
    and the word path (a pointer off by one element)."""
    b = _KINDS[kind](n, random.Random(n * 31 + t))
    plan = ptiling.plan_bmmc(b, t)[0]
    geometry = pk.plan_geometry(plan)
    shape = (batch, 1 << n) + ((d,) if d > 1 else ())
    arr = _payload(shape, dtype, n + t + d)
    itemsize = np.dtype(dtype).itemsize
    want = _words(_ref(arr, b, batch), itemsize, batch)
    want_t = _words(_ref(arr, b.inverse(), batch), itemsize, batch)
    tabs = pk.device_tables(plan, torch.device("cpu"))
    s0 = plan.src0.reshape(-1)
    inv = np.empty_like(s0)
    inv[s0] = np.arange(s0.size, dtype=s0.dtype)
    btabs = tabs[:3] + (torch.from_numpy(inv.reshape(plan.src0.shape)),)
    info = {"hmask": [0], "reg_bits": 3, "maps": 0}
    paths = set()
    for align in (0, itemsize):
        for kernel, tb, src, goal in (("k4b", tabs, arr, want),
                                      ("k5", btabs, arr, want_t)):
            fn = pk.k4b_schedule if kernel == "k4b" else pk.k5_schedule
            s = fn(geometry, batch, d, itemsize, align, n_words=100,
                   n_epi=1, dv=dv, groups=groups)
            plan_t = torch.zeros(100, dtype=torch.int64)
            plan_t.info = info
            a = pk._epi_args(s, tb, plan_t, geometry, batch,
                             torch.float32 if itemsize == 4
                             else torch.bfloat16, d, dv)
            assert (a.groups, a.n_work, a.vec) == (s.groups, s.n_work, s.vec)
            xw = _words(src, itemsize, batch)
            got = (emulate_k4b if kernel == "k4b" else emulate_k5)(a, xw, tb)
            assert np.array_equal(got, goal), (kernel, align, s)
            paths.add(s.vec)
    row_bytes = (1 << t) * d * itemsize
    assert paths == ({0, 1} if row_bytes % 16 == 0 and d == dv else {0})


def _sort_fft_clusters():
    """(label, geometry, entries, dtype) of clusters of the 2^10 sort (its
    largest and a one-row-tile one) and the 2^10 FFT, as the executor
    builds their epilogue entries."""
    out = []
    for name, expr, n, t, dtype in (("sort", sort_expr, 10, 4, torch.int32),
                                    ("fft", fft_expr, 10, 4,
                                     torch.float32)):
        prog = compile_expr(expr(n)).clustered_program(n, t)
        fss = [s for s in prog if isinstance(s, FusedStage) and s.computes]
        picked = {max(fss, key=lambda s: len(s.computes)).computes: None}
        for fs in fss:
            plans, entries = pex._fused_plan_cached(fs, t)
            if fs.computes in picked or plans[0].rows_per_tile == 1:
                sig, scal, vmem, fns = pex._fused_kernel_args(entries, dtype)
                ents = pk._epi_entries(sig, scal, vmem, fns, dtype)
                out.append((f"{name} {len(fs.computes)}",
                            pk.plan_geometry(plans[0]), ents, dtype))
                picked[fs.computes] = True
            if len(out) >= (2 if name == "sort" else 3):
                break
    return out


_CLUSTERS = _sort_fft_clusters()


@pytest.mark.parametrize("batch", [1, 3, 7])
@pytest.mark.parametrize("bwd", [False, True])
def test_schedules_cover_every_tile_once_and_fit(batch, bwd):
    """Every tile of every batch row belongs to exactly one work item of
    one block; a block's shared memory (counted as the kernel carves it)
    is the schedule's and fits 227 KB; two items are in flight where the
    block then stays within 48 KiB."""
    for label, geometry, ents, dtype in _CLUSTERS:
        if bwd and dtype == torch.int32:
            dtype = torch.float32
        dv = 2 if any(e[0] == 1 for e in ents) else 1
        d = dv
        xc = torch.zeros((batch, 1 << geometry[0], d), dtype=dtype)
        _, s, plan, _ = pk._epi_launch_args(xc, geometry, ents,
                                            n_buf=2 if bwd else 1)
        n_tiles, rpt = geometry[5], geometry[2]
        count = np.zeros((batch, n_tiles), np.int64)
        for items in _blocks(s):
            assert 1 <= len(items) <= s.groups
            for b, grp in items:
                count[b, grp * s.per_cta:(grp + 1) * s.per_cta] += 1
        assert (count == 1).all(), label
        assert s.per_cta * rpt << geometry[1] <= 4096
        rows = s.per_cta * rpt
        tile = (rows * s.stride * s.word_bytes + 15) & ~15
        extra = 0
        if bwd:
            info = plan.info
            extra = (EP.spill_sids(info) * dv * 4 + (
                info["maps"] << info["outer_bits"]) * xc.element_size()) \
                * 256 * 8
        want = (((s.groups * 8 + 15) & ~15)
                + ((s.groups * (2 * rows + s.per_cta + 2 * len(ents)) * 4
                    + 15) & ~15)
                + ((plan.numel() * 4 + 15) & ~15)
                + s.n_buf * (2 if bwd else 1) * tile + extra)
        assert s.smem == want <= _SMEM_MAX, label
        one = want - (tile * (2 if bwd else 1) if s.n_buf == 2 else 0)
        two = one + tile * (2 if bwd else 1)
        assert s.n_buf == (2 if s.groups > 1 and two <= 48 * 1024 else 1)
        assert s.stride * s.word_bytes == ((1 << geometry[1]) * d
                                           * xc.element_size() + 16)


@pytest.mark.parametrize("dtype,d,dv,t,align,vec", [
    (np.float32, 1, 1, 4, 0, 1), (np.float32, 1, 1, 4, 4, 0),
    (np.float32, 1, 1, 4, 8, 0), (np.float32, 1, 1, 1, 0, 0),
    (np.float32, 2, 2, 4, 0, 1), (np.float32, 2, 1, 4, 0, 0),
    (np.float32, 3, 1, 4, 0, 0), (ml_dtypes.bfloat16, 1, 1, 3, 0, 1),
    (ml_dtypes.bfloat16, 1, 1, 2, 0, 0), (ml_dtypes.bfloat16, 1, 1, 6, 2, 0),
    (np.int32, 1, 1, 6, 16, 1)])
def test_sixteen_byte_path_only_where_it_may(dtype, d, dv, t, align, vec):
    """16-byte copies, gathers and stores only on 16-byte aligned pointers
    (the residue of their OR), rows of whole 16-byte chunks and elements
    of exactly the register slot's values; else the element's words."""
    plan = ptiling.plan_bmmc(PBmmc.bit_reverse(10), t)[0]
    geometry = pk.plan_geometry(plan)
    itemsize = np.dtype(dtype).itemsize
    for fn in (pk.k4b_schedule, pk.k5_schedule):
        s = fn(geometry, 2, d, itemsize, align, n_words=64, n_epi=2, dv=dv)
        assert s.vec == vec and s.word_bytes == itemsize and s.wpe == d


def test_schedules_raise_where_a_block_cannot_fit():
    """A block whose tables, plan, tiles and K5's compare bits and map
    inputs exceed 227 KB raises; one asked for two items in flight that
    fits with one drops the second."""
    plan = ptiling.plan_bmmc(PBmmc.bit_reverse(20), 6)[0]
    geometry = pk.plan_geometry(plan)
    s = pk.k5_schedule(geometry, 1, 1, 4, n_words=500, n_epi=12,
                       n_spill=8, n_buf=2)
    assert s.n_buf == 2
    s = pk.k5_schedule(geometry, 1, 1, 4, n_words=500, n_epi=12,
                       n_spill=20, n_buf=2)
    assert s.n_buf == 1 and s.smem <= _SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        pk.k5_schedule(geometry, 1, 1, 4, n_words=500, n_epi=12,
                       n_spill=32)
    with pytest.raises(ValueError, match="shared memory"):
        pk.k4b_schedule(geometry, 1, 1, 4, n_words=60000, n_epi=12)


def test_bank_model_counts_the_padded_tile():
    """The plan's bank model (``_wavefronts``) under the schedule's tile
    layout equals a brute-force count of the distinct 4-byte words each
    bank serves in one warp-wide register load, over the tile as the
    copies fill it: for every phase of the clusters and random lanes."""
    rng = np.random.default_rng(5)
    for label, geometry, ents, dtype in _CLUSTERS:
        n, t, rpt = geometry[:3]
        dv = 2 if any(e[0] == 1 for e in ents) else 1
        for dt, d in ((dtype, dv), (torch.bfloat16, 1)):
            if dv == 2 and dt == torch.bfloat16:
                continue
            xc = torch.zeros((1, 1 << n, d), dtype=dt)
            _, s, plan, _ = pk._epi_launch_args(xc, geometry, ents)
            a = pk._epi_args(s, pk.device_tables(
                ptiling.plan_bmmc(PBmmc.bit_reverse(n), t)[0],
                torch.device("cpu")), plan, geometry, 1, dt, d, dv)
            rows = s.per_cta * rpt
            _, place = _load(a, np.zeros(rows * (1 << t) * d * 4 + 64,
                                         np.uint16), np.arange(rows), rows)
            size = xc.element_size()
            access = size * dv
            B = t + (rows.bit_length() - 1)
            words = plan.numpy()
            lane_sets = [tuple(int(v) for v in EP.phase_slice(words, p)[
                EP.PH_IMG_THR:EP.PH_IMG_THR + 5])
                for p in range(plan.info["n_phases"])]
            lane_sets += [tuple(int(v) for v in rng.integers(0, 1 << B, 5))
                          for _ in range(20)]
            for lanes in lane_sets:
                q = np.zeros(32, np.int64)
                for k, im in enumerate(lanes):
                    q ^= np.where((np.arange(32) >> k) & 1, im, 0)
                elem = (q >> t) * (1 << t) * d + (q & ((1 << t) - 1)) * d
                byte0 = place[elem] * size
                w4 = np.unique((byte0[:, None] + np.arange(access)) // 4)
                brute = int(np.bincount(w4 % 32).max())
                model = EP._wavefronts(lanes, t, s.stride * size, d * size,
                                       access)
                assert model == brute, (label, dt, lanes)


def _parity(v):
    v = np.asarray(v, np.int64)
    out = np.zeros_like(v)
    while v.any():
        out ^= v & 1
        v = v >> 1
    return out


@pytest.mark.parametrize("batch,groups", [(1, 3), (3, 2), (3, 5)])
def test_item_bases_give_every_position_its_hi_and_twiddle(batch, groups):
    """A block of several work items stages each item's hi_base and
    tw_base entries at the item's first tile (stage_items); with them the
    plan's masks give every position of every item the hi bit and
    twiddle index the tables give, as a block of one item does."""
    for label, geometry, ents, _ in _CLUSTERS:
        n, t, rpt = geometry[:3]
        dv = 2 if any(e[0] == 1 for e in ents) else 1
        xc = torch.zeros((batch, 1 << n, dv), dtype=torch.float32)
        _, s, plan, _ = pk._epi_launch_args(xc, geometry, ents)
        s = pk.k4b_schedule(geometry, batch, dv, 4, n_words=plan.numel(),
                            n_epi=len(ents), dv=dv, groups=groups)
        one = pk.k4b_schedule(geometry, batch, dv, 4, n_words=plan.numel(),
                              n_epi=len(ents), dv=dv, groups=1)
        info = plan.info
        rows = s.per_cta * rpt
        q = np.arange(rows << t)
        r, c, j = (q >> t) & (rpt - 1), q & ((1 << t) - 1), q // (rpt << t)

        def bases(sched):
            got = {}
            for items in _blocks(sched):
                for b, grp in items:
                    got[b, grp] = [
                        (int(np.asarray(e[5])[grp * sched.per_cta]),
                         int(np.asarray(e[8])[grp * sched.per_cta])
                         if e[0] == 1 else 0) for e in ents]
            return got
        many, single = bases(s), bases(one)
        assert many == single and len(many) == batch * s.n_groups
        for (b, grp), eb in many.items():
            g = grp * s.per_cta + j
            for e, (hb, tb), hmask, twp in zip(ents, eb, info["hmask"],
                                               info["tw_pos"]):
                hi = _parity(q & hmask) ^ hb
                want = (np.asarray(e[3])[r] ^ np.asarray(e[4])[c]
                        ^ np.asarray(e[5])[g])
                assert np.array_equal(hi, want), (label, b, grp)
                if e[0] == 1:
                    lin = np.zeros_like(q)
                    for k, im in enumerate(twp):
                        lin ^= np.where((q >> k) & 1 == 1, im, 0)
                    want = (np.asarray(e[6])[r] ^ np.asarray(e[7])[c]
                            ^ np.asarray(e[8])[g])
                    assert np.array_equal(lin ^ tb, want), (label, b, grp)


@functools.lru_cache(maxsize=None)
def _guard_cluster(name):
    """(port plan, port entries, reference cluster, t) of the largest
    cluster of the 2^10 sort or FFT, and the same cluster of the
    reference's clustered program."""
    expr, rexpr = {"sort": (sort_expr, rcomb.sort_expr),
                   "fft": (fft_expr, rcomb.fft_expr)}[name]
    n, t = 10, 4
    prog = compile_expr(expr(n)).clustered_program(n, t)
    rprog = rcomb.compile_expr(rexpr(n)).clustered_program(n, t)
    i = max((k for k, s in enumerate(prog)
             if isinstance(s, FusedStage) and s.computes),
            key=lambda k: len(prog[k].computes))
    assert len(rprog[i].computes) == len(prog[i].computes)
    plans, entries = pex._fused_plan_cached(prog[i], t)
    return plans[0], entries, rprog[i], t


def _reference_oob(rfs, t, table, index, value):
    """The reference's OOB bit (``TRAP_KINDS["oob"]`` of its guarded
    executable's probe) for its cluster ``rfs`` with entry ``index`` of
    its first pass's ``table`` set to ``value``."""
    plan = rex._fused_plan_cached(rfs, t)[0][0]
    tab = getattr(plan, table).reshape(-1) if table else None
    orig = None if tab is None else int(tab[index])
    x = jnp.zeros(1 << plan.n, jnp.int32)
    try:
        if tab is not None:
            tab[index] = value
        flags = int(rrt._build_probe((rfs,), t, "pallas", False)(x, x))
    finally:
        if tab is not None:
            tab[index] = orig
    return flags & rrt.TRAP_KINDS["oob"]


_TABLES = ("in_rows", "out_rows", "xor_low", "src0")


@pytest.mark.parametrize("table,value", [(None, 0)] + [
    (k, v) for k in _TABLES for v in (-1, 1 << 30)])
@pytest.mark.parametrize("path", ["16-byte", "word"])
@pytest.mark.parametrize("cluster", ["sort int32", "sort float32",
                                     "sort bfloat16", "fft float32"])
def test_guarded_k4b_tests_where_it_stages_and_gathers(cluster, path, table,
                                                       value):
    """The guarded K4b's schedule (row ids and lane XORs tested as they are
    staged, rows not read loaded as zeros, src0 entries tested per lane in
    the 16-byte and the word gather) on a cluster of the 2^10 sort or FFT,
    its epilogues run between load and gather as the plain version runs
    them, with one entry of one table set to -1 or 2^30: bit 1 and every
    written word equal ``_tile_fused_plain(flags=)``'s, exactly the output
    row a bad output id names is left unwritten, and the bit equals the
    reference's OOB flag for the same poisoned table."""
    name, dt = cluster.split()
    plan, entries, rfs, t = _guard_cluster(name)
    dtype = {"int32": torch.int32, "float32": torch.float32,
             "bfloat16": torch.bfloat16}[dt]
    sig, scal, vmem, fns = pex._fused_kernel_args(entries, dtype)
    ents = pk._epi_entries(sig, scal, vmem, fns, dtype)
    geometry = pk.plan_geometry(plan)
    n, _, rpt = geometry[:3]
    dv = 2 if any(e[0] == 1 for e in ents) else 1
    batch = 3
    size = torch.tensor([], dtype=dtype).element_size()
    iv = {2: (torch.int16, np.uint16), 4: (torch.int32, np.uint32)}[size]
    arr = _payload((batch, 1 << n, dv), {2: ml_dtypes.bfloat16,
                                         4: np.float32}[size], n + dv)
    sint = np.int16 if size == 2 else np.int32
    xc = torch.from_numpy(np.ascontiguousarray(arr).view(sint)).view(dtype)
    tabs = [np.array(getattr(plan, k), copy=True) for k in _TABLES]
    index = None
    if table is not None:
        flat = tabs[_TABLES.index(table)].reshape(-1)
        index = int(np.random.default_rng(_TABLES.index(table)).integers(
            flat.size))
        flat[index] = value
    pflags = torch.zeros(1, dtype=torch.int32)
    want = pk._tile_fused_plain(xc, *tabs, geometry, ents, pflags)
    want = want.view(iv[0]).numpy().view(iv[1]).reshape(batch, -1)

    plain_ents = pk._plain_entries(ents, torch.device("cpu"))

    def phases(a):
        rows = a.per_cta * rpt
        row_words = (1 << a.t) * a.wpe
        at = (np.arange(rows)[:, None] * a.stride
              + np.arange(row_words)).ravel()

        def run(tile, b, grp):
            v = torch.from_numpy(tile[at].view(sint)).view(dtype).reshape(
                1, a.per_cta, rpt, 1 << a.t, dv)
            gs = slice(grp * a.per_cta, (grp + 1) * a.per_cta)
            for e in plain_ents:
                v = pk._apply_epilogue(v, e, pk._tiles_of(e[5], gs),
                                       pk._tiles_of(e[8], gs))
            tile = tile.copy()
            tile[at] = v.contiguous().view(iv[0]).numpy().view(
                iv[1]).ravel()
            return tile
        return run

    align = 0 if path == "16-byte" else size
    s = pk.k4b_schedule(geometry, batch, dv, size, align, n_words=100,
                        n_epi=len(ents), dv=dv)
    assert s.vec == (path == "16-byte")
    plan_t = torch.zeros(100, dtype=torch.int64)
    plan_t.info = {"hmask": [0] * len(ents), "reg_bits": 3, "maps": 0}
    a = pk._epi_args(s, [torch.from_numpy(v.astype(np.int32)) for v in tabs],
                     plan_t, geometry, batch, dtype, dv, dv)
    got, written, bit = emulate_k4b(a, _words(arr, size, batch), tabs,
                                    guard=True, phases=phases(a))
    assert bit == int(pflags) == (table is not None)
    assert np.array_equal(got[written], want[written])
    row_len = 1 << geometry[1]
    unwritten = np.zeros(1 << n, bool)
    if table == "out_rows":
        r0 = int(np.asarray(plan.out_rows).reshape(-1)[index])
        unwritten[r0 * row_len:(r0 + 1) * row_len] = True
    assert np.array_equal(~written, np.broadcast_to(
        np.repeat(unwritten, dv), written.shape))
    assert _reference_oob(rfs, t, table, index, value) == bit
