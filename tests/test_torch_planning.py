"""Offline planning of the PyTorch port held against the JAX reference.

``repro_torch.core`` (f2, bmmc, tiling), its ring-1 audits and the
transaction model of ``repro_torch.kernels.ops`` must agree with
``repro`` exactly: the same random draws from the same seeds, the same
classes, and bitwise-equal plan tables at the same pinned tile ``t``
(the port's vectorised table builders against the reference's row
loops). Tolerance: none — everything here is integers.
"""
import dataclasses
import random

import numpy as np
import pytest

from repro.core import bmmc as rbmmc
from repro.core import f2 as rf2
from repro.core import tiling as rtiling
from repro.kernels import ops as rops
from repro_torch.core import bmmc as pbmmc
from repro_torch.core import f2 as pf2
from repro_torch.core import tiling as ptiling
from repro_torch.guard import DescriptorOOB, NotInvertible, validate
from repro_torch.kernels import ops as pops

_TILE_FIELDS = ("in_rows", "out_rows", "xor_low", "src0")
_SCALAR_FIELDS = ("t", "row_cols", "n_over", "tb_positions", "in_run",
                  "out_run", "row_dirs")


def _port(b):
    return pbmmc.Bmmc(b.rows, b.c)


def _assert_tile_plan_equal(want, got, ctx):
    assert (want is None) == (got is None), ctx
    if want is None:
        return
    for f in _TILE_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        assert np.array_equal(a, b), (ctx, f)
    for f in _SCALAR_FIELDS:
        assert getattr(want, f) == getattr(got, f), (ctx, f)
    assert got.bmmc.rows == want.bmmc.rows and got.bmmc.c == want.bmmc.c


def _samples(n, rng):
    ident = tuple(1 << i for i in range(n))
    sub = rbmmc.Bmmc.random(n - n // 2, rng)
    block = rbmmc.Bmmc(ident[:n // 2] + tuple(r << (n // 2) for r in sub.rows),
                       sub.c << (n // 2))
    sub = rbmmc.Bmmc.random(2, rng)
    lane = rbmmc.Bmmc(tuple(sub.rows) + ident[2:], sub.c)
    return {"bitrev": rbmmc.Bmmc.bit_reverse(n),
            "transpose": rbmmc.Bmmc.matrix_transpose(n // 2, n - n // 2),
            "reverse": rbmmc.Bmmc.reverse_array(n),
            "mixed": rbmmc.Bmmc.xor_shift(n, 1 | (1 << (n - 1))),
            "bpc": rbmmc.Bmmc.random_bpc(n, rng),
            "bmmc": rbmmc.Bmmc.random(n, rng),
            "block": block, "lane": lane}


# ---------------------------------------------------------------------------
# f2 and Bmmc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(2, 17))
def test_f2_agrees_with_reference(n):
    r_rng, p_rng = random.Random(n), random.Random(n)
    for _ in range(6):
        a = rf2.random_invertible(n, r_rng)
        assert pf2.random_invertible(n, p_rng) == a
        assert pf2.random_perm_matrix(n, p_rng) == rf2.random_perm_matrix(
            n, r_rng)
        sing = a[:-1] + (a[0],)
        assert pf2.rank(a) == rf2.rank(a) == n
        assert pf2.rank(sing) == rf2.rank(sing)
        assert pf2.inverse(a) == rf2.inverse(a)
        assert pf2.lup(a) == rf2.lup(a)
        assert pf2.ulp(a) == rf2.ulp(a)
        assert pf2.transpose(a) == rf2.transpose(a)
        assert pf2.matmul(a, sing) == rf2.matmul(a, sing)
        assert pf2.nullspace(a[n // 2:], n) == rf2.nullspace(a[n // 2:], n)
        for t in range(1, n + 1):
            assert pf2.tiled_columns(a, t) == rf2.tiled_columns(a, t)
        with pytest.raises(pf2.SingularError):
            pf2.inverse(sing)


@pytest.mark.parametrize("n", [2, 3, 5, 8, 12, 16])
def test_bmmc_classes_agree_with_reference(n):
    r_rng, p_rng = random.Random(7 * n), random.Random(7 * n)
    for _ in range(8):
        for draw in ("random", "random_bpc"):
            rb = getattr(rbmmc.Bmmc, draw)(n, r_rng)
            pb = getattr(pbmmc.Bmmc, draw)(n, p_rng)
            assert (pb.rows, pb.c) == (rb.rows, rb.c)
            inv = pb.inverse()
            assert (inv.rows, inv.c) == (rb.inverse().rows, rb.inverse().c)
            comp = pb.compose(inv)
            assert comp.is_identity_perm()
            assert pb.block_bits() == rb.block_bits()
            for t in range(1, n + 1):
                assert pb.bmmc_class(t) == rb.bmmc_class(t)
                assert pb.is_lane_local(t) == rb.is_lane_local(t)
                fp = pb.factor_tiled(t)
                fr = rb.factor_tiled(t)
                assert [(f.rows, f.c) for f in fp] == [(f.rows, f.c) for f in fr]
            for i in range(0, 1 << n, max(1, (1 << n) // 64)):
                assert pb.apply(i) == rb.apply(i)
            assert pb.verify() is pb


# ---------------------------------------------------------------------------
# plan tables at pinned t
# ---------------------------------------------------------------------------

_TABLE_CASES = ([(n, kind) for n in (8, 12)
                 for kind in ("bitrev", "transpose", "reverse", "mixed",
                              "bpc", "bmmc", "block", "lane")]
                + [(16, kind) for kind in ("bitrev", "bpc", "bmmc", "block")]
                + [(20, kind) for kind in ("bpc", "bmmc")])


@pytest.mark.parametrize("n,kind", _TABLE_CASES)
def test_plan_tables_equal_reference(n, kind):
    b = _samples(n, random.Random(n))[kind]
    pb = _port(b)
    ts = sorted({2, n // 2} if n < 20 else {5})
    for t in ts:
        ctx = (n, kind, t)
        _assert_tile_plan_equal(rtiling.plan_tiled(b, t),
                                ptiling.plan_tiled(pb, t), ctx + ("tiled",))
        _assert_tile_plan_equal(rtiling.plan_general(b, t),
                                ptiling.plan_general(pb, t),
                                ctx + ("general",))
        want, got = rtiling.plan_bmmc(b, t), ptiling.plan_bmmc(pb, t)
        assert len(want) == len(got), ctx
        for w, g in zip(want, got):
            _assert_tile_plan_equal(w, g, ctx + ("bmmc",))
            g.audit()
        rbp, pbp = rtiling.plan_block(b, t), ptiling.plan_block(pb, t)
        assert (rbp is None) == (pbp is None), ctx
        if rbp is not None:
            assert pbp.b == rbp.b
            assert pbp.src_rows.dtype == rbp.src_rows.dtype
            assert np.array_equal(pbp.src_rows, rbp.src_rows), ctx
            pbp.audit()
        rlp, plp = rtiling.plan_lane(b, t), ptiling.plan_lane(pb, t)
        assert (rlp is None) == (plp is None), ctx
        if rlp is not None:
            assert plp.rows_per_block == rlp.rows_per_block
            assert plp.src_lane.dtype == rlp.src_lane.dtype
            assert np.array_equal(plp.src_lane, rlp.src_lane), ctx
            plp.audit()
        assert ptiling.dispatch_kernel(pb, t) == rtiling.dispatch_kernel(b, t)
        assert ptiling.class_stats(pb, t) == rtiling.class_stats(b, t)
        assert ptiling.pass_spans(pb, t) == rtiling.pass_spans(b, t)
        for fn in ("plan_stats", "plan_stats_general"):
            w, g = getattr(rtiling, fn)(b, t), getattr(ptiling, fn)(pb, t)
            assert (w is None) == (g is None), ctx + (fn,)
            if w is not None:
                assert dataclasses.asdict(w) == dataclasses.asdict(g), ctx
        assert pops.modeled_transactions(pb, t) == rops.modeled_transactions(
            b, t)


@pytest.mark.parametrize("n,t", [(6, 4), (8, 5), (9, 6), (12, 7)])
def test_two_pass_factor_tables_equal_reference(n, t):
    """The §5.2 two-pass planning (``factor_tiled`` then a plan per
    factor) at t > n/2. ``plan_bmmc`` itself never needs it: the pure-low
    kernel directions number a >= 2t - n, so the one-pass general plan
    always fits (n - 2t + a >= 0) and both packages plan one pass."""
    rng = random.Random(100 + n)
    seen = 0
    for _ in range(200):
        b = rbmmc.Bmmc.random(n, rng)
        if b.is_tiled(t):
            continue
        pb = _port(b)
        factors = pb.factor_tiled(t)
        assert [(f.rows, f.c) for f in factors] == [
            (f.rows, f.c) for f in b.factor_tiled(t)]
        assert len(factors) == 2
        for rf, pf in zip(b.factor_tiled(t), factors):
            want = rtiling.plan_tiled(rf, t) or rtiling.plan_general(rf, t)
            got = ptiling.plan_tiled(pf, t) or ptiling.plan_general(pf, t)
            _assert_tile_plan_equal(want, got, (n, t))
            got.audit()
        assert len(ptiling.plan_bmmc(pb, t)) == len(
            rtiling.plan_bmmc(b, t)) == 1
        assert ptiling.dispatch_kernel(pb, t) == rtiling.dispatch_kernel(
            b, t) == "general"
        seen += 1
        if seen == 3:
            break
    assert seen == 3, "too few non-tiled BMMCs drawn"


def test_plan_from_arrays_rebuilds_the_reference_plan():
    b = rbmmc.Bmmc.random(10, random.Random(5))
    want = rtiling.plan_bmmc(b, 3)[0]
    got = ptiling.plan_from_arrays(
        want.bmmc.rows, want.bmmc.c, want.t, want.in_rows, want.out_rows,
        want.xor_low, want.src0, want.in_run, want.out_run,
        row_cols=want.row_cols, n_over=want.n_over,
        tb_positions=want.tb_positions, row_dirs=want.row_dirs)
    _assert_tile_plan_equal(want, got, "from_arrays")
    _assert_tile_plan_equal(want, ptiling.plan_bmmc(_port(b), 3)[0], "plan")
    rb = rtiling.plan_block(rbmmc.Bmmc.xor_shift(10, 1 << 9), 3)
    pbk = ptiling.block_plan_from_arrays(rb.bmmc.rows, rb.bmmc.c, rb.b,
                                         rb.src_rows)
    assert pbk.n_rows == rb.n_rows and pbk.audit() is pbk
    rl = rtiling.plan_lane(rbmmc.Bmmc.xor_shift(10, 5), 3)
    pl = ptiling.lane_plan_from_arrays(rl.bmmc.rows, rl.bmmc.c, rl.t,
                                       rl.src_lane, rl.rows_per_block)
    assert pl.dma_descriptors() == rl.dma_descriptors() and pl.audit() is pl


@pytest.mark.parametrize("kind", ["bitrev", "bpc", "bmmc"])
def test_paper_size_plan_is_built_and_audited(kind):
    """n = 26 at the port's own t: the reference's row loops would take
    minutes; the vectorised builders take a fraction of a second, and
    the plan passes the semantic audit."""
    n = 26
    b = _port(_samples(n, random.Random(26))[kind])
    t = pops.choose_tile(n, 4)
    plans = ptiling.plan_bmmc(b, t)
    assert len(plans) == 1
    p = plans[0].audit()
    assert p.in_rows.shape == (p.n_tiles, p.rows_per_tile)
    s = ptiling.plan_stats(b, t) or ptiling.plan_stats_general(b, t)
    assert (s.n_tiles, s.rows_per_tile, s.in_run, s.out_run) == (
        p.n_tiles, p.rows_per_tile, p.in_run, p.out_run)


# ---------------------------------------------------------------------------
# ring-1 audits
# ---------------------------------------------------------------------------

def _poisoned(plan, **fields):
    return dataclasses.replace(plan, **fields)


@pytest.mark.parametrize("poison", ["swap_in_rows", "oob_out_rows",
                                    "dup_src0", "xor_low", "truncate"])
def test_tile_audit_raises_on_poisoned_table(poison):
    plan = ptiling.plan_bmmc(_port(rbmmc.Bmmc.random(10, random.Random(3))),
                             3)[0].audit()
    if poison == "swap_in_rows":
        tab = plan.in_rows.copy()
        tab[0, [0, 1]] = tab[0, [1, 0]]
        bad = _poisoned(plan, in_rows=tab)
    elif poison == "oob_out_rows":
        tab = plan.out_rows.copy()
        tab[1, 0] = 1 << 7
        bad = _poisoned(plan, out_rows=tab)
    elif poison == "dup_src0":
        tab = plan.src0.copy()
        tab[0, 0] = tab[0, 1]
        bad = _poisoned(plan, src0=tab)
    elif poison == "xor_low":
        tab = plan.xor_low.copy()
        tab[2] ^= 1
        bad = _poisoned(plan, xor_low=tab)
    else:
        bad = _poisoned(plan, xor_low=plan.xor_low[:-1])
    with pytest.raises(DescriptorOOB):
        bad.audit()


def test_block_lane_audits_and_rank_check_raise():
    bp = ptiling.plan_block(_port(rbmmc.Bmmc.xor_shift(10, 3 << 8)), 3)
    tab = bp.src_rows.copy()
    tab[[0, 1]] = tab[[1, 0]]
    with pytest.raises(DescriptorOOB):
        _poisoned(bp, src_rows=tab).audit()
    lp = ptiling.plan_lane(_port(rbmmc.Bmmc.xor_shift(10, 5)), 3)
    tab = lp.src_lane.copy()
    tab[[0, 1]] = tab[[1, 0]]
    with pytest.raises(DescriptorOOB):
        _poisoned(lp, src_lane=tab).audit()
    with pytest.raises(DescriptorOOB):
        _poisoned(lp, src_lane=lp.src_lane + 8).audit()
    sing = pbmmc.Bmmc.__new__(pbmmc.Bmmc)
    object.__setattr__(sing, "rows", (1, 1, 4))
    object.__setattr__(sing, "c", 0)
    with pytest.raises(NotInvertible):
        validate.verify_bmmc(sing)
