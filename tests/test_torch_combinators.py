"""The combinator planner of the PyTorch port held against the JAX
reference, stage for stage: the IR and vocabulary, ``lower``, ``fuse``,
``cluster``, ``fold_free``, ``inverse_program`` and ``program_cost``.

Everything here is offline planning (no arrays), so the comparison is
exact: the two packages must build equal programs from equal
expressions at equal ``(n, t)``. Programs are compared through
:func:`_key`, which spells a node of either package as plain tuples
(BMMCs as their rows and complement).
"""
import random

import pytest

import repro.combinators as rc
from repro.combinators import vocab as RV
from repro.combinators.fft import fft_expr as r_fft_expr
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core.bmmc import Bmmc as RBmmc
import repro_torch.combinators as pc
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.fft import fft_expr as p_fft_expr
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.guard.errors import BadStage


def _key(e):
    """A node of either package as nested tuples."""
    name = type(e).__name__
    if name == "Perm":
        return ("Perm", tuple(e.bmmc.rows), e.bmmc.c)
    if name == "Bfly":
        return ("Bfly", e.twiddles)
    if name == "Map":
        return ("Map", e.name)
    if name in ("CmpHalves", "Id"):
        return (name,)
    if name == "Seq":
        return ("Seq", tuple(_key(f) for f in e.fs))
    if name in ("Two", "Ilv"):
        return (name, _key(e.f))
    if name == "ParmE":
        return ("ParmE", e.mask, _key(e.f))
    if name == "FusedStage":
        return ("FusedStage", tuple(_key(s) for s in e.stages),
                tuple(e.bmmc.rows), e.bmmc.c,
                tuple((_key(c), tuple(p.rows), p.c) for c, p in e.computes))
    raise TypeError(name)


def _prog(p):
    return tuple(_key(s) for s in p)


def _double(x):
    return x * 2


def _vocab_mix(V, Bmmc):
    """One expression over most of the vocabulary, built the same way in
    either package (random BMMCs from one seed)."""
    rng = random.Random(5)
    n = 8
    return V.seq(
        V.riffle(n), V.bit_reverse(n), V.rev(n), V.transpose(3, 5),
        V.stride_permute(n, 3), V.xor_shift(n, 0x55),
        V.perm(Bmmc.random_bpc(n, rng)), V.cmp_halves(),
        V.parm(0b101, V.two(V.cmp_halves())),
        V.ilv(V.perm(Bmmc.random(n - 1, rng))),
        V.emap("x2", _double), V.interleave(n), V.evens_odds(n),
        V.rotate_bits(n, 3), V.perm(Bmmc.random(n, rng)), V.identity(),
        V.bfly([complex(k, -k) for k in range(1 << (n - 1))]),
        V.unriffle(n))


EXPRS = {
    "sort6": (lambda: r_sort_expr(6), lambda: p_sort_expr(6), 6),
    "sort12": (lambda: r_sort_expr(12), lambda: p_sort_expr(12), 12),
    "fft7": (lambda: r_fft_expr(7), lambda: p_fft_expr(7), 7),
    "fft12": (lambda: r_fft_expr(12), lambda: p_fft_expr(12), 12),
    "vocab": (lambda: _vocab_mix(RV, RBmmc), lambda: _vocab_mix(PV, PBmmc),
              8),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expressions_lower_and_fuse_alike(name):
    rmake, pmake, n = EXPRS[name]
    re_, pe = rmake(), pmake()
    assert _key(re_) == _key(pe)
    assert re_.size_bits() == pe.size_bits()
    assert _prog(rc.lower(re_, n)) == _prog(pc.lower(pe, n))
    assert _prog(rc.optimize(re_, n)) == _prog(pc.optimize(pe, n))
    assert _prog(rc.fuse(rc.lower(re_, n))) == _prog(pc.fuse(pc.lower(pe, n)))


@pytest.mark.parametrize("name,t", [("sort6", 3), ("sort12", 6),
                                    ("sort12", 5), ("fft7", 3),
                                    ("fft12", 6), ("fft12", 5),
                                    ("vocab", 4)])
def test_cluster_and_fold_free_alike(name, t):
    rmake, pmake, n = EXPRS[name]
    rp, pp = rc.optimize(rmake(), n), pc.optimize(pmake(), n)
    rcl, pcl = rc.cluster(rp, n, t), pc.cluster(pp, n, t)
    assert _prog(rcl) == _prog(pcl)
    rff, pff = rc.fold_free(rcl, n, t), pc.fold_free(pcl, n, t)
    assert _prog(rff) == _prog(pff)
    assert _prog(pc.expand_clusters(pff)) == _prog(rc.expand_clusters(rff))
    assert pc.is_perm_program(pff) == rc.is_perm_program(rff)
    assert pc.num_perm_stages(pff) == rc.num_perm_stages(rff)
    # the compiled expression resolves to the same clustered program
    assert _prog(pc.compile_expr(pmake()).clustered_program(n, t)) == \
        _prog(rff)


@pytest.mark.parametrize("seed", range(3))
def test_inverse_program_alike(seed):
    rng_r, rng_p = random.Random(seed), random.Random(seed)
    n, t = 8, 3
    rparts = [RV.perm(RBmmc.random(n, rng_r)) for _ in range(4)]
    pparts = [PV.perm(PBmmc.random(n, rng_p)) for _ in range(4)]
    rparts.insert(1, RV.xor_shift(n, 0x30))
    pparts.insert(1, PV.xor_shift(n, 0x30))
    for cl in (False, True):
        rp = rc.optimize(RV.seq(*rparts), n)
        pp = pc.optimize(PV.seq(*pparts), n)
        if cl:
            rp = rc.fold_free(rc.cluster(rp, n, t), n, t)
            pp = pc.fold_free(pc.cluster(pp, n, t), n, t)
        assert _prog(pc.inverse_program(pp)) == _prog(rc.inverse_program(rp))
        for s_r, s_p in zip(rp, pp):
            assert _key(pc.inverse_stage(s_p)) == _key(rc.inverse_stage(s_r))
    with pytest.raises(BadStage):
        pc.inverse_program(pc.lower(p_sort_expr(3), 3))


@pytest.mark.parametrize("name,n,t,want", [
    ("sort", 12, 6, {"round_trips": 23, "kernels": {
        "fused": 12, "general": 4, "sweep": 6, "tiled": 1}}),
    ("fft", 12, 6, {"round_trips": 1}),
    ("sort", 8, 4, None), ("fft", 10, 5, None)])
def test_program_cost_alike(name, n, t, want):
    rexpr = {"sort": r_sort_expr, "fft": r_fft_expr}[name](n)
    pexpr = {"sort": p_sort_expr, "fft": p_fft_expr}[name](n)
    rf = rc.compile_expr(rexpr, engine="pallas")
    pf = pc.compile_expr(pexpr, engine="cuda")
    for clustered in (False, True):
        for itemsize in (4, 8):
            got = pf.cost(n, t, itemsize, clustered=clustered)
            assert got == rf.cost(n, t, itemsize, clustered=clustered)
    cost = pc.program_cost(pf.clustered_program(n, t), t)
    for k, v in (want or {}).items():
        assert cost[k] == v, (k, cost[k])


def test_expression_hash_is_kept():
    e = p_fft_expr(9)
    h = hash(e)
    assert e.__dict__.get("_hash") == h == hash(p_fft_expr(9))
    assert PV.emap("f", abs) == PV.emap("f", len)  # Map compares by name


def test_butterflies_of_two_lowerings_compare_through_a_kept_digest():
    """Two lowerings of one FFT hold equal butterfly stages in distinct
    nodes: they compare equal and hash alike, through a twiddle digest
    each node computes once and keeps; different twiddles do not."""
    n = 9
    from repro_torch.combinators.optimize import lower
    one, two = (lower(p_fft_expr(n), n) for _ in range(2))
    pairs = [(a, b) for a, b in zip(one, two)
             if type(a).__name__ == "Bfly" and a is not b]
    assert len(pairs) == n - 1      # all but the last stage are lifted
    for a, b in pairs:
        assert a.twiddles is not b.twiddles
        assert a == b and hash(a) == hash(b) and {a: 1}[b] == 1
        assert {"_twiddle_digest"} <= a.__dict__.keys() & b.__dict__.keys()
    a = pairs[-1][0]
    assert a != type(a)(a.twiddles[:-1] + (0j,))
    assert a != pairs[0][0]


def test_guard_ring1_validates_resolved_programs():
    """With the guard on, ``CompiledExpr`` proves its resolved program
    before running it (``validate_program_fast``); the audit counts the
    same stages as the reference's."""
    import numpy as np
    import torch
    from repro.guard import validate as rvalidate
    from repro_torch import guard as pguard
    from repro_torch.guard import validate as pvalidate
    n, t = 8, 4
    rp = rc.compile_expr(r_sort_expr(n), engine="pallas").clustered_program(
        n, t)
    pp = pc.compile_expr(p_sort_expr(n)).clustered_program(n, t)
    audited = pvalidate.validate_program(pp, t)
    assert audited == rvalidate.validate_program(rp, t)
    assert audited == sum(isinstance(s, (pc.Perm, pc.FusedStage))
                          for s in pp)
    x = np.random.default_rng(1).integers(-9, 9, 1 << n).astype(np.int32)
    before = pvalidate._VALIDATED_FAST.cache_info()
    with pguard.guarded():
        got = pc.compile_expr(p_sort_expr(n))(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.sort(x))
    assert pvalidate._VALIDATED_FAST.cache_info()[1] == before[1] + 1
    assert not pguard.enabled()


def test_cache_stats_cover_the_combinator_caches():
    from repro_torch import obs as pobs
    pc.compile_expr(p_fft_expr(5)).cost(5, 2, clustered=True)
    stats = pc.cache_stats()
    for name in ("program", "fused_plan", "w_planar", "lowered",
                 "clustered", "model_round_trips", "plans", "class_plan",
                 "device_tables", "compiled_exprs", "guard_validate"):
        assert name in stats, name
    assert stats["clustered"].currsize >= 1
    assert pobs.cache_stats()["lowered"]["currsize"] >= 1
    assert "caches" in pobs.snapshot() and "-- caches --" in pobs.report()
    pc.clear_caches()
    assert pc.cache_stats()["clustered"].currsize == 0
