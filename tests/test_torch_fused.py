"""The fused compute epilogues of the PyTorch port (K4b) held against the
JAX reference on the CPU.

* ``compute_tables`` (the per-row / per-lane / per-tile parity and
  twiddle tables of every fused compute) are bitwise equal to the
  reference's, cluster for cluster, at equal ``(n, t)``.
* The plain PyTorch version of K4b — what a CPU tensor runs, and what the
  CUDA kernel is held against on the card — equals the reference's
  ``tiled_permute_tables`` with epilogues in Pallas interpret mode:
  compare-exchange clusters bit for bit over int32, float32 and bfloat16
  with tails, batches, canonical NaNs and signed zeros (the port orders
  -0 below +0 and keeps NaN, as ``jnp.maximum``/``jnp.minimum`` do on the
  CPU; the one exception is the bit pattern of a bfloat16 NaN, which XLA
  rewrites inside the interpret-mode kernel); butterfly clusters within
  2e-6 absolute on unit-normal data (XLA may contract ``a*b - c*d`` into a fused multiply-add, the port
  rounds each product and sum on its own, so the two differ by a few
  float32 ulps).
* A cluster that holds a ``Map`` runs as one K4b pass when the map's
  function lowers to a tape, and stage by stage (counted as a fused
  fallback) when it does not; both match the reference bit for bit.
* The combinator entry points differentiate; the raw kernel wrappers and
  ``bmmc_permute`` refuse a tensor that requires grad.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators import vocab as RV
from repro.combinators.fft import fft_expr as r_fft_expr
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels import bmmc_permute as rk
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.fft import fft_expr as p_fft_expr
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels.ops import bmmc_permute

BF16 = np.dtype(ml_dtypes.bfloat16)


def _clusters(rexpr, pexpr, n, t):
    """The (reference, port) FusedStages with computes, in program order."""
    rp = rc.compile_expr(rexpr, engine="pallas").clustered_program(n, t)
    pp = pc.compile_expr(pexpr, engine="cuda").clustered_program(n, t)
    rf = [s for s in rp if isinstance(s, rc.FusedStage) and s.computes]
    pf = [s for s in pp if isinstance(s, pc.FusedStage) and s.computes]
    assert len(rf) == len(pf) > 0
    return list(zip(rf, pf))


@pytest.mark.parametrize("name,n,t", [("sort", 8, 4), ("sort", 12, 6),
                                      ("fft", 10, 5), ("fft", 12, 6)])
def test_compute_tables_bitwise_equal(name, n, t):
    make = {"sort": (r_sort_expr, p_sort_expr),
            "fft": (r_fft_expr, p_fft_expr)}[name]
    for rfs, pfs in _clusters(make[0](n), make[1](n), n, t):
        rplans, rents = rex._fused_plan_cached(rfs, t)
        pplans, pents = pex._fused_plan_cached(pfs, t)
        assert len(rplans) == len(pplans)
        for rpl, ppl in zip(rplans, pplans):
            for f in ("in_rows", "out_rows", "xor_low", "src0"):
                assert np.array_equal(getattr(rpl, f), getattr(ppl, f)), f
        assert [e[0] for e in rents] == [e[0] for e in pents]
        for re_, pe in zip(rents, pents):
            rct, pct = re_[2], pe[2]
            assert (rct.kind, rct.vr, rct.vc) == (pct.kind, pct.vr, pct.vc)
            for f in ("hi_row", "hi_lane", "hi_base", "tw_row", "tw_lane",
                      "tw_base"):
                a, b = getattr(rct, f), getattr(pct, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    assert a.dtype == b.dtype == np.int32, f
                    assert np.array_equal(a, b), f
        # the kernel arguments, twiddle-value tables included
        rsig, rscal, rvm, _ = rex._fused_kernel_args(rents, np.float32)
        psig, pscal, pvm, _ = pex._fused_kernel_args(pents, torch.float32)
        assert rsig == psig
        for rg, pg in zip(rscal + rvm, pscal + pvm):
            for a, b in zip(rg, pg):
                assert a.dtype == b.dtype
                assert np.array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


def _ties(shape, dtype, seed):
    """Small integers as ``dtype`` (many ties); float types also carry
    canonical NaNs and signed zeros."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-4, 5, size=shape)
    if np.dtype(dtype) == np.int32:
        return v.astype(np.int32)
    f = v.astype(np.float32)
    u = rng.random(shape)
    f[u < 0.06] = np.nan
    f[(u > 0.5) & (f == 0)] = -0.0
    return f.astype(dtype)


def _to_torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _run_both(rfs, pfs, t, x, batched):
    """One cluster through the reference's Pallas epilogue pass (interpret
    mode) and through the port's plain K4b, each on its own tables."""
    rplans, rents = rex._fused_plan_cached(rfs, t)
    rsig, rscal, rvm, _ = rex._fused_kernel_args(rents, x.dtype)
    rp = rplans[0]
    want = np.asarray(rk.tiled_permute_tables(
        jnp.asarray(x), rp.in_rows, rp.out_rows, rp.xor_low, rp.src0,
        geometry=rk.plan_geometry(rp), epilogue=rsig, epi_scalar=rscal,
        epi_vmem=rvm, batched=batched))
    pplans, pents = pex._fused_plan_cached(pfs, t)
    xt = _to_torch(x)
    psig, pscal, pvm, _ = pex._fused_kernel_args(pents, xt.dtype)
    pp = pplans[0]
    got = pk.tiled_permute_tables(
        xt, pp.in_rows, pp.out_rows, pp.xor_low, pp.src0,
        geometry=pk.plan_geometry(pp), epilogue=psig, epi_scalar=pscal,
        epi_vmem=pvm, batched=batched)
    assert pk.launch_counts()["tile_fused"] == 0   # CPU: the plain version
    return want, _to_numpy(got)


@pytest.fixture(scope="module")
def sort_clusters():
    """Sort clusters at 2^8, t = 4, by their number of epilogues."""
    by = {}
    for rfs, pfs in _clusters(r_sort_expr(8), p_sort_expr(8), 8, 4):
        by.setdefault(len(pfs.computes), (rfs, pfs))
    assert 1 in by and 3 in by
    return by


@pytest.mark.parametrize("label,epis,dtype,shape,batched", [
    ("int32", 3, np.int32, (1 << 8,), False),
    ("float32 d=3 B=2", 3, np.float32, (2, 1 << 8, 3), True),
    ("bfloat16 d=2", 3, BF16, (1 << 8, 2), False),
    ("float32", 1, np.float32, (1 << 8,), False)])
def test_cmp_epilogues_bitwise_equal_reference(sort_clusters, label, epis,
                                               dtype, shape, batched):
    rfs, pfs = sort_clusters[epis]
    x = _ties(shape, dtype, seed=len(label))
    want, got = _run_both(rfs, pfs, 4, x, batched)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == BF16:
        # inside the interpret-mode kernel XLA writes every bfloat16 NaN
        # that min/max returns as 0xFFFF (standalone jnp.maximum keeps
        # 0x7FC0, as the port does): NaN positions must agree, every
        # other element bit for bit
        nan = np.isnan(want.astype(np.float32))
        assert np.array_equal(nan, np.isnan(got.astype(np.float32)))
        got, want = got[~nan], want[~nan]
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), label


def test_bfly_epilogues_match_reference():
    (rfs, pfs), = _clusters(r_fft_expr(7), p_fft_expr(7), 7, 3)
    assert all(isinstance(c, pc.Bfly) for c, _ in pfs.computes)
    x = np.random.default_rng(3).normal(size=(1 << 7, 2)).astype(np.float32)
    want, got = _run_both(rfs, pfs, 3, x, False)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_cmp_max_min_orders_signed_zeros_and_keeps_nan():
    a = torch.tensor([-0.0, 0.0, float("nan"), 1.0, 2.0])
    b = torch.tensor([0.0, -0.0, 1.0, float("nan"), 2.0])
    for f, g in ((pk.cmp_max, jnp.maximum), (pk.cmp_min, jnp.minimum)):
        got = f(a, b).numpy()
        want = np.asarray(g(a.numpy(), b.numpy()))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert torch.equal(pk.cmp_max(torch.tensor([3]), torch.tensor([5])),
                       torch.tensor([5]))


def _map_expr(V, Bmmc, name, fn):
    import random
    rng = random.Random(9)
    n = 7
    return V.seq(V.perm(Bmmc.random_bpc(n, rng)), V.cmp_halves(),
                 V.emap(name, fn),
                 V.perm(Bmmc.random_bpc(n, rng)), V.cmp_halves(),
                 V.perm(Bmmc.random(n, rng)))


def _cast_round_trip(v):
    """The identity through a complex64 cast, in torch or jnp: the tapes
    hold no complex value, so the port does not lower it."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.complex64).real.to(v.dtype)
    return v.astype(jnp.complex64).real.astype(v.dtype)


@pytest.mark.parametrize("name,fn,lowered", [
    ("x2", lambda v: v * 2, True),
    ("fdiv3", lambda v: v // 3, True),      # floor division by a number
    # a complex cast is outside the tape's types: not lowered
    ("cast", _cast_round_trip, False)])
def test_map_cluster_falls_back_per_stage(name, fn, lowered):
    """A cluster that holds a map runs as one K4b pass when the map's
    function lowers to a tape (no fused fallback), and stage by stage,
    counted as a fused fallback, when it does not; both equal the
    reference bit for bit (on int16 keys, a type K4b took last)."""
    n = 7
    pf = pc.compile_expr(_map_expr(PV, PBmmc, name, fn), engine="cuda")
    rf = rc.compile_expr(_map_expr(RV, RBmmc, name, fn), engine="ref")
    prog = pf.clustered_program(n, 3)
    assert any(isinstance(s, pc.FusedStage)
               and any(isinstance(ss, pc.Map) for ss in s.stages)
               for s in prog)
    x = np.random.default_rng(2).integers(-1000, 1000, 1 << n).astype(
        np.int16)
    pobs.reset()
    pobs.enable()
    try:
        got = pf(torch.from_numpy(x)).numpy()
        fallbacks = pobs.counter_total("dispatch.fused_fallback")
        kernels = {dict(lab)["kernel"]: v for (nm, lab), v
                   in pobs.counters().items() if nm == "dispatch.kernel"}
    finally:
        pobs.disable()
        pobs.reset()
    if lowered:
        assert fallbacks == 0 and kernels.get("fused", 0) >= 1
    else:
        assert fallbacks >= 1
    assert np.array_equal(got, np.asarray(rf(jnp.asarray(x))))


def test_entry_points_refuse_tensors_that_require_grad():
    """The combinator entry points return gradients now; the raw kernel
    wrappers and ``bmmc_permute`` still refuse a tensor that requires
    grad, naming the reason (a kernel writes through a raw pointer, which
    autograd cannot see)."""
    n = 5
    x = torch.randn(1 << n, requires_grad=True)
    f = pc.compile_expr(PV.seq(PV.rev(n), PV.cmp_halves(), PV.riffle(n)))
    fs = next(s for s in f.clustered_program(n, 2)
              if isinstance(s, pc.FusedStage))
    with torch.no_grad():
        want = f(x)
    calls = [lambda: f(x), lambda: f.call_per_stage(x),
             lambda: pc.run_program(f.program(n), x, "cuda"),
             lambda: pc.fused_apply(x, fs, "cuda"),
             lambda: pc.program_apply(x, f.clustered_program(n, 2), 2,
                                      "cuda")]
    for call in calls:
        x.grad = None
        y = call()
        assert torch.equal(y.detach(), want)
        y.sum().backward()
        assert x.grad is not None and x.grad.shape == x.shape
    x.grad = None
    g = torch.arange(1 << n, dtype=torch.float32)
    pc.perm_apply(x, PBmmc.bit_reverse(n), "cuda").backward(g)
    assert torch.equal(x.grad, bmmc_permute(g, PBmmc.bit_reverse(n)))
    refused = [lambda: bmmc_permute(x, PBmmc.bit_reverse(n)),
               lambda: pk.copy_blocks(x),
               lambda: pk.tiled_permute_tables(
                   x, None, None, None, None, geometry=(n, 2, 4, 1, 1, 2, 2))]
    for call in refused:
        with pytest.raises(NotImplementedError, match="raw pointer"):
            call()
    with torch.no_grad():
        assert torch.equal(bmmc_permute(x, PBmmc.bit_reverse(n)),
                           bmmc_permute(x.detach(), PBmmc.bit_reverse(n)))
    assert torch.equal(f(x.detach()), want)
