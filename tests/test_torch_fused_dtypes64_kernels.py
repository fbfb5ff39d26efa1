"""The fused kernels on 64-bit elements (int64, uint64, float64), cluster
by cluster and through the gradient and the FFT, held against the
reference on the CPU under ``jax.enable_x64(True)`` (scoped; the sorts
and maps: ``test_torch_fused_dtypes64.py`` and
``test_torch_fused_dtypes64_sort.py``).

* Each K4b cluster's plain version, and the guarded K4b's with no flag
  set, equals the reference's fused pass (Pallas interpret mode) bit for
  bit at pinned ``t``: integers past 2^32, float64 with ties, NaNs,
  signed zeros and doubles float32 cannot hold.
* K5's plain version on float64 equals the reference's
  ``_fused_bwd_pallas`` cluster by cluster, with a map beside the
  compares too; the float64 sort gradient equals ``jax.grad`` of the
  reference's sort bit for bit.
* A planar float64 FFT fuses every butterfly and stays within
  ``8 * log2(N)`` unit roundoffs (2^-53, norm-wise) of the exact FFT and
  of the reference (XLA may contract a product and a sum into an FMA; the
  port rounds each on its own).

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators import vocab as RV
from repro.combinators.sort import sort_expr as r_sort_expr
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.kernels import bmmc_permute as pk
from _torch_dtypes import (WIDE_TYPES, _keys, _observed, _same_bits,
                           _to_numpy, _to_torch)


def _clusters(rexpr, pexpr, n, t):
    rp = rc.compile_expr(rexpr, engine="pallas").clustered_program(n, t)
    pp = pc.compile_expr(pexpr, engine="cuda").clustered_program(n, t)
    rf = [s for s in rp if isinstance(s, rc.FusedStage) and s.computes]
    pf = [s for s in pp if isinstance(s, pc.FusedStage) and s.computes]
    assert len(rf) == len(pf) > 0
    return list(zip(rf, pf))


@pytest.fixture(scope="module")
def sort_clusters():
    """Sort clusters at 2^8, t = 4, by their number of epilogues."""
    by = {}
    for rfs, pfs in _clusters(r_sort_expr(8), p_sort_expr(8), 8, 4):
        by.setdefault(len(pfs.computes), (rfs, pfs))
    assert {1, 2, 3} <= set(by)
    return by


@pytest.mark.parametrize("dtype", WIDE_TYPES)
def test_wide_k4b_and_guarded_plain_equal_reference(sort_clusters, dtype):
    """Clusters of 1, 2 and 3 compares at t = 4 (a batch of 2 with a tail
    of 3 on the largest): the port's plain K4b and guarded K4b (no flag
    set) against the reference's fused pass under x64, bit for bit."""
    for epis, (rfs, pfs) in sorted(sort_clusters.items()):
        shape, batched = (((2, 1 << 8, 3), True) if epis == 3
                          else ((1 << 8,), False))
        x = _keys(dtype, shape, seed=epis)
        with jax.enable_x64(True):
            want = np.asarray(rex._fused_pallas(jnp.asarray(x), rfs, 4,
                                                batched=batched))
        assert want.dtype == x.dtype
        before = pk.launch_counts()["tile_fused"]
        got = _to_numpy(pex._fused_cuda(_to_torch(x), pfs, 4,
                                        batched=batched))
        assert pk.launch_counts()["tile_fused"] == before   # plain version
        _same_bits(got, want, (dtype, epis))
        plans, entries = pex._fused_plan_cached(pfs, 4)
        tabs, epi = pex._pass_tables(plans[0], entries, _to_torch(x))
        flags = torch.zeros(1, dtype=torch.int32)
        guarded = pk.tiled_permute_tables_plain(
            _to_torch(x), *tabs, geometry=pk.plan_geometry(plans[0]),
            batched=batched, flags=flags, **epi)
        assert int(flags) == 0
        _same_bits(_to_numpy(guarded), want, (dtype, epis, "guarded"))


@pytest.mark.parametrize("epis", [1, 2, 3])
def test_float64_k5_cluster_equals_reference(sort_clusters, epis):
    """K5's plain version on float64 with ties, NaNs and signed zeros
    against the reference's ``_fused_bwd_pallas`` (K5's oracle: the
    reference never reaches it from ``compile_expr``), bit for bit."""
    rfs, pfs = sort_clusters[epis]
    x = _keys("float64", (1 << 8,), seed=20 + epis)
    ct = np.random.default_rng(epis).normal(size=1 << 8)
    with jax.enable_x64(True):
        want = np.asarray(rex._fused_bwd_pallas(rfs, 4, False,
                                                jnp.asarray(x),
                                                jnp.asarray(ct)))
    assert want.dtype == np.float64
    got = pex._fused_bwd_cuda(pfs, 4, False, torch.from_numpy(x),
                              torch.from_numpy(ct)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    _same_bits(got[~nan], want[~nan], epis)


def test_float64_map_cluster_gradient_equals_reference():
    """A map between compares (``(v - 0.1) * 3``, whose constant float32
    cannot hold; a sum before the product, which XLA cannot contract into
    an FMA) in one cluster: the forward (K4b's plain version) and K5's
    plain version equal the reference's fused pass and
    ``_fused_bwd_pallas`` under x64, bit for bit."""
    n = 8

    def fn(v):
        return (v - 0.1) * 3

    def expr(V, sort_expr):
        return V.seq(sort_expr(n), V.emap("less_tenth_x3", fn),
                     sort_expr(n))
    pairs = [(r, p) for r, p in _clusters(expr(RV, r_sort_expr),
                                          expr(PV, p_sort_expr), n, 4)
             if any(isinstance(c, pc.Map) for c, _ in p.computes)]
    assert pairs
    rng = np.random.default_rng(12)
    x = rng.normal(size=1 << n) * 1e3
    ct = rng.normal(size=1 << n)
    for rfs, pfs in pairs:
        with jax.enable_x64(True):
            want_f = np.asarray(rex._fused_pallas(jnp.asarray(x), rfs, 4))
            want_b = np.asarray(rex._fused_bwd_pallas(
                rfs, 4, False, jnp.asarray(x), jnp.asarray(ct)))
        got_f = pex._fused_cuda(torch.from_numpy(x), pfs, 4).numpy()
        got_b = pex._fused_bwd_cuda(pfs, 4, False, torch.from_numpy(x),
                                    torch.from_numpy(ct)).numpy()
        _same_bits(got_f, want_f, "forward")
        _same_bits(got_b, want_b, "backward")


@pytest.mark.parametrize("shape,batched", [((), False), ((3,), True)])
def test_float64_sort_gradient_equals_reference(shape, batched, monkeypatch):
    """The port's float64 sort gradient (K5 once a compute cluster, its
    plain version; no fused fallback) is bit-equal to ``jax.grad`` of the
    reference's sort under x64."""
    n = 8
    x = np.random.default_rng(8).normal(size=shape + (1 << n,))
    x[..., ::7] = x[..., 1::7][..., :x[..., ::7].shape[-1]]   # ties
    w = np.random.default_rng(88).normal(size=shape + (1 << n,))
    f = rc.compile_expr(r_sort_expr(n), engine="pallas")
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            jnp.asarray(w) * f(v, batched=batched)))(jnp.asarray(x)))
    assert want.dtype == np.float64
    monkeypatch.setattr(pex, "BWD_MEGAKERNEL", True)
    g = pc.compile_expr(p_sort_expr(n), engine="cuda")
    xt = torch.from_numpy(x).requires_grad_(True)
    pobs.reset()
    pobs.enable()
    try:
        (torch.from_numpy(w) * g(xt, batched=batched)).sum().backward()
        assert pobs.counter_total("dispatch.fused_fallback") == 0
    finally:
        pobs.disable()
        pobs.reset()
    _same_bits(xt.grad.numpy(), want, shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_float64_planar_fft_fuses_within_tolerance():
    """The 2^10 FFT on planar float64 input: every butterfly cluster fused
    (no fallback), within 8 * log2(N) unit roundoffs (2^-53) norm-wise of
    the exact FFT and of the reference under x64."""
    from repro.combinators import fft as rfft
    from repro_torch.combinators import fft as pfft
    n = 10
    rng = np.random.default_rng(6)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    x = np.stack([z.real, z.imag], axis=-1)
    got, hist, fall = _observed(pobs, lambda: pc.compile_expr(
        pfft.fft_expr(n), engine="cuda")(torch.from_numpy(x)))
    assert fall == 0 and hist.get("fused", 0) > 0, hist
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(rc.compile_expr(rfft.fft_expr(n), engine="pallas")(
            jnp.asarray(x)))
    assert want.dtype == np.float64
    exact = np.fft.fft(z)
    exact = np.stack([exact.real, exact.imag], axis=-1)
    tol = 8 * n * 2.0 ** -53
    assert _rel(got.numpy(), exact) <= tol, (_rel(got.numpy(), exact), tol)
    assert _rel(got.numpy(), want) <= tol, (_rel(got.numpy(), want), tol)
