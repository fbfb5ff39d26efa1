"""The fused kernels on the element types the reference's fused kernel
takes, cluster by cluster and through the gradient and the FFT, held
against it on the CPU (the sorts and maps: ``test_torch_fused_dtypes.py``).

* Each K4b cluster's plain version equals the reference's fused pass
  (Pallas interpret mode) bit for bit, float16 with canonical NaNs and
  signed zeros (NaNs by position: XLA's CPU rewrites them).
* The float16 sort gradient (the reference's
  ``test_collapsed_backward_bitwise_vs_replay`` cases) is bit-equal to
  ``jax.grad`` of the reference's, and K5's plain version equals the
  reference's ``_fused_bwd_pallas`` cluster by cluster.
* A float16 and a bfloat16 planar FFT fuse every butterfly and stay
  within ``8 * log2(N)`` unit roundoffs (norm-wise) of float64 and of the
  reference: each product and sum rounds once to the half type, and XLA
  may keep some in float32, so the two packages differ by roundings.
* A map beside butterflies runs inside the fused pass and matches the
  reference within the same norm-wise bound (float32 and float16).

Inputs are made with numpy from a seed and handed to both packages.
"""
import random

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
from repro_torch.kernels import ops as pops
from _torch_dtypes import (BF16, NEW_TYPES, _keys, _observed, _same_bits,
                           _to_numpy, _to_torch)


# ---------------------------------------------------------------------------
# K4b and K5 cluster by cluster
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("dtype", NEW_TYPES)
def test_k4b_cluster_plain_equals_reference(sort_clusters, dtype):
    """Clusters of 1, 2 and 3 compares, a batch of 2 with a tail of 3 on
    the largest: the port's plain K4b against the reference's fused
    pass, bit for bit (float16 NaNs by position)."""
    for epis, (rfs, pfs) in sorted(sort_clusters.items()):
        shape, batched = (((2, 1 << 8, 3), True) if epis == 3
                          else ((1 << 8,), False))
        x = _keys(dtype, shape, seed=epis)
        want = np.asarray(rex._fused_pallas(jnp.asarray(x), rfs, 4,
                                            batched=batched))
        before = pk.launch_counts()["tile_fused"]
        got = _to_numpy(pex._fused_cuda(_to_torch(x), pfs, 4,
                                        batched=batched))
        assert pk.launch_counts()["tile_fused"] == before   # plain version
        if dtype == "float16":
            nan = np.isnan(want)
            assert np.array_equal(nan, np.isnan(got))
            got, want = got[~nan], want[~nan]
        _same_bits(got, want, (dtype, epis))


@pytest.mark.parametrize("shape,batched", [((), False), ((8,), True),
                                           ((3,), True)])
def test_float16_sort_gradient_equals_reference(shape, batched, monkeypatch):
    """The reference's float16 cases of
    ``test_collapsed_backward_bitwise_vs_replay``: the port's gradient
    (K5 once a compute cluster, its plain version) is bit-equal to
    ``jax.grad`` of the reference's sort."""
    n = 8
    x = np.random.default_rng(7).normal(size=shape + (1 << n,)).astype(
        np.float16)
    w = np.random.default_rng(77).normal(size=shape + (1 << n,)).astype(
        np.float16)
    f = rc.compile_expr(r_sort_expr(n), engine="pallas")
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.asarray(w) * f(v, batched=batched)))(jnp.asarray(x)))
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


@pytest.mark.parametrize("epis", [1, 2, 3])
def test_float16_k5_cluster_equals_reference(sort_clusters, epis):
    """K5's plain version on float16 with ties, canonical NaNs and signed
    zeros against the reference's ``_fused_bwd_pallas`` (K5's oracle: the
    reference never reaches it from ``compile_expr``), bit for bit."""
    rfs, pfs = sort_clusters[epis]
    x = _keys("float16", (1 << 8,), seed=20 + epis)
    ct = np.random.default_rng(epis).normal(size=1 << 8).astype(np.float16)
    want = np.asarray(rex._fused_bwd_pallas(rfs, 4, False, jnp.asarray(x),
                                            jnp.asarray(ct)))
    got = pex._fused_bwd_cuda(pfs, 4, False, torch.from_numpy(x),
                              torch.from_numpy(ct)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    _same_bits(got[~nan], want[~nan], epis)


# ---------------------------------------------------------------------------
# butterflies on half floats, and a map beside them
# ---------------------------------------------------------------------------

_UNIT = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8, "float32": 2.0 ** -24}


def _fft_expr(V, F, n, map_at=None, name=None, fn=None):
    """The package's 2^n-point FFT, with ``emap(name, fn)`` after stage
    ``map_at`` when given (at 2^8, t = 4, stage 2's cluster holds the map
    beside butterflies)."""
    stages = [V.bit_reverse(n)]
    for s in range(n):
        e = F._stage_core(s)
        for _ in range(n - s - 1):
            e = V.two(e)
        stages.append(e)
        if s == map_at:
            stages.append(V.emap(name, fn))
    return V.seq(*stages)


def _planar(z, dtype):
    p = np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return p.astype(BF16 if dtype == "bfloat16" else dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_planar_fft_fuses_within_tolerance(dtype):
    from repro.combinators import fft as rfft
    from repro_torch.combinators import fft as pfft
    n = 10
    rng = np.random.default_rng(5)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    x = _planar(z, dtype)
    got, hist, fall = _observed(pobs, lambda: pc.compile_expr(
        pfft.fft_expr(n), engine="cuda")(_to_torch(x)))
    assert fall == 0 and hist.get("fused", 0) > 0, hist
    got = got.float().numpy()
    want = np.asarray(rc.compile_expr(rfft.fft_expr(n), engine="pallas")(
        jnp.asarray(x))).astype(np.float32)
    exact = np.fft.fft(x.astype(np.float64)[:, 0]
                      + 1j * x.astype(np.float64)[:, 1])
    exact = np.stack([exact.real, exact.imag], axis=-1)
    tol = 8 * n * _UNIT[dtype]
    assert _rel(got, exact) <= tol, (_rel(got, exact), tol)
    assert _rel(got, want) <= tol, (_rel(got, want), tol)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_map_beside_butterflies_equals_reference(dtype):
    """``emap(v * 2 - 1)`` after butterfly stage 2: the cluster holds
    the map and butterflies, runs as one fused pass (no fallback), and
    matches the reference within 8 * log2(N) unit roundoffs norm-wise
    (XLA may contract a product and a sum into an FMA; the port rounds
    each on its own)."""
    from repro.combinators import fft as rfft
    from repro_torch.combinators import fft as pfft
    n = 8

    def fn(v):
        return v * 2 - 1
    pexpr = _fft_expr(PV, pfft, n, 2, "twice_less_one", fn)
    rexpr = _fft_expr(RV, rfft, n, 2, "twice_less_one", fn)
    prog = pc.compile_expr(pexpr, engine="cuda").clustered_program(
        n, pops.choose_tile(n, 2, 2))
    assert any(isinstance(s, pc.FusedStage)
               and any(isinstance(c, pc.Map) for c, _ in s.computes)
               and any(isinstance(c, pc.Bfly) for c, _ in s.computes)
               for s in prog)
    rng = np.random.default_rng(11)
    x = _planar(rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n),
                dtype)
    got, hist, fall = _observed(pobs, lambda: pc.compile_expr(
        pexpr, engine="cuda")(_to_torch(x)))
    assert fall == 0 and hist.get("fused", 0) > 0, hist
    want = np.asarray(rc.compile_expr(rexpr, engine="pallas")(
        jnp.asarray(x))).astype(np.float32)
    got = got.float().numpy()
    assert _rel(got, want) <= 8 * n * _UNIT[dtype], _rel(got, want)
