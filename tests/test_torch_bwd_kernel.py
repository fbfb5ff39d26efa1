"""The gradient kernel of the PyTorch port (K5) held against the JAX
reference on the CPU.

K5's plain version — what a CPU tensor runs, and what the CUDA kernel
``tile_bwd.cu`` is held against on the card — is the transpose of one
fused pass: it replays the cluster's epilogues on the saved input and
applies their transposes to the cotangent. Each test runs one cluster
through it and through the reference's ``_fused_bwd_pallas`` (its
``_tile_bwd_kernel`` in Pallas interpret mode) on the same numpy inputs,
made from a seed:

* compare-exchange clusters bit for bit: float32 with ties, canonical NaNs
  and signed zeros, bfloat16, a d = 3 tail, a batch, clusters of 1, 2 and
  3 epilogues and the largest cluster of a 2^10 sort (the masks of a
  tied compare are jax's balanced 0, 1/2, 1; both packages apply them as
  products, each rounded to the element type);
* butterfly clusters within a norm-wise relative error of 1e-6 on
  unit-normal inputs (XLA may contract ``a*b + c*d`` into a fused
  multiply-add, the port rounds each product and sum on its own, so the
  two differ by a few float32 ulps, eps = 6e-8, per butterfly; an
  elementwise bound would fail where the sums cancel).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators.fft import fft_expr as r_fft_expr
from repro.combinators.sort import sort_expr as r_sort_expr
import repro_torch.combinators as pc
from repro_torch.combinators import execute as pex
from repro_torch.combinators.fft import fft_expr as p_fft_expr
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.kernels import bmmc_permute as pk

BF16 = np.dtype(ml_dtypes.bfloat16)


def _clusters(rexpr, pexpr, n, t):
    """The (reference, port) FusedStages with computes, in program order."""
    rp = rc.compile_expr(rexpr, engine="pallas").clustered_program(n, t)
    pp = pc.compile_expr(pexpr, engine="cuda").clustered_program(n, t)
    rf = [s for s in rp if isinstance(s, rc.FusedStage) and s.computes]
    pf = [s for s in pp if isinstance(s, pc.FusedStage) and s.computes]
    assert len(rf) == len(pf) > 0
    return list(zip(rf, pf))


def _ties(shape, dtype, seed):
    """Small integers as ``dtype`` (many ties), with canonical NaNs and
    signed zeros."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-4, 5, size=shape).astype(np.float32)
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


def _bwd_both(rfs, pfs, t, x, ct, batched):
    """One cluster's backward through the reference's gradient kernel
    (interpret mode) and through the port's K5 plain version."""
    want = np.asarray(rex._fused_bwd_pallas(
        rfs, t, batched, jnp.asarray(x), jnp.asarray(ct)))
    before = pk.launch_counts()["tile_bwd"]
    got = pex._fused_bwd_cuda(pfs, t, batched, _to_torch(x), _to_torch(ct))
    assert pk.launch_counts()["tile_bwd"] == before   # CPU: the plain version
    return want, _to_numpy(got)


@pytest.fixture(scope="module")
def sort_clusters():
    """Sort clusters at 2^8, t = 4, by their number of epilogues."""
    by = {}
    for rfs, pfs in _clusters(r_sort_expr(8), p_sort_expr(8), 8, 4):
        by.setdefault(len(pfs.computes), (rfs, pfs))
    assert {1, 2, 3} <= set(by)
    return by


@pytest.mark.parametrize("label,epis,dtype,shape,batched", [
    ("float32 1 epilogue", 1, np.float32, (1 << 8,), False),
    ("float32 2 epilogues", 2, np.float32, (1 << 8,), False),
    ("float32 3 epilogues", 3, np.float32, (1 << 8,), False),
    ("bfloat16", 3, BF16, (1 << 8,), False),
    ("float32 d=3", 2, np.float32, (1 << 8, 3), False),
    ("float32 B=2 d=3", 3, np.float32, (2, 1 << 8, 3), True),
    ("bfloat16 B=3", 1, BF16, (3, 1 << 8), True)])
def test_cmp_cluster_backward_bitwise_equal_reference(
        sort_clusters, label, epis, dtype, shape, batched):
    rfs, pfs = sort_clusters[epis]
    x = _ties(shape, dtype, seed=len(label))
    ct = np.random.default_rng(len(label) + 100).normal(
        size=shape).astype(np.float32).astype(dtype)
    want, got = _bwd_both(rfs, pfs, 4, x, ct, batched)
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), label


def test_largest_sort_cluster_backward_bitwise_equal_reference():
    n, t = 10, 5
    pairs = _clusters(r_sort_expr(n), p_sort_expr(n), n, t)
    rfs, pfs = max(pairs, key=lambda p: len(p[1].computes))
    assert len(pfs.computes) >= 8
    x = _ties((1 << n,), np.float32, seed=5)
    ct = np.random.default_rng(6).normal(size=1 << n).astype(np.float32)
    want, got = _bwd_both(rfs, pfs, t, x, ct, False)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,t", [(7, 3), (8, 4)])
def test_bfly_cluster_backward_matches_reference(n, t):
    pairs = _clusters(r_fft_expr(n), p_fft_expr(n), n, t)
    rng = np.random.default_rng(n)
    for rfs, pfs in pairs:
        assert all(isinstance(c, pc.Bfly) for c, _ in pfs.computes)
        x = rng.normal(size=(1 << n, 2)).astype(np.float32)
        ct = rng.normal(size=(1 << n, 2)).astype(np.float32)
        want, got = _bwd_both(rfs, pfs, t, x, ct, False)
        assert (np.linalg.norm(got - want)
                <= 1e-6 * np.linalg.norm(want))


def test_plain_version_is_the_cpu_route_of_the_wrapper(sort_clusters):
    """The public wrapper on a CPU tensor and the plain version on any
    device give the same bits, with the reference's signature."""
    _, pfs = sort_clusters[3]
    plans, entries, inv, _ = pex._fused_bwd_kernel_plan(pfs, 4)
    plan = plans[0]
    sig, scal, vmem, _ = pex._fused_kernel_args(entries, torch.float32)
    x = _to_torch(_ties((1 << 8,), np.float32, seed=9))
    ct = torch.from_numpy(np.random.default_rng(10).normal(
        size=1 << 8).astype(np.float32))
    kw = dict(geometry=pk.plan_geometry(plan), epilogue=sig,
              epi_scalar=scal, epi_vmem=vmem)
    a = pk.tiled_permute_bwd_tables(x, ct, plan.in_rows, plan.out_rows,
                                    plan.xor_low, inv, **kw)
    b = pk.tiled_permute_bwd_tables_plain(x, ct, plan.in_rows, plan.out_rows,
                                          plan.xor_low, inv, **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # a map epilogue: its function's VJP on the CPU, the same through both
    mkw = dict(geometry=kw["geometry"], epilogue=(("map", "x3"),),
               epi_scalar=((),), epi_vmem=((),), map_fns=(lambda v: v * 3,))
    a = pk.tiled_permute_bwd_tables(x, ct, plan.in_rows, plan.out_rows,
                                    plan.xor_low, inv, **mkw)
    b = pk.tiled_permute_bwd_tables_plain(x, ct, plan.in_rows,
                                          plan.out_rows, plan.xor_low, inv,
                                          **mkw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="map_fns"):
        pk.tiled_permute_bwd_tables(x, ct, plan.in_rows, plan.out_rows,
                                    plan.xor_low, inv,
                                    **dict(mkw, map_fns=()))
    with pytest.raises(ValueError,
                       match="float32, bfloat16, float16 or float64"):
        pk.tiled_permute_bwd_tables(x.to(torch.int32), ct.to(torch.int32),
                                    plan.in_rows, plan.out_rows,
                                    plan.xor_low, inv, **kw)


def test_inverse_gather_table_inverts_src0(sort_clusters):
    for _, pfs in sort_clusters.values():
        plans, _, inv, extra = pex._fused_bwd_kernel_plan(pfs, 4)
        src0 = plans[0].src0.reshape(-1)
        assert inv.dtype == src0.dtype == np.int32
        assert np.array_equal(inv.reshape(-1)[src0], np.arange(src0.size))
        assert extra == ()
