"""Gradients of the PyTorch port's combinator programs held against the JAX
reference on the CPU.

The same numpy inputs, made from a seed, go through
``jax.grad(lambda v: jnp.sum(w * f(v)))`` of the reference's
``compile_expr(..., engine="pallas")`` and through ``(w * f(x)).sum()
.backward()`` of the port's ``compile_expr``, on each of the port's
backward routes: the gradient kernel route (``"cuda"`` with
``BWD_MEGAKERNEL``; a CPU tensor runs K5's plain version), the collapsed
plan on ``"cuda"`` (``BWD_MEGAKERNEL`` off) and the ``"ref"`` engine's
collapsed plan.

* Permutation-only chains and sorts (float32 and bfloat16, with ties,
  batched, with a d tail): bit for bit.
* The planar FFT: within a norm-wise relative error of 1e-6 (XLA may
  contract the butterflies' products into fused multiply-adds; the port
  rounds each product and sum on its own).
* A program that holds a ``Map`` (``tanh``): within 1e-5 relative plus
  1e-6 absolute (torch's and XLA's ``tanh`` and its derivative ``1 -
  tanh²`` differ by a few float32 ulps).
* complex64 FFT: torch's gradient of a complex input is the conjugate of
  JAX's, within the FFT's tolerance.
* Counts: a cold backward's ``model.vjp_round_trips`` equals
  ``CompiledExpr.vjp_round_trips``: the forward's round trips on the
  gradient kernel route, the reference's counts on the collapsed route
  (sort 2^8: 0, permutation chain 2^8: 1).
"""
import random

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import vocab as RV
from repro.combinators.fft import fft_expr as r_fft_expr
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core.bmmc import Bmmc as RBmmc
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.fft import fft_expr as p_fft_expr
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels.ops import choose_tile

BF16 = np.dtype(ml_dtypes.bfloat16)
N = 8
# (engine, BWD_MEGAKERNEL): the port's three backward routes
ROUTES = [("cuda", True), ("cuda", False), ("ref", True)]


def _perm_expr(V, Bmmc, n, seed=0):
    rng = random.Random(seed)
    return V.bit_reverse(n) >> V.perm(Bmmc.random(n, rng)) >> V.riffle(n)


def _to_torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _ref_grad(rexpr, x, w, batched=False):
    f = rc.compile_expr(rexpr, engine="pallas")
    return np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.asarray(w) * f(v, batched=batched)))(jnp.asarray(x)))


def _port_grad(pexpr, x, w, route, monkeypatch, batched=False):
    engine, mega = route
    monkeypatch.setattr(pex, "BWD_MEGAKERNEL", mega)
    f = pc.compile_expr(pexpr, engine=engine)
    xt = _to_torch(x).requires_grad_(True)
    (_to_torch(w) * f(xt, batched=batched)).sum().backward()
    return _to_numpy(xt.grad)


def _ties(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 6, size=shape).astype(np.float32).astype(dtype)
    w = rng.normal(size=shape).astype(np.float32).astype(dtype)
    return x, w


@pytest.fixture(scope="module")
def sort_cases():
    """Inputs and the reference's gradients, computed once per case."""
    cases = {}
    for label, dtype, shape, batched in [
            ("float32", np.float32, (1 << N,), False),
            ("bfloat16", BF16, (1 << N,), False),
            ("float32 B=3", np.float32, (3, 1 << N), True),
            ("float32 d=3", np.float32, (1 << N, 3), False)]:
        x, w = _ties(shape, dtype, seed=len(label))
        cases[label] = (x, w, batched,
                        _ref_grad(r_sort_expr(N), x, w, batched))
    return cases


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{r[1]}")
@pytest.mark.parametrize("label", ["float32", "bfloat16", "float32 B=3",
                                   "float32 d=3"])
def test_sort_gradient_bitwise_equal_reference(sort_cases, label, route,
                                               monkeypatch):
    x, w, batched, want = sort_cases[label]
    got = _port_grad(p_sort_expr(N), x, w, route, monkeypatch, batched)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("engine", ["cuda", "ref"])
def test_perm_chain_gradient_bitwise_equal_reference(engine, monkeypatch):
    rng = np.random.default_rng(9)
    x = rng.normal(size=1 << N).astype(np.float32)
    w = rng.normal(size=1 << N).astype(np.float32)
    want = _ref_grad(_perm_expr(RV, RBmmc, N), x, w)
    got = _port_grad(_perm_expr(PV, PBmmc, N), x, w, (engine, True),
                     monkeypatch)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # and it is the inverse program applied to w
    f = pc.compile_expr(_perm_expr(PV, PBmmc, N), engine=engine)
    inv = pc.run_program(f.vjp_program(N), torch.from_numpy(w), "ref")
    assert np.array_equal(got.view(np.uint32), inv.numpy().view(np.uint32))


@pytest.fixture(scope="module")
def fft_case():
    n = 7
    rng = np.random.default_rng(13)
    z = (rng.normal(size=1 << n)
         + 1j * rng.normal(size=1 << n)).astype(np.complex64)
    x = np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    w = rng.normal(size=(1 << n, 2)).astype(np.float32)
    return n, z, x, w, _ref_grad(r_fft_expr(n), x, w)


def _close(got, want, tol):
    return np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{r[1]}")
def test_fft_planar_gradient_matches_reference(fft_case, route, monkeypatch):
    n, _, x, w, want = fft_case
    got = _port_grad(p_fft_expr(n), x, w, route, monkeypatch)
    assert got.shape == want.shape and _close(got, want, 1e-6)


def test_complex_fft_gradient_is_the_conjugate_of_jax(fft_case):
    n, z, _, w, _ = fft_case
    wc = (w[:, 0] + 1j * w[:, 1]).astype(np.complex64)
    rf = rc.compile_expr(r_fft_expr(n), engine="pallas")
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.real(
        jnp.asarray(wc) * rf(v))))(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    (torch.from_numpy(wc) * pc.compile_expr(p_fft_expr(n))(zt)).real.sum() \
        .backward()
    got = zt.grad.numpy()
    assert got.dtype == np.complex64
    assert _close(got, np.conj(want), 1e-6)
    assert not _close(got, want, 1e-2)   # the convention does differ


def _map_expr(V, Bmmc, tanh):
    rng = random.Random(3)
    return V.seq(V.perm(Bmmc.random_bpc(N, rng)), V.cmp_halves(),
                 V.emap("tanh", tanh), V.perm(Bmmc.random(N, rng)),
                 V.cmp_halves(), V.riffle(N))


@pytest.mark.parametrize("engine", ["cuda", "ref"])
def test_map_program_gradient_matches_reference(engine, monkeypatch):
    rng = np.random.default_rng(21)
    x = rng.normal(size=1 << N).astype(np.float32)
    w = rng.normal(size=1 << N).astype(np.float32)
    want = _ref_grad(_map_expr(RV, RBmmc, jnp.tanh), x, w)
    got = _port_grad(_map_expr(PV, PBmmc, torch.tanh), x, w, (engine, True),
                     monkeypatch)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _cold_backward(f, x, w):
    """Counters of one cold forward and one cold backward (cleared
    caches): (forward round trips, backward round trips, fused fallbacks
    of the forward and of the backward, backward rules by kind)."""
    pex.clear_caches()
    pobs.reset()
    pobs.enable()
    try:
        xt = x.clone().requires_grad_(True)
        y = f(xt)
        fwd = pobs.counter_total("model.round_trips")
        fb0 = pobs.counter_total("dispatch.fused_fallback")
        (w * y).sum().backward()
        bwd = pobs.counter_total("model.vjp_round_trips")
        fb = (fb0, pobs.counter_total("dispatch.fused_fallback") - fb0)
        kinds = {dict(lab)["kind"]: v for (name, lab), v
                 in pobs.counters().items() if name == "dispatch.vjp"}
    finally:
        pobs.disable()
        pobs.reset()
    return fwd, bwd, fb, kinds


@pytest.mark.parametrize("name,mega,want", [
    ("sort", False, 0), ("perm", False, 1), ("perm", True, 1),
    ("sort", True, None), ("fft", True, None)])
def test_cold_backward_counts_equal_the_model(name, mega, want, monkeypatch):
    monkeypatch.setattr(pex, "BWD_MEGAKERNEL", mega)
    n = N if name != "fft" else 7
    expr = {"sort": lambda: p_sort_expr(n), "fft": lambda: p_fft_expr(n),
            "perm": lambda: _perm_expr(PV, PBmmc, n)}[name]()
    f = pc.compile_expr(expr)
    shape = (1 << n, 2) if name == "fft" else (1 << n,)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    t = choose_tile(n, 4, 2 if name == "fft" else 1)
    modeled = f.vjp_round_trips(n, t)
    fwd, bwd, fb, kinds = _cold_backward(f, x, w)
    assert fb == (0, 0)
    assert bwd == modeled
    if want is not None:                      # the reference's counts
        assert modeled == want
    else:                                     # K5 route: the forward's
        assert modeled == fwd == f.cost(n, t, clustered=True)["round_trips"]
    assert kinds == {"program": 1}


def test_kernel_route_runs_k5_once_per_compute_cluster():
    n = N
    f = pc.compile_expr(p_sort_expr(n))
    t = choose_tile(n, 4)
    clusters = [s for s in f.clustered_program(n, t)
                if isinstance(s, pc.FusedStage) and s.computes]
    calls = []
    real = pex._fused_bwd_cuda

    def spy(fs, *a):
        calls.append(fs)
        return real(fs, *a)

    pex._fused_bwd_cuda = spy
    try:
        x = torch.randn(1 << n, requires_grad=True)
        f(x).sum().backward()
    finally:
        pex._fused_bwd_cuda = real
    assert calls == clusters[::-1]
    assert pk.launch_counts()["tile_bwd"] == 0       # CPU: the plain version


def test_residuals_are_the_inputs_of_compute_bearing_stages():
    n = N
    x = torch.randn(1 << n, requires_grad=True)
    perm = pc.compile_expr(_perm_expr(PV, PBmmc, n))
    assert len(perm(x).grad_fn.saved_tensors) == 0
    f = pc.compile_expr(p_sort_expr(n))
    prog = f.clustered_program(n, choose_tile(n, 4))
    bearing = sum(isinstance(s, (pc.CmpHalves, pc.Bfly)) or (
        isinstance(s, pc.FusedStage) and bool(s.computes)) for s in prog)
    assert len(f(x).grad_fn.saved_tensors) == 1 + bearing


def test_fallback_layout_counts_and_agrees(monkeypatch):
    """An element type with no kernel (float64, its code taken out of the
    kernels' type table for this test): each compute cluster counts a
    fused fallback in the forward and again in the backward, where it
    takes its collapsed plan (whose final inverse pass, compute-free,
    falls back too); the result agrees with the collapsed route of the
    whole program bit for bit."""
    monkeypatch.delitem(pk._ELEM_TYPE, torch.float64)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 5, 1 << N).astype(np.float64))
    w = torch.from_numpy(rng.normal(size=1 << N))
    f = pc.compile_expr(p_sort_expr(N))
    _, _, (fb_fwd, fb_bwd), _ = _cold_backward(f, x, w)
    t = choose_tile(N, 8)
    n_clusters = sum(isinstance(s, pc.FusedStage) and bool(s.computes)
                     for s in f.clustered_program(N, t))
    assert fb_fwd == n_clusters > 0 and fb_bwd >= n_clusters

    def grad(mega):
        monkeypatch.setattr(pex, "BWD_MEGAKERNEL", mega)
        xt = x.clone().requires_grad_(True)
        (w * f(xt)).sum().backward()
        return xt.grad
    assert torch.equal(grad(True), grad(False))


def test_call_per_stage_and_run_program_differentiate_too():
    n = N
    f = pc.compile_expr(p_sort_expr(n))
    x = torch.randn(1 << n)
    w = torch.randn(1 << n)
    grads = []
    for call in (f, f.call_per_stage,
                 lambda v: pc.run_program(f.program(n), v, "cuda")):
        xt = x.clone().requires_grad_(True)
        (w * call(xt)).sum().backward()
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


@pytest.mark.parametrize("kind", ["cmp", "bfly"])
def test_pulled_back_tables_equal_reference(kind):
    """The offline tables of a compute pulled back through a prefix BMMC
    (built by doubling in the port, by parity sums in the reference) are
    equal, and so is the BMMC table they come from."""
    from repro.combinators import execute as rex
    for seed in range(4):
        rb = RBmmc.random(9, random.Random(seed))
        pb = PBmmc(rb.rows, rb.c)
        assert np.array_equal(pex._bmmc_table(pb), rex._bmmc_table(rb))
        for a, b in zip(pex._pulled_back_tables(pb, kind),
                        rex._pulled_back_tables(rb, kind)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b)
