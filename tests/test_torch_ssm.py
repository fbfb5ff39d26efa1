"""The port's state-space blocks (``repro_torch.models.ssm``) against the
reference and against their own step functions, on the CPU.

Inputs are made from numpy seeds and handed to both packages.
Tolerances:

* the chunked SSD against the sequential recurrence, in either package:
  ``SEQ_TOL`` = 1e-4 (the reference's own test: the two sum the same
  terms in other orders, and decays of up to 37 steps multiply);
* the RG-LRU scan against a loop of its step: ``F32_TOL`` (the
  reference's own test);
* port against reference, float32: ``F32_TOL`` = 1e-5 absolute and
  relative (``exp``, ``sigmoid`` and ``logaddexp`` may differ by an ulp,
  and einsums sum in other orders);
* bfloat16: ``BF16_TOL`` = 2e-2 absolute (a rounding one bfloat16 step
  apart);
* the causal convolution and the scan's association order (the same
  float32 multiplies and adds in the same order): bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.models import ssm as TS

SEQ_TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)


def _ssd_inputs(seed, b, l, h, p, n, g):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt_a = (-np.abs(rng.standard_normal((b, l, h))) * 0.1).astype(np.float32)
    bb = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt_a, bb, cc


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

SSD_CASES = [  # (l, h, g, chunk): L a multiple of the chunk, padded, groups
    (32, 4, 1, 8), (37, 4, 2, 8), (5, 2, 1, 8)]


@pytest.mark.parametrize("l,h,g,chunk", SSD_CASES)
def test_ssd_equals_sequential_recurrence(l, h, g, chunk):
    """Chunked SSD == the step-by-step recurrence (state-space duality), in
    the port, and both equal the reference's chunked SSD."""
    b, p, n = 2, 8, 16
    x, dt_a, bb, cc = _ssd_inputs(l + g, b, l, h, p, n, g)
    tx, tdt, tb, tc = _t(x, dt_a, bb, cc)
    y, final = TS.ssd_chunked(tx, tdt, tb, tc, chunk=chunk,
                              return_final_state=True)
    state = torch.zeros((b, h, p, n))
    ys = []
    for t in range(l):
        state, yt = TS.ssd_decode_step(state, tx[:, t], tdt[:, t], tb[:, t],
                                       tc[:, t])
        ys.append(yt)
    np.testing.assert_allclose(_np(y), _np(torch.stack(ys, 1)), **SEQ_TOL)
    np.testing.assert_allclose(_np(final), _np(state), **SEQ_TOL)
    assert final.dtype == torch.float32
    ry, rfinal = RS.ssd_chunked(x, dt_a, bb, cc, chunk=chunk,
                                return_final_state=True)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **F32_TOL)
    np.testing.assert_allclose(_np(final), np.asarray(rfinal), **F32_TOL)
    np.testing.assert_allclose(
        _np(TS.ssd_chunked(tx, tdt, tb, tc, chunk=chunk)), np.asarray(ry),
        **F32_TOL)


def test_ssd_bf16_matches_the_reference():
    """bfloat16 inputs with the float32 decay: the products widened to
    float32 where the reference asks ``preferred_element_type``."""
    b, l, h, p, n, g = 2, 24, 4, 8, 16, 1
    x, dt_a, bb, cc = _ssd_inputs(3, b, l, h, p, n, g)
    rx, rb, rc = (jnp.asarray(a, jnp.bfloat16) for a in (x, bb, cc))
    tx, tb, tc = (t.to(torch.bfloat16) for t in _t(x, bb, cc))
    ry, rs = RS.ssd_chunked(rx, dt_a, rb, rc, chunk=8,
                            return_final_state=True)
    ty, ts = TS.ssd_chunked(tx, torch.from_numpy(dt_a), tb, tc, chunk=8,
                            return_final_state=True)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(ry, np.float32),
                               **BF16_TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(rs), rtol=1e-2,
                               atol=2e-2)
    # one decode step from the final state, in bfloat16
    st, yt = TS.ssd_decode_step(ts, tx[:, 0], torch.from_numpy(dt_a[:, 0]),
                                tb[:, 0], tc[:, 0])
    rst, ryt = RS.ssd_decode_step(rs, rx[:, 0], dt_a[:, 0], rb[:, 0],
                                  rc[:, 0])
    assert yt.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(_np(st), np.asarray(rst), rtol=1e-2,
                               atol=5e-2)
    np.testing.assert_allclose(_np(yt), np.asarray(ryt, np.float32),
                               rtol=2e-2, atol=0.5)


def test_ssd_gradients_match_jax_grad():
    b, l, h, p, n, g = 2, 20, 4, 4, 8, 2
    x, dt_a, bb, cc = _ssd_inputs(5, b, l, h, p, n, g)
    w = np.random.default_rng(6).standard_normal((b, l, h, p)).astype(
        np.float32)

    def rloss(*a):
        return jnp.sum(jnp.asarray(w) * RS.ssd_chunked(*a, chunk=8))
    want = jax.jit(jax.grad(rloss, argnums=(0, 1, 2, 3)))(x, dt_a, bb, cc)
    ts = [t.requires_grad_() for t in _t(x, dt_a, bb, cc)]
    (torch.from_numpy(w) * TS.ssd_chunked(*ts, chunk=8)).sum().backward()
    for a, t in zip(want, ts):
        a = np.asarray(a)
        rel = np.linalg.norm(t.grad.numpy() - a) / np.linalg.norm(a)
        assert rel <= F32_TOL["rtol"], rel


def test_segsum_matches_the_reference():
    a = np.random.default_rng(7).standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_allclose(_np(TS._segsum(torch.from_numpy(a))),
                               np.asarray(RS._segsum(a)), **F32_TOL)


# ---------------------------------------------------------------------------
# the causal convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_bit_for_bit(with_prev, dtype):
    """Output and carried tail against the reference, with and without a
    carried ``prev`` (decode); then a split sequence equals the whole."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 6)).astype(np.float32)
    tt = getattr(torch, dtype)
    rx, rw, rp = (jnp.asarray(a, dtype) for a in (x, w, prev))
    tx, tw, tp = (t.to(tt) for t in _t(x, w, prev))
    ro, rn = RS.causal_conv1d(rx, rw, rp if with_prev else None)
    to, tn = TS.causal_conv1d(tx, tw, tp if with_prev else None)
    for got, want in ((to, ro), (tn, rn)):
        assert got.dtype == tt
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    head, carry = TS.causal_conv1d(tx[:, :5], tw, tp if with_prev else None)
    tail, last = TS.causal_conv1d(tx[:, 5:], tw, carry)
    assert torch.equal(torch.cat([head, tail], 1), to)
    assert torch.equal(last, tn)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _lru_inputs(seed, b, l, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, l, d), (b, l, d), (b, l, d), (d,))]


@pytest.mark.parametrize("l", [16, 37, 1])
def test_rglru_scan_equals_step(l):
    """The reference's ``test_rglru_scan_equals_step`` in the port, and the
    scan against the reference's (an even, an odd and a one-step
    sequence)."""
    b, d = 2, 8
    x, ga, gx, ap = _lru_inputs(l, b, l, d)
    tx, tga, tgx, tap = _t(x, ga, gx, ap)
    y, h_last = TS.rglru(tx, tga, tgx, tap)
    h = torch.zeros((b, d))
    ys = []
    for t in range(l):
        h, yt = TS.rglru_step(h, tx[:, t], tga[:, t], tgx[:, t], tap)
        ys.append(yt)
    np.testing.assert_allclose(_np(y), _np(torch.stack(ys, 1)), **F32_TOL)
    np.testing.assert_allclose(_np(h_last), _np(h), **F32_TOL)
    ry, rh = jax.jit(RS.rglru)(x, ga, gx, ap)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **F32_TOL)
    np.testing.assert_allclose(_np(h_last), np.asarray(rh), **F32_TOL)
    rh_step, ry_step = RS.rglru_step(np.zeros((b, d), np.float32), x[:, 0],
                                     ga[:, 0], gx[:, 0], ap)
    th_step, ty_step = TS.rglru_step(torch.zeros((b, d)), tx[:, 0],
                                     tga[:, 0], tgx[:, 0], tap)
    np.testing.assert_allclose(_np(th_step), np.asarray(rh_step), **F32_TOL)
    np.testing.assert_allclose(_np(ty_step), np.asarray(ry_step), **F32_TOL)


@pytest.mark.parametrize("l", [2, 7, 16, 37])
def test_linear_scan_associates_as_jax(l):
    """The scan's recursion against ``lax.associative_scan`` with the
    reference's combine on the same ``(a, b)``: bit for bit, so the
    products associate as JAX's do (a loop of steps does not)."""
    rng = np.random.default_rng(l)
    a = rng.uniform(0.2, 1.0, (3, l, 5)).astype(np.float32)
    b = rng.standard_normal((3, l, 5)).astype(np.float32)

    def comb(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    _, want = jax.lax.associative_scan(comb, (a, b), axis=1)
    got = TS._linear_scan(torch.from_numpy(a), torch.from_numpy(b), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rglru_with_h0_and_gradients_match_the_reference():
    b, l, d = 2, 11, 6
    x, ga, gx, ap = _lru_inputs(21, b, l, d)
    h0 = np.random.default_rng(22).standard_normal((b, d)).astype(
        np.float32)
    ry, rh = RS.rglru(x, ga, gx, ap, jnp.asarray(h0))
    ty, th = TS.rglru(*_t(x, ga, gx, ap), torch.from_numpy(h0))
    np.testing.assert_allclose(_np(ty), np.asarray(ry), **F32_TOL)
    np.testing.assert_allclose(_np(th), np.asarray(rh), **F32_TOL)
    w = np.random.default_rng(23).standard_normal((b, l, d)).astype(
        np.float32)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(jnp.asarray(w) * RS.rglru(*a)[0]),
        argnums=(0, 1, 2, 3)))(x, ga, gx, ap)
    ts = [t.requires_grad_() for t in _t(x, ga, gx, ap)]
    (torch.from_numpy(w) * TS.rglru(*ts)[0]).sum().backward()
    for a, t in zip(want, ts):
        a = np.asarray(a)
        rel = np.linalg.norm(t.grad.numpy() - a) / np.linalg.norm(a)
        assert rel <= F32_TOL["rtol"], rel


def test_rglru_gradient_at_the_floor_matches_the_reference():
    """a = 1 exactly (a_param = -inf): ``1 - a*a`` is below the
    ``1e-12`` floor, so the input's gradient is the reference's through
    ``maximum``."""
    x = np.ones((1, 3, 2), np.float32)
    ga = np.zeros((1, 3, 2), np.float32)
    gx = np.zeros((1, 3, 2), np.float32)
    ap = np.asarray([-np.inf, 0.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(RS.rglru(v, ga, gx, ap)[0]))(x)
    tx = torch.from_numpy(x).requires_grad_()
    TS.rglru(tx, *_t(ga, gx, ap))[0].sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **F32_TOL)


def test_softplus_is_logaddexp():
    v = np.asarray([-50.0, -1.0, 0.0, 3.0, 25.0, 90.0], np.float32)
    np.testing.assert_allclose(_np(TS.softplus(torch.from_numpy(v))),
                               np.asarray(jax.nn.softplus(v)), rtol=1e-7,
                               atol=0)
