"""The port's MoE layer (``repro_torch.models.moe``) against the reference,
on the CPU.

Inputs are made from numpy seeds and handed to both packages. Routing
decisions are compared exactly: the expert ids of ``router_topk``, and in
``moe_ffn`` which tokens an expert's capacity dropped (their output rows
are exactly zero in both). Every case asserts that the reference's top-k
margin (the k-th largest router probability less the (k+1)-th) exceeds
``MARGIN`` = 1e-6: both packages compute the float32 softmax with
``exp`` implementations that may differ by an ulp (about 6e-8 here), so a
closer call could flip between them. Tolerances:

* weights, aux losses, outputs and gradients: ``F32_TOL`` = 1e-5
  absolute and relative (the same float32 products summed in other
  orders);
* the combine's order (a token's routed copies added in ascending expert
  id, from zero, in the tensor's type): bit for bit against the
  reference's scatter-add, on values where another order rounds
  differently.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro_torch.models import moe as TM

F32_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-6


def _weights(seed, t, e, f, xn):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    rw = rng.standard_normal((e, xn)).astype(np.float32)
    wg, wu, wd = ((rng.standard_normal(s) * 0.2).astype(np.float32)
                  for s in ((xn, e, f), (xn, e, f), (xn, f, e)))
    return x, rw, wg, wu, wd


def _margin(logits, k):
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), -1)
    return float((p[..., -k] - p[..., -k - 1]).min())


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ref_moe(k, cf):
    return jax.jit(functools.partial(RM.moe_ffn, top_k=k, capacity_factor=cf))


def dense_reference(x2d, rw, wg, wu, wd, k):
    """The reference test's no-drop oracle, in torch: every expert on
    every token, the top k picked."""
    p = torch.softmax(x2d @ rw, -1)
    vals, ids = torch.topk(p, k)
    w = vals / vals.sum(-1, keepdim=True)
    g = torch.einsum("te,xef->txf", x2d, wg)
    u = torch.einsum("te,xef->txf", x2d, wu)
    y = torch.einsum("txf,xfe->txe", torch.nn.functional.silu(g) * u, wd)
    sel = torch.gather(y, 1, ids[:, :, None].expand(-1, -1, y.shape[-1]))
    return (sel * w[:, :, None]).sum(1)


@pytest.mark.parametrize("t,xn,k", [(32, 16, 4), (64, 8, 2), (8, 384, 8)])
def test_router_topk_matches_the_reference(t, xn, k):
    logits = np.random.default_rng(xn).standard_normal((t, xn)).astype(
        np.float32) * 2
    assert _margin(logits, k) > MARGIN
    rw, rids, raux = RM.router_topk(jnp.asarray(logits), k)
    tw, tids, taux = TM.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), **F32_TOL)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(raux), **F32_TOL)


def test_router_topk_breaks_ties_to_the_lower_index():
    """``lax.top_k`` puts the lower index first on a tie; the port's
    stable descending sort does too (``torch.topk`` makes no promise)."""
    logits = np.zeros((6, 8), np.float32)
    logits[:, [1, 4, 6]] = 1.0
    logits[3] = 0.0                          # all tied
    logits[5, 7] = 2.0
    _, rids, _ = RM.router_topk(jnp.asarray(logits), 2)
    _, tids, _ = TM.router_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(tids.numpy()[0], [1, 4])
    np.testing.assert_array_equal(tids.numpy()[3], [0, 1])


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_ffn_matches_the_reference(groups):
    """The reference's ``test_moe_ffn_matches_dense_reference`` (no drops:
    capacity factor 8), in the port and against the reference's output."""
    t, e, f, xn, k = 64, 8, 12, 8, 2
    x, rw, wg, wu, wd = _weights(0, t, e, f, xn)
    assert _margin(x @ rw, k) > MARGIN
    want = dense_reference(*_t(x, rw, wg, wu, wd), k)
    got, aux = TM.moe_ffn(torch.from_numpy(x.reshape(groups, t // groups, e)),
                          *_t(rw, wg, wu, wd), top_k=k, capacity_factor=8.0)
    np.testing.assert_allclose(got.reshape(t, e).numpy(), want.numpy(),
                               rtol=2e-5, atol=2e-5)
    rout, raux = _ref_moe(k, 8.0)(x.reshape(groups, t // groups, e), rw, wg,
                                  wu, wd)
    np.testing.assert_allclose(got.numpy(), np.asarray(rout), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(raux), **F32_TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("groups,cf,k", [(1, 0.25, 1), (1, 1.0, 2),
                                         (4, 0.5, 2), (2, 1.0, 3)])
def test_capacity_drops_match_the_reference(groups, cf, k):
    """Tokens past an expert's capacity are dropped in both packages: the
    same zero rows, the same outputs elsewhere. ``cf = 0.25`` with every
    token routed to expert 0 is the reference's
    ``test_capacity_drops_tokens``."""
    t, e, f, xn = 128, 8, 8, 4
    x, rw, wg, wu, wd = _weights(int(cf * 8) + k, t, e, f, xn)
    if k == 1:
        rw = np.zeros((e, xn), np.float32)
        rw[:, 0] = 1.0                   # every token picks expert 0
    else:
        assert _margin(x @ rw, k) > MARGIN
    xg = x.reshape(groups, t // groups, e)
    rout, raux = _ref_moe(k, cf)(xg, rw, wg, wu, wd)
    got, aux = TM.moe_ffn(torch.from_numpy(xg), *_t(rw, wg, wu, wd),
                          top_k=k, capacity_factor=cf)
    rzero = np.abs(np.asarray(rout)).sum(-1) == 0
    tzero = got.abs().sum(-1).numpy() == 0
    np.testing.assert_array_equal(tzero, rzero)
    if k == 1:
        assert rzero.sum() > 0            # overflow beyond capacity dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(rout), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(raux), **F32_TOL)


@pytest.mark.parametrize("t,xn,k,cf", [(16, 4, 2, 1.25), (2048, 16, 2, 1.25),
                                       (2048, 384, 8, 1.25), (4, 16, 2, 1.25),
                                       (100, 7, 3, 0.3), (5, 2, 1, 8.0)])
def test_capacity_formula_is_the_reference(t, xn, k, cf):
    """The capacity the reference's ``moe_ffn`` allots, read off its traced
    expert products (``dot_general`` puts the batch axis first: ``(experts,
    d_ff, groups, cap)``)."""
    e, f = 4, 3
    args = (np.zeros((1, t, e), np.float32), np.zeros((e, xn), np.float32),
            np.zeros((xn, e, f), np.float32), np.zeros((xn, e, f), np.float32),
            np.zeros((xn, f, e), np.float32))
    jaxpr = jax.make_jaxpr(functools.partial(
        RM.moe_ffn, top_k=k, capacity_factor=cf))(*args)
    caps = {v.aval.shape[3] for eq in jaxpr.eqns
            if eq.primitive.name == "dot_general" for v in eq.outvars
            if v.aval.shape[:3] == (xn, f, 1)}
    assert caps == {TM.moe_capacity(t, xn, k, cf)}


def test_combine_adds_in_ascending_expert_order():
    """Each token's routed copies are added from zero in ascending sorted
    position (ascending expert id), as the reference's scatter-add does:
    copies of 1e8, 1 and -1e8 on experts 0, 1, 2 add to 0 in that order
    (1 + -1e8 + 1e8 would give 1). The combine, bit for bit against the
    reference's ``_combine_group`` on the same dispatch."""
    t, e, xn, k, cap = 4, 2, 3, 3, 8
    ids = np.tile(np.asarray([[2, 0, 1]]), (t, 1))        # ranks != ids
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    tok_sorted = order // k
    eid = flat[order]
    rank = np.arange(t * k) - np.searchsorted(eid, np.arange(xn))[eid]
    slot = eid * cap + rank
    yexp = np.zeros((xn * cap, e), np.float32)
    for s_, ex in zip(slot, eid):
        yexp[s_] = {0: 1e8, 1: 1.0, 2: -1e8}[int(ex)]
    w_sorted = np.ones(t * k, np.float32)
    keep = np.ones(t * k, bool)
    want = np.asarray(RM._combine_group(yexp, slot, tok_sorted, w_sorted,
                                        keep, t))
    inv = np.argsort(order)
    pos = np.sort(inv.reshape(t, k), -1)
    got = TM._combine_group(*_t(yexp[None], slot[None]),
                            torch.from_numpy(pos[None]),
                            torch.from_numpy(w_sorted[None]))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 0.0)


def test_moe_gradients_match_jax_grad():
    """Gradients of every input (tokens, router, expert weights) against
    ``jax.grad`` of the reference, with drops (capacity factor 1)."""
    t, e, f, xn, k = 48, 8, 12, 4, 2
    x, rw, wg, wu, wd = _weights(9, t, e, f, xn)
    assert _margin(x @ rw, k) > MARGIN
    w = np.random.default_rng(10).standard_normal((2, t // 2, e)).astype(
        np.float32)
    xg = x.reshape(2, t // 2, e)

    def rloss(*a):
        out, aux = RM.moe_ffn(*a, top_k=k, capacity_factor=1.0)
        return jnp.sum(jnp.asarray(w) * out) + aux
    want = jax.jit(jax.grad(rloss, argnums=(0, 1, 2, 3, 4)))(
        xg, rw, wg, wu, wd)
    ts = [v.requires_grad_() for v in _t(xg, rw, wg, wu, wd)]
    out, aux = TM.moe_ffn(*ts, top_k=k, capacity_factor=1.0)
    ((torch.from_numpy(w) * out).sum() + aux).backward()
    for a, v in zip(want, ts):
        a = np.asarray(a)
        rel = np.linalg.norm(v.grad.numpy() - a) / np.linalg.norm(a)
        assert rel <= F32_TOL["rtol"], rel


@pytest.mark.parametrize("k", [2, 3])
def test_dispatch_backward_adds_each_token_in_expert_order(k):
    """The dispatch gather's backward (each token's copies added in
    ascending sorted position) equals autograd's scatter-add of a plain
    gather: bit for bit in float64 on small integers, where every order
    is exact."""
    t, e, xn = 12, 4, 4
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((1, t, e)))
    ids = torch.stack([torch.randperm(xn, generator=torch.Generator(
        ).manual_seed(i))[:k] for i in range(t)])[None]
    flat = ids.reshape(1, -1)
    order = torch.argsort(flat, dim=-1, stable=True)
    tok_sorted = order // k
    pos = torch.sort(torch.argsort(order, dim=-1).reshape(1, t, k),
                     dim=-1).values
    g = torch.from_numpy(rng.integers(-8, 8, (1, t * k, e)).astype(
        np.float64))
    a = x.clone().requires_grad_()
    TM._TakeTokens.apply(a, tok_sorted, pos).backward(g)
    b = x.clone().requires_grad_()
    TM._rows(b, tok_sorted).backward(g)
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(TM._rows(x, tok_sorted), x[0][tok_sorted[0]][None])
