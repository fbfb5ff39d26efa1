"""The port's AdamW, 8-bit moments and schedule against the reference, on
the CPU.

Inputs are made from a numpy seed and handed to both packages.
Tolerances:

* ``quantize8`` / ``dequantize8``, the moments after ``adamw_update``, the
  state's shapes and types, and the state carried across by
  ``convert``: bit for bit;
* the updated parameters: ``UPDATE_RTOL`` = 2 float32 ulps. Both compute
  the same rounding steps in the same order, and the moments come out
  bit-equal, but XLA's CPU code evaluates the update's last line with
  other instructions for some vector lengths: one ulp apart in a few
  elements of a (128, 256) leaf, none in the others;
* ``warmup_cosine``: 1e-6 absolute (``cos`` may differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim.schedule import warmup_cosine as r_warmup_cosine
from repro_torch.models.convert import (opt_state_from_numpy,
                                        opt_state_to_numpy)
from repro_torch.optim import adamw as TA
from repro_torch.optim.schedule import warmup_cosine as t_warmup_cosine
from repro_torch.tree import tree_leaves

UPDATE_RTOL = 2.4e-7
SHAPES = {"a": (3, 300), "b": {"c": (7,), "d": (2, 3, 515)},
          "e": (128, 256), "f": (5, 100)}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(), (7,), (3, 300), (2, 3, 515),
                                   (128, 256), (4, 255), (2, 513)])
def test_quantize8_bit_for_bit(shape):
    """A scalar, last axes under 256, and ragged pads (300, 515, 255,
    513): codes, scales and the dequantized values equal the
    reference's."""
    x = np.random.default_rng(len(shape) * 7 + sum(shape)).standard_normal(
        shape).astype(np.float32)
    want = RA.quantize8(jnp.asarray(x))
    got = TA.quantize8(torch.from_numpy(x))
    for k in ("q", "s"):
        assert got[k].dtype == {"q": torch.int8, "s": torch.float32}[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        TA.dequantize8(got, shape).numpy(),
        np.asarray(RA.dequantize8(want, shape)))


def test_quantize8_rounds_half_to_even():
    # 127 * x / max: 0.5, 1.5 and 2.5 land exactly on halves
    x = np.asarray([0.5, 1.5, 2.5, -0.5, 127.0], np.float32)
    got = TA.quantize8(torch.from_numpy(x))["q"].numpy()
    np.testing.assert_array_equal(got, np.asarray(
        RA.quantize8(jnp.asarray(x))["q"]))
    np.testing.assert_array_equal(got[0, :4], [0, 2, 2, 0])


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_update_matches_the_reference(bits):
    """Four steps from identical params, grads and state: moments bit
    for bit, parameters within UPDATE_RTOL; gradients from 1e-9 to 1."""
    rng = np.random.default_rng(bits)
    p = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    rcfg, tcfg = RA.AdamWConfig(state_bits=bits), TA.AdamWConfig(
        state_bits=bits)
    rp = jax.tree.map(jnp.asarray, p)
    rs = RA.adamw_init(rp, rcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    ts = TA.adamw_init(tp, tcfg)
    for _ in range(4):
        g = _tree(lambda s: (rng.standard_normal(s) * 10.0 ** float(
            rng.integers(-9, 1))).astype(np.float32))
        rp, rs = RA.adamw_update(rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
        tp2, ts = TA.adamw_update(tp, jax.tree.map(torch.from_numpy, g), ts,
                                  tcfg)
        assert tp2 is tp                      # in place
        for a, b in zip(jax.tree.leaves(rp), tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=UPDATE_RTOL, atol=0)
        got = opt_state_to_numpy(ts)
        assert int(got.step) == int(rs.step)
        for a, b in zip(jax.tree.leaves(_host(rs)), jax.tree.leaves(
                tuple(got))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)


MIXED = {"w": ((3, 300), "bfloat16"), "router": ((16, 4), "float32"),
         "gate": ((1,), "float32"), "a_log": ((7,), "float32"),
         "x": ((2, 3, 515), "bfloat16")}


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_update_of_a_mixed_tree_matches_the_reference(bits):
    """A tree of the non-dense block kinds' mix: bfloat16 weights beside
    float32 leaves, among them a ``(1,)`` gate smaller than one 8-bit
    block. Three steps from identical params, grads and state: moments
    bit for bit; float32 parameters within UPDATE_RTOL; bfloat16
    parameters (rounded from those float32 values) within one bfloat16
    step (2^-8 relative); each leaf keeps its type."""
    rng = np.random.default_rng(bits + 1)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, (s, _) in MIXED.items()}
    rp = {k: jnp.asarray(v, MIXED[k][1]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()).to(getattr(torch, MIXED[k][1]))
          for k, v in p.items()}
    rcfg, tcfg = RA.AdamWConfig(state_bits=bits), TA.AdamWConfig(
        state_bits=bits)
    rs, ts = RA.adamw_init(rp, rcfg), TA.adamw_init(tp, tcfg)
    for _ in range(3):
        g = {k: rng.standard_normal(MIXED[k][0]).astype(np.float32)
             for k in p}
        rp, rs = RA.adamw_update(
            rp, {k: jnp.asarray(v, MIXED[k][1]) for k, v in g.items()}, rs,
            rcfg)
        _, ts = TA.adamw_update(tp, {k: torch.from_numpy(v).to(tp[k].dtype)
                                     for k, v in g.items()}, ts, tcfg)
        for k, (_, dt) in MIXED.items():
            assert str(tp[k].dtype) == f"torch.{dt}"
            tol = (dict(rtol=UPDATE_RTOL, atol=0) if dt == "float32"
                   else dict(rtol=2.0 ** -8, atol=0))
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(rp[k], np.float32), **tol)
        got = opt_state_to_numpy(ts)
        for a, b in zip(jax.tree.leaves(_host(rs)), jax.tree.leaves(
                tuple(got))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)


def test_adamw_update_in_slices_equals_one_pass(monkeypatch):
    """The update runs each leaf in slices of rows; the slicing changes
    no bit (float32 and 8-bit, a bfloat16 leaf among them)."""
    for bits in (32, 8):
        cfg = TA.AdamWConfig(state_bits=bits)
        outs = []
        for chunk in (TA._CHUNK, 300):
            monkeypatch.setattr(TA, "_CHUNK", chunk)
            r = np.random.default_rng(6)
            p = {"w": torch.from_numpy(r.standard_normal((40, 70)).astype(
                np.float32)), "h": torch.from_numpy(r.standard_normal(
                    (3, 9, 33)).astype(np.float32)).to(torch.bfloat16)}
            st = TA.adamw_init(p, cfg)
            for _ in range(3):
                g = {k: torch.from_numpy(r.standard_normal(tuple(v.shape))
                                         .astype(np.float32)).to(v.dtype)
                     for k, v in p.items()}
                p, st = TA.adamw_update(p, g, st, cfg)
            outs.append((p, st))
        (p0, s0), (p1, s1) = outs
        for a, b in zip(tree_leaves(p0) + tree_leaves(s0.m) +
                        tree_leaves(s0.v),
                        tree_leaves(p1) + tree_leaves(s1.m) +
                        tree_leaves(s1.v)):
            assert torch.equal(a, b)


def test_state_shapes_match_init_and_the_reference():
    params = {"a": torch.zeros((3, 300)), "b": {"c": torch.zeros((7,))},
              "s": torch.zeros(())}
    rparams = {"a": jnp.zeros((3, 300)), "b": {"c": jnp.zeros((7,))},
               "s": jnp.zeros(())}
    for bits in (32, 8):
        tcfg, rcfg = TA.AdamWConfig(state_bits=bits), RA.AdamWConfig(
            state_bits=bits)
        st = TA.adamw_init(params, tcfg)
        sh = TA.state_shapes(params, tcfg)
        real = [(tuple(t.shape), t.dtype) for t in jax.tree.leaves(
            tuple(st), is_leaf=lambda x: isinstance(x, torch.Tensor))]
        want = [(s.shape, s.dtype) for s in jax.tree.leaves(
            tuple(sh), is_leaf=lambda x: isinstance(x, TA.ShapeDtype))]
        assert real == want
        ref = RA.state_shapes(jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), rparams), rcfg)
        assert [(tuple(s.shape), jnp.dtype(s.dtype).name)
                for s in jax.tree.leaves(ref)] == [
            (s, str(d).removeprefix("torch.")) for s, d in want]


def test_warmup_cosine_matches_the_reference():
    for total, warmup in ((100, 20), (120, 0), (50, 10)):
        for s in range(121):
            got = float(t_warmup_cosine(s, warmup=warmup, total=total))
            want = float(r_warmup_cosine(s, warmup=warmup, total=total))
            assert abs(got - want) <= 1e-6, (s, warmup, total, got, want)
    assert float(t_warmup_cosine(0, warmup=10, total=100)) == 0.0
    assert abs(float(t_warmup_cosine(10, warmup=10, total=100)) - 1.0) < 1e-6
    assert float(t_warmup_cosine(100, warmup=10, total=100)) <= 0.11


@pytest.mark.parametrize("bits", [32, 8])
def test_opt_state_carried_across_bit_for_bit(bits):
    """The reference's AdamWState (after two updates, so the moments are
    not zero) into the port and back."""
    rng = np.random.default_rng(11)
    cfg = RA.AdamWConfig(state_bits=bits)
    rp = _tree(lambda s: jnp.asarray(rng.standard_normal(s).astype(
        np.float32)))
    rs = RA.adamw_init(rp, cfg)
    for _ in range(2):
        g = _tree(lambda s: jnp.asarray(rng.standard_normal(s).astype(
            np.float32)))
        rp, rs = RA.adamw_update(rp, g, rs, cfg)
    host = _host(rs)
    ts = opt_state_from_numpy(host, "cpu")
    assert isinstance(ts, TA.AdamWState) and ts.step.dtype == torch.int32
    back = RA.AdamWState(*opt_state_to_numpy(ts))
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- the reference's convergence tests, mirrored ------------------------------

def _quadratic_losses(bits, steps=60):
    target = torch.tensor([1.5, -2.0, 0.5, 3.0])
    params = {"w": torch.zeros((4,), dtype=torch.float32)}
    cfg = TA.AdamWConfig(lr=0.05, weight_decay=0.0, state_bits=bits)
    state = TA.adamw_init(params, cfg)
    losses = []
    for _ in range(steps):
        w = params["w"].detach().requires_grad_()
        loss = torch.sum((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, state = TA.adamw_update(params, {"w": g}, state, cfg)
        losses.append(float(loss.detach()))
    return losses


def test_adamw_converges_f32():
    losses = _quadratic_losses(32)
    assert losses[-1] < losses[0] * 0.05


def test_adamw_converges_int8():
    """8-bit moments track the f32 trajectory closely on a quadratic."""
    l32 = _quadratic_losses(32)
    l8 = _quadratic_losses(8)
    assert l8[-1] < l8[0] * 0.10
    assert abs(l8[-1] - l32[-1]) < 0.5
