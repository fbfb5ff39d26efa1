"""The port's training path against the reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages; the
reference's random weights (``repro.models.model.init``) are carried
across with ``params_from_numpy``, its optimizer state with
``opt_state_from_numpy``. The port runs its kernels' plain versions (the
head shuffle and ``PermuteLayer`` on the ``cuda`` engine with CPU
tensors), the reference ``engine="ref"`` and, where its own test does,
``"pallas"`` in interpret mode. Tolerances:

* the loss and the step's metrics: ``METRIC_TOL`` = 1e-5 absolute and
  relative (both sum the same float32 products in other orders: about
  1e-7 observed);
* gradients: ``GRAD_REL_TOL`` = 1e-5, norm-wise per leaf;
* parameters after one step: 1e-6 absolute where the reference's
  gradient is above ``GRAD_FLOOR`` = 1e-6 (100 times Adam's eps). The
  first update is ``lr * g / (|g| + eps)``: near zero an ulp in a
  gradient flips its sign and moves the parameter by up to ``2 * lr``,
  so elements whose gradient is that small are left out;
* per-step losses of twelve steps of the ``smoke`` profile: 1e-4;
* within the port (remat policies, shuffle engines, resume): bit for bit.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.combinators.sort import sort_expr as r_sort_expr
from repro.configs import get_config as ref_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.core.bmmc import Bmmc as RBmmc
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import ShardedLoader as RLoader
from repro.launch import train as RLT
from repro.models import model as RM
from repro.models.permute import PermuteLayer as RPermuteLayer
from repro.optim.adamw import AdamWConfig as RAdamWConfig
from repro.optim.adamw import adamw_init as r_adamw_init
from repro.train import step as RS
from repro_torch import guard, obs
from repro_torch.combinators import execute as pex
from repro_torch.combinators.execute import FusedStage
from repro_torch.combinators.sort import sort_expr as t_sort_expr
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core.bmmc import Bmmc as TBmmc
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.guard.errors import CachePoisoned, GuardTrap
from repro_torch.kernels.ops import choose_tile
from repro_torch.launch import train as TLT
from repro_torch.models import model as TM
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.permute import PermuteLayer as TPermuteLayer
from repro_torch.optim.adamw import AdamWConfig as TAdamWConfig
from repro_torch.optim.adamw import adamw_init as t_adamw_init
from repro_torch.resilience import policy as rpolicy
from repro_torch.train import step as TS
from repro_torch.tree import tree_leaves

METRIC_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_TOL = 1e-5
GRAD_FLOOR = 1e-6
B, S = 2, 16


def _configs(arch="mistral-nemo-12b", **repl):
    r = ref_reduce(ref_config(arch))
    t = t_reduce(t_config(arch))
    if repl:
        r = dataclasses.replace(r, **repl)
        t = dataclasses.replace(t, **repl)
    return r, t


def _carry(rparams):
    return params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")


def _batch(cfg, seed):
    """(reference batch, port batch): tokens and labels, and source
    embeddings for encoder-decoder and VLM configurations."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    rb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok).long(),
          "labels": torch.from_numpy(lab).long()}
    if cfg.is_encdec or cfg.family == "vlm":
        src = rng.standard_normal((B, cfg.src_len, cfg.d_model)).astype(
            np.float32)
        rb["src"] = jnp.asarray(src)
        tb["src"] = torch.from_numpy(src)
    return rb, tb


def _t_grads(tcfg, tparams, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tparams)]
    live = jax.tree.unflatten(jax.tree.structure(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)), leaves)
    loss, parts = TM.loss_fn(tcfg, live, batch)
    return loss, parts, torch.autograd.grad(loss, leaves)


def _clone(tree):
    return jax.tree.map(lambda t: t.clone(), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _x(n, seed, shape=()):
    return np.random.default_rng(seed).normal(
        size=shape + (1 << n,)).astype(np.float32)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def test_loss_fn_and_gradients_match_the_reference():
    rcfg, tcfg = _configs()
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))
    rb, tb = _batch(rcfg, 1)
    (rloss, rparts), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, rb), has_aux=True)(rparams)
    tloss, tparts, tgrads = _t_grads(tcfg, _carry(rparams), tb)
    np.testing.assert_allclose(float(tloss.detach()), float(rloss),
                               **METRIC_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tparts[k].detach()),
                                   float(rparts[k]),
                                   **METRIC_TOL)
    rleaves = jax.tree.leaves(rgrads)
    assert len(rleaves) == len(tgrads)
    for a, b in zip(rleaves, tgrads):
        a = np.asarray(a)
        rel = np.linalg.norm(b.numpy() - a) / max(np.linalg.norm(a), 1e-30)
        assert rel <= GRAD_REL_TOL, rel


# ---------------------------------------------------------------------------
# one full step
# ---------------------------------------------------------------------------

def test_train_step_matches_the_reference():
    rcfg, tcfg = _configs()
    rparams = RM.init(rcfg, jax.random.PRNGKey(2))
    rb, tb = _batch(rcfg, 3)
    rstate = RS.init_opt(rcfg, rparams)
    rgrads = jax.grad(lambda p: RM.loss_fn(rcfg, p, rb)[0])(rparams)
    rstep, _ = RS.make_train_step(rcfg)
    rnew, rnstate, rm = jax.jit(rstep)(rparams, rstate, rb)

    tparams = _carry(rparams)
    tstate = opt_state_from_numpy(jax.tree.map(np.asarray, rstate), "cpu")
    tstep, opt_cfg = TS.make_train_step(tcfg)
    assert opt_cfg == TAdamWConfig(state_bits=tcfg.opt_bits)
    tnew, tnstate, tm = tstep(tparams, tstate, tb)
    assert tnew is tparams                          # updated in place
    assert set(tm) == set(rm) == {"loss", "ce", "aux", "grad_norm"}
    for k in rm:
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), **METRIC_TOL)
    assert int(tnstate.step) == int(rnstate.step) == 1
    kept = 0
    for a, b, g in zip(jax.tree.leaves(rnew), tree_leaves(tnew),
                       jax.tree.leaves(rgrads)):
        big = np.abs(np.asarray(g)) > GRAD_FLOOR
        kept += big.sum()
        np.testing.assert_allclose(b.numpy()[big], np.asarray(a)[big],
                                   rtol=0, atol=1e-6)
    # the check covers most of the model (86 % of its elements here)
    assert kept > 0.8 * sum(np.asarray(g).size
                            for g in jax.tree.leaves(rgrads))


@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_arch_train_step(arch):
    """The reference's ``test_arch_train_step``, mirrored for each of the
    ten configurations (every block kind)."""
    cfg = t_reduce(t_config(arch))
    params = TM.init(cfg, torch.Generator().manual_seed(1))
    before = _clone(params)
    opt_state = TS.init_opt(cfg, params)
    step_fn, _ = TS.make_train_step(cfg)
    _, tb = _batch(cfg, 1)
    new_params, new_state, metrics = step_fn(params, opt_state, tb)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_state.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(before), tree_leaves(new_params))), arch


def _open_gates(rparams):
    """VLM cross blocks start with tanh(0) = 0 gates; open them to 0.5 so
    the cross-attention reaches the loss."""
    for name, p in rparams["stack"].get("scan", {}).items():
        if name.endswith("_cross"):
            p["attn_gate"] = jnp.full_like(p["attn_gate"], 0.5)
            p["mlp_gate"] = jnp.full_like(p["mlp_gate"], 0.5)
    return rparams


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-130m",
                                  "seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_loss_and_gradients_of_the_other_families(arch, monkeypatch):
    """``test_loss_fn_and_gradients_match_the_reference`` for an MoE
    (with its aux loss), an SSM, an encoder-decoder and a VLM (gates
    opened) configuration: loss and parts within METRIC_TOL, every leaf's
    gradient within GRAD_REL_TOL norm-wise. Every routing decision of the
    MoE configuration clears a top-k margin of 1e-6 in the reference (the
    packages' float32 softmaxes may differ by an ulp)."""
    from repro.models import moe as RMoE
    margins = []
    real = RMoE.router_topk

    def spy(logits, k):
        top = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1),
                            k + 1)[0]
        jax.debug.callback(lambda m: margins.append(float(np.min(m))),
                           top[..., k - 1] - top[..., k])
        return real(logits, k)

    monkeypatch.setattr(RMoE, "router_topk", spy)
    rcfg, tcfg = _configs(arch)
    rparams = _open_gates(RM.init(rcfg, jax.random.PRNGKey(0)))
    rb, tb = _batch(rcfg, 1)
    (rloss, rparts), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(rcfg, p, b), has_aux=True))(rparams, rb)
    tloss, tparts, tgrads = _t_grads(tcfg, _carry(rparams), tb)
    np.testing.assert_allclose(float(tloss.detach()), float(rloss),
                               **METRIC_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tparts[k].detach()),
                                   float(rparts[k]), **METRIC_TOL)
    jax.effects_barrier()
    if rcfg.n_experts:
        assert float(rparts["aux"]) > 0
        assert margins and min(margins) > 1e-6
    rleaves = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    assert len(rleaves) == len(tgrads)
    for (path, a), b in zip(rleaves, tgrads):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and b.shape == a.shape
        rel = np.linalg.norm(b.numpy() - a) / max(np.linalg.norm(a), 1e-30)
        assert rel <= GRAD_REL_TOL, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("arch,bits", [("llama-3.2-vision-90b", 8),
                                       ("phi3.5-moe-42b-a6.6b", 32),
                                       ("mamba2-130m", 8)])
def test_bf16_step_keeps_float32_leaves(arch, bits):
    """A bfloat16 model with float32 leaves (router, SSM parameters, the
    VLM's ``(1,)`` gates: smaller than one 8-bit block) takes a step: each
    leaf keeps its type, the state has the reference's shapes and types,
    every float32 leaf moves (a bfloat16 leaf of ones may round back), the
    metrics are finite."""
    rcfg = dataclasses.replace(ref_reduce(ref_config(arch)),
                               dtype=jnp.bfloat16, opt_bits=bits)
    tcfg = dataclasses.replace(t_reduce(t_config(arch)),
                               dtype=torch.bfloat16, opt_bits=bits)
    params = TM.init(tcfg, torch.Generator().manual_seed(2))
    before = _clone(params)
    dtypes = [t.dtype for t in tree_leaves(params)]
    assert torch.float32 in dtypes and torch.bfloat16 in dtypes
    state = TS.init_opt(tcfg, params)
    rstate = jax.eval_shape(lambda: RS.init_opt(
        rcfg, RM.init(rcfg, jax.random.PRNGKey(0))))
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in tree_leaves(state.m) + tree_leaves(state.v)]
    want = [(tuple(a.shape), str(a.dtype))
            for a in jax.tree.leaves(rstate.m) + jax.tree.leaves(rstate.v)]
    assert got == want
    _, tb = _batch(tcfg, 3)
    if "src" in tb:
        tb["src"] = tb["src"].to(torch.bfloat16)
    step_fn, _ = TS.make_train_step(tcfg)
    new, st, m = step_fn(params, state, tb)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert int(st.step) == 1
    assert [t.dtype for t in tree_leaves(new)] == dtypes
    moved = [(t.dtype, not torch.equal(a, t)) for a, t in zip(
        tree_leaves(before), tree_leaves(new))]
    assert all(mv for dt, mv in moved if dt == torch.float32)
    assert any(mv for dt, mv in moved if dt == torch.bfloat16)


@pytest.mark.parametrize("lr,forced", [(3e-4, False), (1e-2, True)])
def test_eight_bit_steps_of_a_vlm_follow_the_reference(lr, forced):
    """Three steps of llama-vision with 8-bit moments on one batch, in both
    packages: the chip run's 8-bit cell, at smoke size. The leaves are
    float32 (in bfloat16 the packages' forwards round apart by about 4e-4
    in the first loss, before any update). A gradient an ulp apart near 0
    flips the sign of Adam's first update of that entry (lr * g / (|g| +
    eps)), and can move an int8 moment by one step. At the default lr the
    port runs on its own, and each step's loss is within METRIC_TOL of the
    reference's (the grad_norm, which those few entries reach, is not). At
    lr 1e-2 the reference's loss rises at the third step, and there those
    roundings carry the two runs apart, so each port step starts from the
    reference's parameters and state, and its loss and grad_norm are held
    to the reference's step by step."""
    rcfg, tcfg = _configs("llama-3.2-vision-90b", opt_bits=8)
    ropt = RAdamWConfig(lr=lr, state_bits=8)
    rparams = _open_gates(RM.init(rcfg, jax.random.PRNGKey(0)))
    rstate = RS.init_opt(rcfg, rparams, ropt)
    rb, tb = _batch(rcfg, 5)
    rstep = jax.jit(RS.make_train_step(rcfg, opt_cfg=ropt)[0])
    tstep, _ = TS.make_train_step(tcfg, opt_cfg=TAdamWConfig(
        lr=lr, state_bits=8))
    tparams = _carry(rparams)
    tstate = opt_state_from_numpy(jax.tree.map(np.asarray, rstate), "cpu")
    losses = []
    for _ in range(3):
        if forced:
            tparams = _carry(rparams)
            tstate = opt_state_from_numpy(
                jax.tree.map(np.asarray, rstate), "cpu")
        rparams, rstate, rm = rstep(rparams, rstate, rb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        for k in ("loss", "grad_norm") if forced else ("loss",):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]),
                                       **METRIC_TOL)
        losses.append(float(rm["loss"]))
    assert int(tstate.step) == int(rstate.step) == 3
    if forced:
        assert losses[2] > losses[1], losses
    else:
        assert losses[2] < losses[1] < losses[0], losses


# ---------------------------------------------------------------------------
# the head shuffle and remat inside the step
# ---------------------------------------------------------------------------

def test_train_step_with_head_shuffle_equals_shuffle_off():
    """The reference's ``test_model_train_step_with_head_shuffle_cfg``,
    mirrored: the loss is bit-equal with the shuffle on and off; the step
    with the shuffle on is bit-equal on the ``cuda`` engine (plain
    versions here) and on ``ref``."""
    tcfg0 = t_reduce(t_config("mistral-nemo-12b"))
    tcfg0 = dataclasses.replace(tcfg0, n_kv_heads=4, n_heads=4)
    params = TM.init(tcfg0, torch.Generator().manual_seed(3))
    _, tb = _batch(tcfg0, 4)
    out = {}
    for eng in (None, "ref", "cuda"):
        c = dataclasses.replace(tcfg0, head_shuffle=eng)
        with torch.no_grad():
            l, _ = TM.loss_fn(c, params, tb)
        p = _clone(params)
        step_fn, _ = TS.make_train_step(c)
        _, _, m = step_fn(p, TS.init_opt(c, p), tb)
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
        out[eng] = (l, m, p)
    assert torch.equal(out[None][0], out["cuda"][0])
    assert torch.equal(out["ref"][0], out["cuda"][0])
    for k in ("loss", "grad_norm"):
        assert torch.equal(out["ref"][1][k], out["cuda"][1][k])
    for a, b in zip(tree_leaves(out["ref"][2]), tree_leaves(out["cuda"][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shuffle", [None, "cuda"])
def test_remat_policies_are_bit_equal(shuffle):
    """Remat off, ``nothing`` and ``dots``: the same loss and gradients,
    bit for bit; with the shuffle on ``cuda`` each layer dispatches the
    kv-head shuffle 8 times a step without remat (4 forward, 4 VJPs) and
    12 with it (the checkpointed body runs its 4 again)."""
    base = t_reduce(t_config("mistral-nemo-12b"))
    base = dataclasses.replace(base, n_kv_heads=4, n_heads=4,
                               head_shuffle=shuffle)
    params = TM.init(base, torch.Generator().manual_seed(5))
    _, tb = _batch(base, 6)
    got = {}
    for name, repl in (("off", dict(remat=False)),
                       ("nothing", dict(remat=True, remat_policy="nothing")),
                       ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(base, **repl)
        obs.reset()
        obs.enable(sync=False)
        try:
            loss, _, grads = _t_grads(c, params, tb)
            shuffles = sum(obs.kernel_counts().values())
        finally:
            obs.disable()
            obs.reset()
        per_layer = {"off": 8}.get(name, 12) if shuffle else 0
        assert shuffles == per_layer * c.n_layers, (name, shuffles)
        got[name] = (loss, grads)
    for name in ("nothing", "dots"):
        assert torch.equal(got[name][0], got["off"][0])
        for a, b in zip(got[name][1], got["off"][1]):
            assert torch.equal(a, b)


def test_remat_policy_must_be_known():
    c = dataclasses.replace(t_reduce(t_config("mistral-nemo-12b")),
                            remat=True, remat_policy="everything")
    params = TM.init(c, torch.Generator().manual_seed(0))
    _, tb = _batch(c, 0)
    with pytest.raises(ValueError, match="remat_policy"):
        _t_grads(c, params, tb)


# ---------------------------------------------------------------------------
# loss overrides through a PermuteLayer
# ---------------------------------------------------------------------------

def _override_step(make_loss, n, params, batch, *, grad_accum=1, port):
    if port:
        cfg = t_reduce(t_config("mistral-nemo-12b"))
        step_fn, opt_cfg = TS.make_train_step(
            cfg, opt_cfg=TAdamWConfig(), loss_fn=make_loss,
            grad_accum=grad_accum)
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        new, _, m = step_fn(p, t_adamw_init(p, opt_cfg), b)
        return new["w"].numpy(), {k: float(v) for k, v in m.items()}
    cfg = ref_reduce(ref_config("mistral-nemo-12b"))
    step_fn, opt_cfg = RS.make_train_step(
        cfg, opt_cfg=RAdamWConfig(), loss_fn=make_loss, grad_accum=grad_accum)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    new, _, m = jax.jit(step_fn)(p, r_adamw_init(p, opt_cfg), b)
    return np.asarray(new["w"]), {k: float(v) for k, v in m.items()}


def _mse_loss(layer, mean):
    def loss_fn(params, batch):
        pred = layer(batch["x"] * params["w"])
        l = mean((pred - batch["y"]) ** 2)
        return l, {"mse": l}
    return loss_fn


@pytest.mark.parametrize("ref_engine", ["ref", "pallas"])
def test_loss_override_through_a_permute_layer(ref_engine):
    """The reference's ``test_train_step_grad_through_pallas_permute``
    (a random BMMC on 2^10 float32 elements, batch 4) against the port's
    step with the layer on the ``cuda`` engine: grad_norm within 1e-6
    relative, new ``w`` within 1e-6."""
    n = 10
    params = {"w": _x(n, 22)}
    batch = {"x": _x(n, 23, shape=(4,)), "y": _x(n, 24, shape=(4,))}
    rb = RBmmc.random(n, random.Random(21))
    tb = TBmmc.random(n, random.Random(21))
    assert tuple(rb.rows) == tuple(tb.rows) and rb.c == tb.c
    rw, rm = _override_step(_mse_loss(RPermuteLayer(rb, axis=1,
                                                    engine=ref_engine),
                                      jnp.mean), n, params, batch, port=False)
    tw, tm = _override_step(_mse_loss(TPermuteLayer(tb, axis=1,
                                                    engine="cuda"),
                                      torch.mean), n, params, batch, port=True)
    assert np.isfinite(tm["loss"]) and tm["grad_norm"] > 0
    assert not np.array_equal(tw, params["w"])
    np.testing.assert_allclose(tm["grad_norm"], rm["grad_norm"], rtol=1e-6)
    np.testing.assert_allclose(tm["loss"], rm["loss"], rtol=1e-6)
    np.testing.assert_allclose(tw, rw, atol=1e-6, rtol=0)


def test_loss_override_with_grad_accum():
    """The reference's ``test_train_step_loss_override_with_grad_accum``,
    mirrored: a tokens-free loss under accumulation matches the
    unaccumulated step; both match the reference's accumulated step."""
    n = 8
    params = {"w": _x(n, 32)}
    batch = {"x": _x(n, 33, shape=(4,)), "y": _x(n, 34, shape=(4,))}
    tlayer = TPermuteLayer(TBmmc.random(n, random.Random(31)), axis=1,
                           engine="cuda")
    rlayer = RPermuteLayer(RBmmc.random(n, random.Random(31)), axis=1,
                           engine="ref")
    outs = {a: _override_step(_mse_loss(tlayer, torch.mean), n, params,
                              batch, grad_accum=a, port=True)
            for a in (1, 2)}
    np.testing.assert_allclose(outs[1][0], outs[2][0], atol=1e-6)
    assert set(outs[2][1]) == {"loss", "mse", "grad_norm"}
    rw, rm = _override_step(_mse_loss(rlayer, jnp.mean), n, params, batch,
                            grad_accum=2, port=False)
    np.testing.assert_allclose(outs[2][0], rw, atol=1e-6)
    for k in rm:
        np.testing.assert_allclose(outs[2][1][k], rm[k], rtol=1e-6)


def test_sort_layer_step_matches_the_reference(monkeypatch):
    """The CPU twin of the card's K5-inside-a-step check: a
    ``PermuteLayer(sort_expr(8))`` in a loss override, float32 keys
    without ties; on the port's ``cuda`` engine the forward runs the
    fused sort clusters (K4b's plain version) and the backward one K5
    pass (plain version) per compute cluster. Loss, grad_norm and new
    ``w`` within 1e-6 of the reference's step (engine ``ref``)."""
    n = 8
    params = {"w": _x(n, 42)}
    batch = {"x": _x(n, 43, shape=(4,)), "y": _x(n, 44, shape=(4,))}
    assert len(np.unique(batch["x"] * params["w"])) == 4 << n   # no ties
    tlayer = TPermuteLayer(t_sort_expr(n), axis=1, engine="cuda")
    real, k5 = pex._fused_bwd_cuda, []

    def spy(fs, *a):
        k5.append(fs)
        return real(fs, *a)

    monkeypatch.setattr(pex, "_fused_bwd_cuda", spy)
    tw, tm = _override_step(_mse_loss(tlayer, torch.mean), n, params,
                            batch, port=True)
    clusters = [st for st in tlayer.compiled.clustered_program(
        n, choose_tile(n, 4)) if isinstance(st, FusedStage) and st.computes]
    assert k5 == clusters[::-1] and clusters       # one K5 pass a cluster
    rw, rm = _override_step(_mse_loss(RPermuteLayer(r_sort_expr(n), axis=1,
                                                    engine="ref"), jnp.mean),
                            n, params, batch, port=False)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[k], rm[k], rtol=1e-6, atol=0)
    np.testing.assert_allclose(tw, rw, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the guarded step and telemetry
# ---------------------------------------------------------------------------

def test_guarded_step_equals_unguarded_and_traps_a_nonfinite_loss():
    cfg = dataclasses.replace(t_reduce(t_config("mistral-nemo-12b")),
                              n_kv_heads=4, n_heads=4, head_shuffle="cuda")
    params = TM.init(cfg, torch.Generator().manual_seed(7))
    _, tb = _batch(cfg, 8)
    plain_step, _ = TS.make_train_step(cfg)
    guarded_step, _ = TS.make_train_step(cfg, validate=True)
    p0, p1 = _clone(params), _clone(params)
    guard.reset_stats()
    _, _, m0 = plain_step(p0, TS.init_opt(cfg, p0), tb)
    _, _, m1 = guarded_step(p1, TS.init_opt(cfg, p1), tb)
    assert sum(guard.stats()["traps"].values()) == 0
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    # a poisoned final_scale makes the loss nonfinite: GuardTrap, and the
    # update never ran
    bad = _clone(params)
    bad["final_scale"].fill_(float("nan"))
    kept = _clone(bad)
    st = TS.init_opt(cfg, bad)
    with pytest.raises(GuardTrap) as ei:
        guarded_step(bad, st, tb)
    assert ei.value.kinds == ("nonfinite",) and ei.value.engine == "train"
    assert int(st.step) == 0
    for a, b in zip(tree_leaves(bad), tree_leaves(kept)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert guard.stats()["traps"].get(("nonfinite", "train")) == 1
    guard.reset_stats()


def test_grad_accum_refuses_a_ragged_batch():
    """A batch of 5 rows with ``grad_accum=2`` and a loss override: both
    packages refuse it (the reference's reshape to ``(2, 2, ...)`` fails)
    rather than drop the last row."""
    def t_loss(params, batch):
        l = torch.mean((params["w"] * batch["x"]) ** 2)
        return l, {"mse": l}

    def r_loss(params, batch):
        l = jnp.mean((params["w"] * batch["x"]) ** 2)
        return l, {"mse": l}

    x = _x(3, 61, shape=(5,))
    rcfg, tcfg = _configs()
    step, oc = TS.make_train_step(tcfg, opt_cfg=TAdamWConfig(),
                                  loss_fn=t_loss, grad_accum=2)
    p = {"w": torch.ones(8)}
    with pytest.raises(ValueError, match="grad_accum=2"):
        step(p, t_adamw_init(p, oc), {"x": torch.from_numpy(x)})
    assert torch.equal(p["w"], torch.ones(8))
    rstep, roc = RS.make_train_step(rcfg, opt_cfg=RAdamWConfig(),
                                    loss_fn=r_loss, grad_accum=2)
    rp = {"w": jnp.ones(8)}
    with pytest.raises(TypeError, match="reshape"):
        rstep(rp, r_adamw_init(rp, roc), {"x": jnp.asarray(x)})


@pytest.mark.parametrize("case", ["nan", "ragged"])
def test_a_trapped_step_records_its_time(case):
    """Under ``validate=True`` both packages record the step's
    ``train.step`` span either way. A NaN batch raises ``GuardTrap`` after
    one ``('train.step_us', ())`` observation in both; a batch of 5 rows
    with ``grad_accum=2`` raises before the step records any time."""
    from repro import guard as rguard
    from repro import obs as robs

    def t_loss(params, batch):
        l = torch.mean((params["w"] * batch["x"]) ** 2)
        return l, {"mse": l}

    def r_loss(params, batch):
        l = jnp.mean((params["w"] * batch["x"]) ** 2)
        return l, {"mse": l}

    if case == "nan":
        x = _x(3, 62, shape=(2,))
        x[0, 0] = np.nan
        accum, errs, want = 1, (GuardTrap, rguard.GuardTrap), 1
    else:
        x = _x(3, 61, shape=(5,))
        accum, errs, want = 2, (ValueError, TypeError), 0
    rcfg, tcfg = _configs()
    step, oc = TS.make_train_step(tcfg, opt_cfg=TAdamWConfig(),
                                  loss_fn=t_loss, validate=True,
                                  grad_accum=accum)
    rstep, roc = RS.make_train_step(rcfg, opt_cfg=RAdamWConfig(),
                                    loss_fn=r_loss, validate=True,
                                    grad_accum=accum)
    got = {}
    for name, o, run, err in (
            ("port", obs, lambda: step({"w": torch.ones(8)}, t_adamw_init(
                {"w": torch.ones(8)}, oc), {"x": torch.from_numpy(x)}),
             errs[0]),
            ("ref", robs, lambda: rstep({"w": jnp.ones(8)}, r_adamw_init(
                {"w": jnp.ones(8)}, roc), {"x": jnp.asarray(x)}),
             errs[1])):
        o.reset()
        o.enable(sync=True)
        try:
            with pytest.raises(err):
                run()
            got[name] = (
                sum(v["count"] for k, v in o.histograms().items()
                    if k == ("train.step_us", ())),
                sum(e.get("name") == "train.step" for e in o.events()))
        finally:
            o.disable()
            o.reset()
    guard.reset_stats()
    rguard.reset_stats()
    assert got["port"] == got["ref"] == (want, 1)


def test_guarded_step_retries_a_retryable_guard_error():
    calls = {"n": 0}

    def flaky_loss(params, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise CachePoisoned("poisoned plan cache (injected)")
        l = torch.mean((params["w"] * batch["x"]) ** 2)
        return l, {"mse": l}

    cfg = t_reduce(t_config("mistral-nemo-12b"))
    step_fn, opt_cfg = TS.make_train_step(cfg, opt_cfg=TAdamWConfig(),
                                          loss_fn=flaky_loss, validate=True)
    p = {"w": torch.ones(8)}
    rpolicy.reset_stats()
    _, st, m = step_fn(p, t_adamw_init(p, opt_cfg), {"x": torch.ones(2, 8)})
    assert calls["n"] == 2 and rpolicy.stats()["retries"] == 1
    assert int(st.step) == 1 and np.isfinite(float(m["loss"]))
    # no retries left: the error propagates
    calls["n"] = 0
    step0, _ = TS.make_train_step(cfg, opt_cfg=TAdamWConfig(),
                                  loss_fn=flaky_loss, validate=True,
                                  trap_retries=0)
    with pytest.raises(CachePoisoned):
        step0(p, t_adamw_init(p, opt_cfg), {"x": torch.ones(2, 8)})
    rpolicy.reset_stats()


def test_train_step_telemetry_names():
    n = 8
    layer = TPermuteLayer(TBmmc.random(n, random.Random(51)), axis=1,
                          engine="cuda")
    cfg = t_reduce(t_config("mistral-nemo-12b"))
    step_fn, opt_cfg = TS.make_train_step(
        cfg, opt_cfg=TAdamWConfig(), loss_fn=_mse_loss(layer, torch.mean))
    p = {"w": torch.from_numpy(_x(n, 52))}
    b = {"x": torch.from_numpy(_x(n, 53, shape=(4,))),
         "y": torch.from_numpy(_x(n, 54, shape=(4,)))}
    obs.reset()
    obs.enable(sync=True)
    try:
        step_fn(p, t_adamw_init(p, opt_cfg), b)
        hist = {nm for (nm, _) in obs.histograms()}
        ctr = {nm for (nm, _) in obs.counters()}
        spans = [e for e in obs.events() if e.get("name") == "train.step"]
    finally:
        obs.disable()
        obs.reset()
    assert {"train.step_us", "train.permute_share"} <= hist
    assert {"train.permute_round_trips",
            "train.permute_vjp_round_trips"} <= ctr
    assert len(spans) == 1 and spans[0]["args"]["dur_us"] > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_loop_matches_the_reference_loop():
    """``launch.train.train`` from the reference's parameters (carried
    across) and the same loader state against the reference's loop body
    (``jit_step`` over ``next(loader)``) for 12 steps of the ``smoke``
    profile: per-step losses within 1e-4."""
    steps = 12
    rcfg = RLT.profile_config("smoke")
    tcfg = TLT.profile_config("smoke")
    args = TLT.parse_args(["--device", "cpu", "--steps", str(steps),
                           "--log-every", "100"])
    rparams = RM.init(rcfg, jax.random.PRNGKey(args.seed))
    tparams = _carry(rparams)
    rstep, _ = RS.make_train_step(rcfg)
    jit_step = jax.jit(rstep)
    rstate = RS.init_opt(rcfg, rparams)
    rloader = RLoader(RDataConfig(n_samples_log2=16, seq_len=args.seq,
                                  vocab_size=rcfg.vocab_size,
                                  seed=args.seed), batch_size=args.batch)
    want = []
    for _ in range(steps):
        batch = {k: jnp.asarray(v) for k, v in next(rloader).items()}
        rparams, rstate, m = jit_step(rparams, rstate, batch)
        want.append(float(m["loss"]))
    loader = ShardedLoader(DataConfig(n_samples_log2=16, seq_len=args.seq,
                                      vocab_size=tcfg.vocab_size,
                                      seed=args.seed), batch_size=args.batch)
    res = TLT.train(tcfg, tparams, TS.init_opt(tcfg, tparams), loader, args)
    assert res.start == 0 and len(res.step_s) == steps
    np.testing.assert_allclose(res.losses, want, rtol=0, atol=1e-4)
    assert res.losses[-1] < res.losses[0]
    assert loader.state() == rloader.state()


def test_main_kill_and_resume_consumes_the_remaining_samples(tmp_path,
                                                             capsys):
    """``examples/train_lm.py``'s pattern: ``main`` to step 6 with a
    checkpoint every 3, then a fresh ``main`` to 12 resumes at step 6.
    Its losses equal those of steps 6-11 of an uninterrupted run bit for
    bit, so it restored the parameters, the optimizer state and the
    loader's position exactly."""
    common = ["--device", "cpu", "--ckpt-every", "3", "--log-every", "100"]
    whole = TLT.main(common[:2] + ["--steps", "12"])
    d = str(tmp_path / "ckpt")
    first = TLT.main(common + ["--steps", "6", "--ckpt-dir", d])
    assert first.start == 0 and len(first.save_s) == 2
    second = TLT.main(common + ["--steps", "12", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 6 (epoch=0, loader step=6)" in out
    assert "checkpointed -> " in out
    assert second.start == 6 and len(second.losses) == 6
    assert first.losses == whole.losses[:6]
    assert second.losses == whole.losses[6:]
    assert "loss: " in out and "(improved)" in out
