"""The port's language-model stack against the reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages; the
reference's own random weights (``repro.models.model.init``) are carried
across with ``params_from_numpy``. Tolerances:

* float32 (the smoke-reduced configurations): ``F32_TOL`` — both sum the
  same float32 products in different orders (observed about 2e-7 on
  logits of magnitude 1), so 1e-5 absolute and relative;
* bfloat16: ``BF16_TOL`` — every activation is rounded to 8 significant
  bits (2^-9 relative) at the same points, but products are summed in
  other orders, so a rounding can land one bfloat16 step apart (about
  4e-3 at magnitude 1) and carry through the layers; 2e-2 absolute;
* permutations (``permute_axis``, ``PermuteLayer``, the head shuffle's
  gathers): bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.core.bmmc import Bmmc as RBmmc
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import permute as RP
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core.bmmc import Bmmc as TBmmc
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import permute as TP
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (caches_from_numpy, caches_to_numpy,
                                        params_from_numpy)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_configs_match_the_reference(arch):
    """Every field but the dtype's type is the reference's, before and
    after the smoke reduction."""
    for r, t in ((ref_config(arch), t_config(arch)),
                 (ref_reduce(ref_config(arch)), t_reduce(t_config(arch)))):
        rd, td = dataclasses.asdict(r), dataclasses.asdict(t)
        assert jnp.dtype(rd.pop("dtype")).name == str(
            td.pop("dtype")).removeprefix("torch.")
        assert rd == td
        assert (r.n_params(), r.n_layers, r.hd) == (t.n_params(), t.n_layers,
                                                     t.hd)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_and_mlps_match_the_reference():
    rng = np.random.default_rng(0)
    x, sc, bi = _rand(rng, 2, 5, 16), _rand(rng, 16), _rand(rng, 16)
    wg, wu, wd = _rand(rng, 16, 24), _rand(rng, 16, 24), _rand(rng, 24, 16)
    bu, bd = _rand(rng, 24), _rand(rng, 16)
    np.testing.assert_allclose(
        _np(TL.rms_norm(_t(x), _t(sc))), _np(RL.rms_norm(x, sc)), **F32_TOL)
    np.testing.assert_allclose(
        _np(TL.layer_norm(_t(x), _t(sc), _t(bi))),
        _np(RL.layer_norm(x, sc, bi)), **F32_TOL)
    np.testing.assert_allclose(
        _np(TL.swiglu(_t(x), _t(wg), _t(wu), _t(wd))),
        _np(RL.swiglu(x, wg, wu, wd)), **F32_TOL)
    np.testing.assert_allclose(
        _np(TL.gelu_mlp(_t(x), _t(wu), _t(bu), _t(wd), _t(bd))),
        _np(RL.gelu_mlp(x, wu, bu, wd, bd)), **F32_TOL)


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5])
def test_rope_matches_the_reference(rotary_frac):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = np.arange(7, dtype=np.int32) + 5
    rd = int(16 * rotary_frac) if rotary_frac < 1.0 else None
    np.testing.assert_array_equal(TL.rope_freqs(16, 1e6, rd).numpy(),
                                  np.asarray(RL.rope_freqs(16, 1e6, rd)))
    got = TL.apply_rope(_t(x), _t(pos), 1e4, rd)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, rd)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    if rd:   # the features past the rotary dims pass through untouched
        np.testing.assert_array_equal(_np(got)[..., rd:], x[..., rd:])
    np.testing.assert_array_equal(
        _np(TL.causal_mask_bias(_t(pos), _t(pos), 3)),
        _np(RL.causal_mask_bias(jnp.asarray(pos), jnp.asarray(pos), 3)))


# ---------------------------------------------------------------------------
# permutations
# ---------------------------------------------------------------------------

def _bmmcs(n, seed):
    import random
    rb = RBmmc.random(n, random.Random(seed))
    return rb, TBmmc(rb.rows, rb.c)


@pytest.mark.parametrize("axis,shape", [(2, (3, 5, 8, 4)), (1, (6, 8)),
                                        (0, (16, 3))])
def test_permute_axis_and_layer_bit_for_bit(axis, shape):
    n = shape[axis].bit_length() - 1
    rb, tb = _bmmcs(n, 7 + axis)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(RP.permute_axis(jnp.asarray(x), rb, axis=axis,
                                      engine="ref"))
    for engine in ("ref", "cuda"):
        got = TP.permute_axis(_t(x), tb, axis=axis, engine=engine)
        np.testing.assert_array_equal(got.numpy(), want)
    layer = TP.PermuteLayer(tb, axis=axis)
    assert layer.engine == "cuda"
    rlayer = RP.PermuteLayer(rb, axis=axis, engine="ref")
    np.testing.assert_array_equal(layer(_t(x)).numpy(),
                                  np.asarray(rlayer(jnp.asarray(x))))
    np.testing.assert_array_equal(layer.inverse()(layer(_t(x))).numpy(), x)
    np.testing.assert_array_equal(
        layer.inverse()(_t(x)).numpy(),
        np.asarray(rlayer.inverse()(jnp.asarray(x))))


@pytest.mark.parametrize("shape,dtype", [((2, 6, 8, 16), "float32"),
                                         ((2, 6, 8, 2, 16), "bfloat16")])
def test_head_shuffle_bit_for_bit_against_the_reference_kernel(shape, dtype):
    """The kv-head shuffle of k/v (and of the q groups) on the port's
    ``cuda`` engine (the plain version of K4a here) against the
    reference's ``pallas`` engine (interpret mode), bit for bit."""
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    rx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    for rb, tb in ((RA.default_head_perm(8), TA.default_head_perm(8)),
                   (RA.default_head_perm(8).inverse(),
                    TA.default_head_perm(8).inverse())):
        want = np.asarray(RP.permute_axis(rx, rb, axis=2, engine="pallas"))
        got = TP.permute_axis(tx, tb, axis=2, engine="cuda")
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy(), want.view(np.int16 if dtype == "bfloat16"
                                else np.int32))


def test_permute_axis_gradient_matches_jax_grad():
    rb, tb = _bmmcs(3, 11)
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 4, 8, 6), _rand(rng, 4, 8, 6)
    want = jax.grad(lambda v: jnp.sum(
        jnp.asarray(w) * RP.permute_axis(v, rb, axis=1, engine="ref")))(
            jnp.asarray(x))
    for engine in ("ref", "cuda"):
        xt = _t(x).requires_grad_()
        (_t(w) * TP.permute_axis(xt, tb, axis=1, engine=engine)).sum(
        ).backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (h, kv, window, kv_block)
    (8, 8, None, 8), (8, 2, None, 16), (8, 4, 5, 8), (16, 8, None, 64)]


@pytest.mark.parametrize("h,kv,window,kv_block", ATTN_CASES)
def test_attention_matches_the_reference(h, kv, window, kv_block):
    rng = np.random.default_rng(4)
    b, s, d = 2, 16, 8
    q, k, v = _rand(rng, b, s, h, d), _rand(rng, b, s, kv, d), _rand(
        rng, b, s, kv, d)
    hp_r = RA.default_head_perm(kv)
    hp_t = TA.default_head_perm(kv)
    assert (hp_r is None) == (hp_t is None)
    want = np.asarray(RA.attention(q, k, v, window=window,
                                   kv_block=kv_block))
    got = TA.attention(_t(q), _t(k), _t(v), window=window, kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    if hp_t is not None:
        assert hp_t.rows == hp_r.rows and hp_t.c == hp_r.c
        for engine, r_engine in (("ref", "ref"), ("cuda", "pallas")):
            shuffled_r = np.asarray(RA.attention(
                q, k, v, window=window, kv_block=kv_block, head_perm=hp_r,
                head_perm_engine=r_engine))
            shuffled = TA.attention(_t(q), _t(k), _t(v), window=window,
                                    kv_block=kv_block, head_perm=hp_t,
                                    head_perm_engine=engine)
            # the shuffle is output-neutral in both packages
            np.testing.assert_array_equal(shuffled.numpy(), got.numpy())
            np.testing.assert_allclose(shuffled.numpy(), shuffled_r,
                                       **F32_TOL)
    # decode at the last position == the last row of causal attention
    t = s - 1
    want_d = np.asarray(RA.decode_attention(q[:, t:t + 1], k, v, t + 1,
                                            window=window))
    for hp, engine in ((None, "ref"), (hp_t, "ref"), (hp_t, "cuda")):
        got_d = TA.decode_attention(_t(q[:, t:t + 1]), _t(k), _t(v), t + 1,
                                    window=window, head_perm=hp,
                                    head_perm_engine=engine)
        np.testing.assert_allclose(got_d.numpy(), want_d, **F32_TOL)
        np.testing.assert_allclose(got_d.numpy()[:, 0], got.numpy()[:, t],
                                   **F32_TOL)


def test_attention_bf16_matches_the_reference():
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, 2, 16, 8, 16), _rand(rng, 2, 16, 4, 16),
               _rand(rng, 2, 16, 4, 16))
    rq, rk, rv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    want = RA.attention(rq, rk, rv, kv_block=8, head_perm=RA.default_head_perm(
        4), head_perm_engine="pallas")
    got = TA.attention(tq, tk, tv, kv_block=8,
                       head_perm=TA.default_head_perm(4),
                       head_perm_engine="cuda")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# the model: prefill + greedy decode from the reference's weights
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 12, 3


def _configs(arch, kv=None, shuffle=False, dtype=None):
    r, t = ref_reduce(ref_config(arch)), t_reduce(t_config(arch))
    rep = {}
    if kv:
        rep = dict(n_kv_heads=kv, n_heads=max(r.n_heads, kv))
    r = dataclasses.replace(r, head_shuffle="pallas" if shuffle else None,
                            **rep, **({"dtype": jnp.bfloat16} if dtype else {}))
    t = dataclasses.replace(t, head_shuffle="cuda" if shuffle else None,
                            **rep, **({"dtype": torch.bfloat16} if dtype
                                      else {}))
    return r, t


def _greedy_ref(cfg, params, toks):
    logits, caches = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks)})
    first = np.asarray(logits)
    caches = RM.grow_caches(caches, S, S + STEPS)
    out = []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, caches = RM.decode_step(cfg, params, caches, tok,
                                        jnp.int32(S + i))
    return first, np.concatenate(out, 1), np.asarray(logits)


def _greedy_port(cfg, params, toks):
    with torch.no_grad():
        logits, caches = TM.prefill(cfg, params,
                                    {"tokens": _t(toks).long()})
        first = _np(logits)
        caches = TM.grow_caches(caches, S, S + STEPS)
        out = []
        for i in range(STEPS):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(tok.numpy())
            logits, caches = TM.decode_step(cfg, params, caches, tok, S + i)
    return first, np.concatenate(out, 1), _np(logits)


@pytest.mark.parametrize("arch,kv,shuffle", [
    ("mistral-nemo-12b", 8, True), ("mistral-nemo-12b", 4, True),
    ("mistral-nemo-12b", None, False), ("starcoder2-7b", 4, True),
    ("chatglm3-6b", None, False)])
def test_prefill_and_decode_match_the_reference(arch, kv, shuffle):
    rcfg, tcfg = _configs(arch, kv, shuffle)
    params = RM.init(rcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size,
                                             (B, S)).astype(np.int32)
    r_first, r_ids, r_last = _greedy_ref(rcfg, params, toks)
    t_first, t_ids, t_last = _greedy_port(tcfg, tparams, toks)
    np.testing.assert_allclose(t_first, r_first, **F32_TOL)
    np.testing.assert_array_equal(t_ids, r_ids)
    np.testing.assert_allclose(t_last, r_last, **F32_TOL)


def test_prefill_bf16_matches_the_reference():
    rcfg, tcfg = _configs("mistral-nemo-12b", 8, True, dtype="bf16")
    params = RM.init(rcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(7).integers(0, rcfg.vocab_size,
                                             (B, S)).astype(np.int32)
    r_first, r_ids, _ = _greedy_ref(rcfg, params, toks)
    t_first, t_ids, _ = _greedy_port(tcfg, tparams, toks)
    assert t_first.dtype == np.float32      # logits stay float32
    np.testing.assert_allclose(t_first, r_first, **BF16_TOL)
    np.testing.assert_array_equal(t_ids, r_ids)


def test_decode_matches_prefill_continuation():
    """The port's counterpart of the reference's test of the same name:
    prefill(x[:t]) + decode(x[t]) == prefill(x[:t+1]), shuffle on."""
    _, cfg = _configs("mistral-nemo-12b", 8, True)
    params = TM.init(cfg, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full, _ = TM.prefill(cfg, params, {"tokens": toks})
        _, caches = TM.prefill(cfg, params, {"tokens": toks[:, :S - 1]})
        caches = TM.grow_caches(caches, S - 1, S)
        dec, _ = TM.decode_step(cfg, params, caches, toks[:, S - 1:], S - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_caches_carry_across_both_ways():
    """The reference's prefill caches, carried into the port, decode to the
    reference's logits; the port's caches come back equal to them."""
    rcfg, tcfg = _configs("mistral-nemo-12b", 4, True)
    params = RM.init(rcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(9).integers(0, rcfg.vocab_size,
                                             (B, S)).astype(np.int32)
    _, rc = RM.prefill(rcfg, params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        _, tc = TM.prefill(tcfg, tparams, {"tokens": _t(toks).long()})
    back = caches_to_numpy(tc)
    for key in ("k", "v"):
        np.testing.assert_allclose(back["scan"]["0_dense"][key],
                                   np.asarray(rc["scan"]["0_dense"][key]),
                                   **F32_TOL)
    rc = RM.grow_caches(rc, S, S + 1)
    tok = np.zeros((B, 1), np.int32)
    want, _ = RM.decode_step(rcfg, params, rc, jnp.asarray(tok),
                             jnp.int32(S))
    carried = caches_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    with torch.no_grad():
        got, _ = TM.decode_step(tcfg, tparams, carried, _t(tok).long(), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_params_from_numpy_is_bit_for_bit_on_bf16():
    rcfg, tcfg = _configs("mistral-nemo-12b", 8, False, dtype="bf16")
    params = jax.tree.map(np.asarray, RM.init(rcfg, jax.random.PRNGKey(4)))
    tparams = params_from_numpy(params, "cpu")
    r_leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    lm = TM.LM(tcfg, tparams)
    named = dict(lm.named_parameters())
    assert len(named) == len(r_leaves)
    for path, a in r_leaves:
        name = ".".join(p.key for p in path)
        t = named[name]            # the reference's path names, e.g.
        assert t.dtype == torch.bfloat16    # stack.scan.0_dense.wq
        assert t.requires_grad     # trainable leaves (the training path)
        np.testing.assert_array_equal(
            t.detach().view(torch.int16).numpy().view(np.uint16),
            a.view(np.uint16))
    assert "stack.scan.0_dense.wq" in named
    # the port's own init builds the same tree of the same shapes
    mine = TM.init(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), params) == jax.tree.map(
        lambda t: tuple(t.shape), {k: v for k, v in mine.items()},
        is_leaf=lambda v: isinstance(v, torch.Tensor))


# ---------------------------------------------------------------------------
# every block kind: the ten configurations
# ---------------------------------------------------------------------------

# The reference's top-k margin (k-th largest router probability less the
# (k+1)-th) that whole-model tests hold every routing decision to: the
# packages' float32 softmaxes may differ by an ulp (about 6e-8 at these
# sizes), so a closer call could route a token to another expert.
ROUTE_MARGIN = 1e-6


def _ref_margins(monkeypatch):
    """Record the reference's top-k margin of every routing call (inside
    its scans and vmaps, through ``jax.debug.callback``)."""
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
    return margins


def _model_inputs(cfg, seed, s=S):
    """Tokens and, for encoder-decoder and VLM configurations, source
    embeddings, as (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    if cfg.is_encdec or cfg.family == "vlm":
        src = jnp.asarray(rng.standard_normal(
            (B, cfg.src_len, cfg.d_model)).astype(np.float32), cfg.dtype)
        rb["src"] = src
        tb["src"] = params_from_numpy(np.asarray(src), "cpu")
    return rb, tb


def _open_gates(params):
    """VLM cross blocks start with tanh(0) = 0 gates, which would hide the
    cross-attention from the logits: open them to 0.5."""
    scan = params["stack"].get("scan", {})
    for name, p in scan.items():
        if name.endswith("_cross"):
            p["attn_gate"] = jnp.full_like(p["attn_gate"], 0.5)
            p["mlp_gate"] = jnp.full_like(p["mlp_gate"], 0.5)
    return params


def _greedy(cfg, params, batch, prefill, decode, grow, to_np, argmax):
    logits, caches = prefill(cfg, params, batch)
    first = to_np(logits)
    caches = grow(caches, S, S + STEPS)
    out = []
    for i in range(STEPS):
        tok = argmax(logits)
        out.append(to_np(tok))
        logits, caches = decode(cfg, params, caches, tok, S + i)
    return first, np.concatenate(out, 1), to_np(logits)


def _ref_greedy(cfg, params, batch):
    return _greedy(cfg, params, batch, RM.prefill,
                   lambda c, p, ca, t, i: RM.decode_step(c, p, ca, t,
                                                          jnp.int32(i)),
                   RM.grow_caches, np.asarray,
                   lambda lg: jnp.argmax(lg[:, -1], -1)[:, None].astype(
                       jnp.int32))


def _port_greedy(cfg, params, batch):
    with torch.no_grad():
        return _greedy(cfg, params, batch, TM.prefill, TM.decode_step,
                       TM.grow_caches, _np,
                       lambda lg: torch.argmax(lg[:, -1], -1)[:, None])


@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_every_configuration_matches_the_reference(arch, monkeypatch):
    """Prefill logits, greedy ids and the last decode step's logits of
    each configuration from the reference's weights (VLM gates opened),
    with source embeddings where the configuration takes them; every
    routing decision of the MoE configurations clears ``ROUTE_MARGIN``."""
    margins = _ref_margins(monkeypatch)
    rcfg, tcfg = _configs(arch)
    params = _open_gates(RM.init(rcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rb, tb = _model_inputs(rcfg, 6)
    r_first, r_ids, r_last = _ref_greedy(rcfg, params, rb)
    t_first, t_ids, t_last = _port_greedy(tcfg, tparams, tb)
    jax.effects_barrier()
    if rcfg.n_experts:
        assert len(margins) >= STEPS + 1 and min(margins) > ROUTE_MARGIN
    else:
        assert not margins
    np.testing.assert_allclose(t_first, r_first, **F32_TOL)
    np.testing.assert_array_equal(t_ids, r_ids)
    np.testing.assert_allclose(t_last, r_last, **F32_TOL)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_shuffled_stacks_match_the_reference(arch, monkeypatch):
    """The MoE, VLM and encoder-decoder stacks with 4 kv heads and the
    kv-head shuffle on: the port's ``cuda`` engine (K4a's plain version
    here) in every self-attention layer (``moe``, ``dense``, ``enc``,
    ``dec``; none in cross-attention) against the reference's ``pallas``
    engine; the port's logits bit-equal with the shuffle off."""
    from repro_torch import obs
    margins = _ref_margins(monkeypatch)
    rcfg, tcfg = _configs(arch, kv=4, shuffle=True)
    params = _open_gates(RM.init(rcfg, jax.random.PRNGKey(1)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rb, tb = _model_inputs(rcfg, 7)
    want, _ = RM.prefill(rcfg, params, rb)
    obs.reset()
    obs.enable(sync=False)
    try:
        with torch.no_grad():
            got, _ = TM.prefill(tcfg, tparams, tb)
        shuffles = sum(obs.kernel_counts().values())
    finally:
        obs.disable()
        obs.reset()
    self_attn = sum(k in ("dense", "local", "moe", "enc", "dec")
                    for k in tcfg.layer_kinds
                    + tcfg.enc_pattern * tcfg.n_enc_periods)
    assert shuffles == 4 * self_attn > 0
    jax.effects_barrier()
    assert all(m > ROUTE_MARGIN for m in margins)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    with torch.no_grad():
        off, _ = TM.prefill(dataclasses.replace(tcfg, head_shuffle=None),
                            tparams, tb)
    assert torch.equal(off, got)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_decode_continuation_stateful_archs(arch):
    """The reference's test of the same name in the port:
    prefill(x[:t]) + decode(x[t]) == prefill(x[:t+1]) for SSM, hybrid and
    MoE: the SSD state carry, the RG-LRU hidden state, the conv tails and
    the windowed-attention caches."""
    cfg = t_reduce(t_config(arch))
    params = TM.init(cfg, torch.Generator().manual_seed(11))
    s = 16
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, s)))
    with torch.no_grad():
        full, _ = TM.prefill(cfg, params, {"tokens": toks})
        _, caches = TM.prefill(cfg, params, {"tokens": toks[:, :s - 1]})
        caches = TM.grow_caches(caches, s - 1, s)
        dec, _ = TM.decode_step(cfg, params, caches, toks[:, s - 1:], s - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("arch,kinds", [("mamba2-130m", ("mamba",)),
                                        ("recurrentgemma-2b", ("rec",))])
def test_decode_advances_stateful_caches_in_place(arch, kinds):
    """Decode writes the conv tails and the SSD / RG-LRU states into the
    stacked caches it was given (the layer's slice, in place) and returns
    those same tensors; the states equal the reference's decode from the
    same caches."""
    rcfg, tcfg = _configs(arch)
    params = RM.init(rcfg, jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rb, tb = _model_inputs(rcfg, 8)
    _, rc = RM.prefill(rcfg, params, rb)
    rc = RM.grow_caches(rc, S, S + 1)
    tc = caches_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    before = jax.tree.map(lambda t: (t.data_ptr(), t.clone()), tc,
                          is_leaf=lambda v: isinstance(v, torch.Tensor))
    tok = np.ones((B, 1), np.int32)
    _, rnew = RM.decode_step(rcfg, params, rc, jnp.asarray(tok),
                             jnp.int32(S))
    with torch.no_grad():
        _, tnew = TM.decode_step(tcfg, tparams, tc, _t(tok).long(), S)
    for group in ("scan", "tail"):
        for name, leaves in tnew.get(group, {}).items():
            if name.split("_", 1)[1] not in kinds:
                continue
            for key, t in leaves.items():
                ptr, old = before[group][name][key]
                assert t is tc[group][name][key] and t.data_ptr() == ptr
                assert not torch.equal(t, old), (group, name, key)
                np.testing.assert_allclose(
                    _np(t), np.asarray(rnew[group][name][key], np.float32),
                    **F32_TOL)
                assert t.dtype == (torch.float32 if key in ("state", "h")
                                   else tcfg.dtype)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-130m",
                                  "recurrentgemma-2b",
                                  "llama-3.2-vision-90b"])
def test_float32_leaves_carry_across_in_bf16_trees(arch):
    """A bfloat16 model's float32 leaves (the router, ``dt_bias``,
    ``a_log``, ``d_skip``, ``a_param``, the VLM gates) and its float32
    caches (the SSD ``state``, the RG-LRU ``h``) carry across bit for bit,
    each in its own type, both ways."""
    rcfg, tcfg = _configs(arch, dtype="bf16")
    params = jax.tree.map(np.asarray, _open_gates(
        RM.init(rcfg, jax.random.PRNGKey(4))))
    tparams = params_from_numpy(params, "cpu")
    kinds = set()
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(tparams, is_leaf=lambda v:
                                            isinstance(v, torch.Tensor))):
        kinds.add((path[-1].key, str(t.dtype)))
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
        else:
            assert t.dtype == torch.float32 and a.dtype == np.float32
            np.testing.assert_array_equal(t.numpy(), a)
    f32 = {k for k, d in kinds if d == "torch.float32"}
    assert f32 and f32 <= {"router", "dt_bias", "a_log", "d_skip", "a_param",
                           "attn_gate", "mlp_gate"}
    rb, tb = _model_inputs(rcfg, 9)
    _, rc = RM.prefill(rcfg, params, rb)
    with torch.no_grad():
        _, tc = TM.prefill(tcfg, tparams, tb)
    back = caches_to_numpy(tc)
    carried = caches_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    for (path, a), t, b in zip(
            jax.tree_util.tree_flatten_with_path(rc)[0],
            jax.tree.leaves(carried, is_leaf=lambda v: isinstance(
                v, torch.Tensor)), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert t.dtype == (torch.float32 if a.dtype == np.float32
                           else torch.bfloat16), path
        if a.dtype == np.float32:
            np.testing.assert_array_equal(t.numpy(), a)
            assert path[-1].key in ("state", "h")
        assert b.shape == a.shape


def test_grow_caches_pads_only_the_kv_caches():
    """``grow_caches`` pads the self-attention ``k``/``v`` caches alone. The
    reference pads every leaf whose sequence axis equals the old length,
    so a prompt as long as mamba2's 16 SSD heads (smoke size) pads its
    state's head axis too; the port's state keeps its shape and the
    decode continues the prefill (rtol = atol = 5e-3, the reference's
    stateful continuation bound)."""
    cfg = t_reduce(t_config("mamba2-130m"))
    rcfg = ref_reduce(ref_config("mamba2-130m"))
    s = 16
    params = RM.init(rcfg, jax.random.PRNGKey(12))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                              (B, s + 1)).astype(np.int32)
    _, rc = RM.prefill(rcfg, params, {"tokens": jnp.asarray(toks[:, :s])})
    state = rc["scan"]["0_mamba"]["state"]
    assert state.shape[2] == s                  # 16 heads: the prompt length
    assert RM.grow_caches(rc, s, s + 1)["scan"]["0_mamba"]["state"].shape[
        2] == s + 1
    with torch.no_grad():
        full, _ = TM.prefill(cfg, tparams, {"tokens": _t(toks).long()})
        _, tc = TM.prefill(cfg, tparams, {"tokens": _t(toks[:, :s]).long()})
        grown = TM.grow_caches(tc, s, s + 1)
        assert grown["scan"]["0_mamba"]["state"].shape == tuple(state.shape)
        dec, _ = TM.decode_step(cfg, tparams, grown,
                                _t(toks[:, s:]).long(), s)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3,
                               atol=5e-3)
    # a dense model's k/v caches grow as before
    dcfg = t_reduce(t_config("mistral-nemo-12b"))
    dp = TM.init(dcfg, torch.Generator().manual_seed(12))
    with torch.no_grad():
        _, kv = TM.prefill(dcfg, dp, {"tokens": _t(toks[:, :s]).long()})
    g = TM.grow_caches(kv, s, s + 3)["scan"]["0_dense"]
    assert g["k"].shape[2] == g["v"].shape[2] == s + 3
