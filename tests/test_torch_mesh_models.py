"""The port's MoE configurations on a mesh against the reference's, on
the CPU.

Smoke-sized ``phi3.5-moe-42b-a6.6b`` and ``kimi-k2-1t-a32b`` (both
``moe_impl="a2a"``) from the reference's weights (``PRNGKey(0)``,
carried across as numpy): prefill logits, one greedy decode step,
``loss_fn`` and the gradient of every parameter, on a (1, 1) ``gloo``
mesh in this process and a (2, 2) one on four spawned ranks, against
the reference on the same mesh shape (one device here; four fake CPU
devices in one subprocess, run once for the file). With the mesh the
prefill takes the all-to-all branch in every MoE layer; the (2, 2)
decode step (one token, which a 2-wide model axis does not split)
takes the capacity branch over ``dp_groups = 2`` groups.

Tolerances: ``F32_TOL`` = 1e-5 absolute and relative (float32 products
summed in other orders); the greedy token equal; every rank bit-equal;
a ``make_train_step`` step's loss bit-equal to ``loss_fn``'s. Every
routing call's top-k margin in the port (float64 of its router
probabilities) exceeds 1e-6, so the two packages route alike.
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh
from repro.configs import get_config, reduce_for_smoke
from repro.models import model as RM

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
B, S = 2, 8


def _inputs(arch):
    cfg = reduce_for_smoke(get_config(arch))
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, toks, labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def ref_run(arch, mesh):
    """The reference's prefill, greedy decode step, loss and gradients."""
    cfg, toks, labels = _inputs(arch)
    params = RM.init(cfg, jax.random.PRNGKey(0))
    tokens = jnp.asarray(toks)
    logits, caches = jax.jit(lambda p, b: RM.prefill(cfg, p, b, mesh=mesh))(
        params, {"tokens": tokens})
    caches = RM.grow_caches(caches, S, S + 1)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    dec, _ = jax.jit(lambda p, c, t: RM.decode_step(
        cfg, p, c, t, jnp.int32(S), mesh=mesh))(params, caches, tok)
    batch = {"tokens": tokens, "labels": jnp.asarray(labels)}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, p, batch, mesh=mesh), has_aux=True))(params)
    out = {"prefill": np.asarray(logits), "decode": np.asarray(dec),
           "tok": np.asarray(tok), "loss": np.asarray(loss),
           "aux": np.asarray(parts["aux"])}
    out.update({f"grad/{k}": v for k, v in _flat(grads).items()})
    return out


REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, numpy as np
import test_torch_mesh_models as T
kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
      if hasattr(jax.sharding, "AxisType") else {})
mesh = jax.make_mesh((2, 2), ("data", "model"), **kw)
out = {}
for arch in T.ARCHS:
    out.update({f"{arch}/{k}": v for k, v in T.ref_run(arch, mesh).items()})
np.savez(sys.argv[1], **out)
print("OK")
"""


def _jmesh(shape):
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
          if hasattr(jax.sharding, "AxisType") else {})
    return jax.make_mesh(shape, ("data", "model"), **kw)


def _jobs(shape):
    jobs = []
    for arch in ARCHS:
        cfg, toks, labels = _inputs(arch)
        params = jax.tree.map(np.asarray, RM.init(cfg, jax.random.PRNGKey(0)))
        jobs.append((arch, shape, params, toks, labels))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 4 fake CPU devices (a subprocess) and the port on
    4 gloo ranks, both at (2, 2), run side by side once for the file."""
    d = tmp_path_factory.mktemp("mesh_models")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    port, out = _torch_mesh.with_subprocess(
        [sys.executable, "-c", REF_SCRIPT, str(d / "ref.npz"),
         str(ROOT / "tests")], env, ROOT, 300,
        lambda: _torch_mesh.spawn(_torch_mesh.model_jobs_worker, 4,
                                  d / "port", _jobs((2, 2)), timeout=240))
    assert "OK" in out
    data = np.load(d / "ref.npz")
    ref = {arch: {k[len(arch) + 1:]: data[k] for k in data.files
                  if k.startswith(arch + "/")} for arch in ARCHS}
    return ref, port


@pytest.fixture(scope="module")
def ref22(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port22(runs):
    """Each rank's results of both configurations on a (2, 2) mesh."""
    return runs[1]


def _moe_layers(arch):
    return reduce_for_smoke(get_config(arch)).layer_kinds.count("moe")


def _check(got, want, arch, shape):
    assert got["margin"] > 1e-6
    # the a2a branch in every MoE layer of the prefill; a decode step's
    # one token splits over a 1-wide model axis only
    assert got["a2a_prefill"] == _moe_layers(arch) > 0
    assert got["a2a_decode"] == (_moe_layers(arch) if shape[1] == 1 else 0)
    np.testing.assert_allclose(got["prefill"], want["prefill"], **F32_TOL)
    np.testing.assert_array_equal(got["tok"], want["tok"])
    np.testing.assert_allclose(got["decode"], want["decode"], **F32_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], **F32_TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], **F32_TOL)
    grads = _flat(got["grads"])
    assert sorted(f"grad/{k}" for k in grads) == sorted(
        k for k in want if k.startswith("grad/"))
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[f"grad/{k}"], err_msg=k,
                                   **F32_TOL)
    assert np.array_equal(got["step_loss"], got["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_matches_the_reference(arch):
    job = _jobs((1, 1))[ARCHS.index(arch)]
    got = _torch_mesh.model_worker(0, 1, *job)
    _check(got, ref_run(arch, _jmesh((1, 1))), arch, (1, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_by_two_mesh_matches_the_reference(ref22, port22, arch):
    i = ARCHS.index(arch)
    _check(port22[0][i], ref22[arch], arch, (2, 2))


def test_two_by_two_ranks_agree_bit_for_bit(port22):
    for i in range(len(ARCHS)):
        want = port22[0][i]
        for rank in port22[1:]:
            got = rank[i]
            for key in ("prefill", "decode", "loss", "aux", "step_loss"):
                assert np.array_equal(got[key], want[key]), key
            for tree in ("grads", "stepped"):
                a, b = _flat(got[tree]), _flat(want[tree])
                assert all(np.array_equal(a[k], b[k]) for k in b), tree


def test_capacity_branch_routes_dp_groups(monkeypatch):
    """``moe_impl="gspmd"`` on a (2, 2) mesh routes ``dp_groups = 2``
    capacity groups (one for a ragged ``b*s``), never the all-to-all
    branch: the reference's condition."""
    import torch
    from repro_torch.configs import get_config as t_config
    from repro_torch.configs import reduce_for_smoke as t_reduce
    from repro_torch.models import transformer as TT
    from repro_torch.models.model import _make_ctx

    class FakeMesh:
        axis_names, shape = ("data", "model"), {"data": 2, "model": 2}
    cfg = dataclasses.replace(t_reduce(t_config(ARCHS[0])), moe_impl="gspmd")
    calls = []
    real = TT.moe_ffn
    monkeypatch.setattr(TT, "moe_ffn", lambda x, *a, **k: calls.append(
        x.shape) or real(x, *a, **k))
    monkeypatch.setattr(TT, "moe_ffn_a2a", None)
    e, f, xn = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {"router": torch.zeros(e, xn), "we_gate": torch.zeros(xn, e, f),
         "we_up": torch.zeros(xn, e, f), "we_down": torch.zeros(xn, f, e)}
    ctx = _make_ctx(cfg, "train", FakeMesh(), 0)
    TT._moe_block_ffn(cfg, p, torch.zeros(2, 8, e), ctx)
    TT._moe_block_ffn(cfg, p, torch.zeros(3, 1, e), ctx)
    assert calls == [(2, 8, e), (1, 3, e)]
