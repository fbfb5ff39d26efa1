"""The port's checkpoints: the reference's tests mirrored, and checkpoints
carried across packages in both directions. Every comparison is bit for
bit (the port writes the reference's layout, leaf keys and sha256s)."""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro.optim import adamw as RA
from repro_torch.checkpoint import ckpt
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import adamw as TA
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_checkpoint_roundtrip_and_integrity():
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones((5,)), "n": torch.zeros((2, 2))}}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 7, tree, extra_state={"loader": {"epoch": 1}})
        assert ckpt.latest_step(d) == 7
        restored, extra = ckpt.restore(d, 7, tree)
        assert extra["loader"]["epoch"] == 1
        for a, b in zip(_leaves(tree), _leaves(restored)):
            assert torch.equal(a, b)
        # corrupt a leaf -> integrity failure
        path = os.path.join(d, "step_00000007", "arrays.npz")
        data = dict(np.load(path))
        data["w"] = data["w"] + 1
        np.savez(path, **data)
        with pytest.raises(IOError):
            ckpt.restore(d, 7, tree)


def test_checkpoint_prunes_old():
    tree = {"w": torch.zeros((2,))}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(d, s, tree, keep_last=2)
        steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert len(steps) == 2 and ckpt.latest_step(d) == 5


def test_latest_step_ignores_orphans_and_missing_dirs():
    with tempfile.TemporaryDirectory() as d:
        assert ckpt.latest_step(os.path.join(d, "absent")) is None
        assert ckpt.latest_step(d) is None
        os.makedirs(os.path.join(d, ".tmp_ckpt_orphan"))
        assert ckpt.latest_step(d) is None
        ckpt.save(d, 3, {"w": torch.zeros(1)})
        ckpt.save(d, 12, {"w": torch.zeros(1)})
        assert ckpt.latest_step(d) == 12


_KILL_WRITER = """
import sys
import torch
from repro_torch.checkpoint import ckpt

d = sys.argv[1]
tree = {"w": torch.arange(1 << 16, dtype=torch.float32),
        "opt": {"m": torch.ones((1 << 14,), dtype=torch.float32)}}
print("ready", flush=True)
step = 0
while True:
    step += 1
    ckpt.save(d, step, tree, keep_last=1_000_000)
"""


def test_checkpoint_survives_kill_mid_write():
    """SIGKILL a process mid-``ckpt.save`` loop: every *published*
    ``step_*`` directory must restore cleanly (the tmp + fsync +
    os.replace discipline means a torn write can only ever be an
    invisible ``.tmp_ckpt_*`` orphan, never a corrupt step)."""
    tree = {"w": torch.arange(1 << 16, dtype=torch.float32),
            "opt": {"m": torch.ones((1 << 14,), dtype=torch.float32)}}
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.Popen(
            [sys.executable, "-c", _KILL_WRITER, d], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            assert proc.stdout.readline().strip() == "ready"
            # let it race through a few saves, then kill at an arbitrary
            # instant (mid-write with high probability)
            time.sleep(1.0)
            proc.send_signal(signal.SIGKILL)
        finally:
            proc.kill()
            proc.wait(timeout=30)
        published = sorted(x for x in os.listdir(d)
                           if x.startswith("step_"))
        assert published, "writer never published a checkpoint"
        for name in published:
            restored, _ = ckpt.restore(d, int(name.split("_")[1]), tree)
            for a, b in zip(_leaves(tree), _leaves(restored)):
                assert torch.equal(a, b)


# -- across packages ----------------------------------------------------------

def _reference_tree(bits):
    """A ``(params, AdamWState)`` tree of the reference with float32,
    bfloat16, int8 and int32 leaves, after one update."""
    rng = np.random.default_rng(bits)
    params = {"emb": jnp.asarray(rng.standard_normal((6, 300)).astype(
        np.float32)), "blk": {"w": jnp.asarray(rng.standard_normal(
            (3, 5)).astype(np.float32))}}
    cfg = RA.AdamWConfig(state_bits=bits)
    st = RA.adamw_init(params, cfg)
    grads = jax.tree.map(lambda p: p * 0.5 + 0.25, params)
    params, st = RA.adamw_update(params, grads, st, cfg)
    params["half"] = jnp.asarray(rng.standard_normal((4, 7)).astype(
        np.float32)).astype(jnp.bfloat16)
    return params, st


def _port_like(params, st):
    host = jax.tree.map(np.asarray, (params, st))
    return (params_from_numpy(host[0], "cpu"),
            opt_state_from_numpy(host[1], "cpu"))


@pytest.mark.parametrize("bits", [32, 8])
def test_reference_checkpoint_restores_in_the_port(bits):
    params, st = _reference_tree(bits)
    template = _port_like(params, st)
    with tempfile.TemporaryDirectory() as d:
        rckpt.save(d, 4, (params, st), extra_state={"loader": {"step": 4}})
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            assert json.load(f)["leaves"]["0/half"]["dtype"] == "bfloat16"
        assert np.load(os.path.join(d, "step_00000004", "arrays.npz"))[
            "0/half"].dtype == np.dtype("V2")
        (tp, ts), extra = ckpt.restore(d, 4, template)
    assert extra == {"loader": {"step": 4}}
    assert isinstance(ts, TA.AdamWState)
    assert tp["half"].dtype == torch.bfloat16
    want = jax.tree.leaves(jax.tree.map(np.asarray, (params, st)))
    got = tree_leaves(tp) + [ts.step] + tree_leaves(ts.m) + tree_leaves(ts.v)
    assert len(got) == len(want)
    kinds = set()
    for a, b in zip(want, got):
        kinds.add(str(b.dtype))
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(b), a.view(np.int16) if
                                      a.dtype.name == "bfloat16" else a)
    assert {"torch.float32", "torch.bfloat16", "torch.int32"} <= kinds
    assert ("torch.int8" in kinds) == (bits == 8)


@pytest.mark.parametrize("bits", [32, 8])
def test_port_checkpoint_restores_in_the_reference(bits):
    params, st = _reference_tree(bits)
    tp, ts = _port_like(params, st)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 9, (tp, ts), extra_state={"arch": "x"})
        (rp, rs), extra = rckpt.restore(d, 9, (params, st))
        # the same keys, types and sha256s as the reference's own save
        with tempfile.TemporaryDirectory() as e:
            rckpt.save(e, 9, (params, st), extra_state={"arch": "x"})
            for name in ("manifest.json",):
                with open(os.path.join(d, "step_00000009", name)) as f:
                    mine = json.load(f)
                with open(os.path.join(e, "step_00000009", name)) as f:
                    theirs = json.load(f)
                assert mine == theirs
    assert extra == {"arch": "x"}
    # the reference brings a bfloat16 leaf back as numpy |V2 words
    assert rp["half"].dtype == np.dtype("V2")
    want = jax.tree.leaves(jax.tree.map(np.asarray, (params, st)))
    for a, b in zip(want, jax.tree.leaves((rp, rs))):
        assert a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# -- models of the non-dense block kinds, across packages ---------------------

def _model_tree(arch, bits):
    """A bfloat16 model of ``arch`` (smoke size) with its float32 leaves,
    and its AdamW state after one update, as the reference makes them."""
    import dataclasses
    from repro.configs import get_config, reduce_for_smoke
    from repro.models import model as RM
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype=jnp.bfloat16, opt_bits=bits)
    params = RM.init(cfg, jax.random.PRNGKey(bits))
    ocfg = RA.AdamWConfig(state_bits=bits)
    grads = jax.tree.map(lambda p: p * 0.5 + 0.25, params)
    return jax.jit(lambda p, g, s: RA.adamw_update(p, g, s, ocfg))(
        params, grads, RA.adamw_init(params, ocfg))


F32_LEAVES = {"phi3.5-moe-42b-a6.6b": {"router"},
              "mamba2-130m": {"dt_bias", "a_log", "d_skip"}}


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("arch", sorted(F32_LEAVES))
def test_model_checkpoints_restore_across_packages(arch, bits):
    """An MoE and a Mamba model (bfloat16 weights, float32 router / SSM
    leaves) with their optimizer state: the reference's checkpoint
    restores in the port, and the port's in the reference, bit for bit;
    the two manifests are equal and name each leaf's type."""
    params, st = _model_tree(arch, bits)
    tp, ts = _port_like(params, st)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as e:
        rckpt.save(d, 1, (params, st))
        (gp, gs), _ = ckpt.restore(d, 1, (tp, ts))
        ckpt.save(e, 1, (tp, ts))
        (rp, rs), _ = rckpt.restore(e, 1, (params, st))
        manifests = []
        for root in (d, e):
            with open(os.path.join(root, "step_00000001",
                                   "manifest.json")) as f:
                manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    leaves = manifests[0]["leaves"]
    f32 = {k.rsplit("/", 1)[-1] for k, v in leaves.items()
           if k.startswith("0/") and v["dtype"] == "float32"}
    assert f32 == F32_LEAVES[arch]
    assert {v["dtype"] for k, v in leaves.items()
            if k.startswith("0/")} == {"bfloat16", "float32"}
    want = jax.tree.leaves(jax.tree.map(np.asarray, (params, st)))
    got = tree_leaves(gp) + [gs.step] + tree_leaves(gs.m) + tree_leaves(
        gs.v)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(b), a.view(np.int16) if
                                      a.dtype.name == "bfloat16" else a)
    for a, b in zip(want, jax.tree.leaves((rp, rs))):
        assert a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
