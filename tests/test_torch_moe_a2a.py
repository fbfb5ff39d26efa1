"""The port's all-to-all MoE (``repro_torch.models.moe_a2a``) against the
reference's, on the CPU.

Inputs are float32 arrays from a numpy seed, handed to both packages.
The port runs on ``gloo`` meshes: (1, 1) in this process, (2, 2) and
(1, 4) on four spawned ranks (``_torch_mesh.spawn``); the reference on a
(1, 1) mesh in this process and on four fake CPU devices in one
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
run once for the file. Tolerances:

* outputs, ``aux`` and gradients (x, router, the three expert weights)
  against the reference: ``F32_TOL`` = 1e-5 absolute and relative — the
  same float32 products summed in other orders (observed at most about
  1e-6 on values of magnitude 4);
* across ranks, and the dispatch shuffle's neutrality on outputs and
  ``aux``: bit for bit;
* routing: every case's top-k margin (k-th largest router probability
  less the (k+1)-th, in float64) exceeds ``MARGIN`` = 1e-6, so the two
  packages' float32 softmaxes (an ulp apart) route alike.
"""
import functools
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh
from repro.core.bmmc import Bmmc as RBmmc
from repro.models import moe_a2a as RA
from repro_torch import obs
from repro_torch.core.bmmc import Bmmc as TBmmc
from repro_torch.kernels.ref import bmmc_ref
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import moe_a2a as TA

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-6
SHAPES = ((2, 2), (1, 4))       # the multi-rank meshes (data, model)
K = 2


def _inputs(seed, b, s, e=8, f=12, xn=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    rw = rng.standard_normal((e, xn)).astype(np.float32)
    wg, wu = ((rng.standard_normal((xn, e, f)) * 0.2).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((xn, f, e)) * 0.2).astype(np.float32)
    ct = rng.standard_normal((b, s, e)).astype(np.float32)
    return (x, rw, wg, wu, wd), ct


# name -> (inputs, cotangent, keyword arguments). The capacity factor 8
# gives power-of-two capacities on every mesh (512, 64, 32 slots a peer),
# so the shuffle's rounding changes nothing; 0.25 drops tokens at both
# packing steps.
CASES = {
    "main": (*_inputs(0, 2, 16), dict(top_k=K, capacity_factor=8.0)),
    "shuffle": (*_inputs(0, 2, 16), dict(top_k=K, capacity_factor=8.0,
                                         dispatch_shuffle=True)),
    "drop": (*_inputs(1, 2, 32), dict(top_k=K, capacity_factor=0.25)),
    # a (pod, data, model) mesh: batch 4 over both dp axes
    "pod": (*_inputs(2, 4, 8), dict(top_k=K, capacity_factor=8.0)),
}
# (shape, case) of each multi-rank run; the pod mesh (2, 2, 1) cuts the
# tokens as (4, 1) does, where the reference is right (it gathers the
# expert weights over pod before data, which misorders their embed dim on
# a mesh with both axes wider than 1)
RUNS = [(shape, name) for shape in SHAPES
        for name in ("main", "shuffle", "drop")] + [((2, 2, 1), "pod")]
REF_RUNS = RUNS[:-1] + [((4, 1), "pod")]


def _margin(x, rw):
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ rw
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), -1)
    return float((p[:, -K] - p[:, -K - 1]).min())


REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.models.moe_a2a import moe_ffn_a2a
src, dst = sys.argv[1], sys.argv[2]
data = np.load(src)
kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
      if hasattr(jax.sharding, "AxisType") else {})
out = {}
for run in data["runs"]:
    tag, name = str(run), str(run).split("_")[1]
    shape = tuple(int(v) for v in tag.split("_")[0].split("x"))
    mesh = jax.make_mesh(shape, ("data", "model"), **kw)
    args = [jnp.asarray(data[f"{name}_{i}"]) for i in range(5)]
    ct = jnp.asarray(data[f"{name}_ct"])
    cf = float(data[f"{name}_cf"])
    sh = bool(data[f"{name}_shuffle"])

    def f(*a):
        return moe_ffn_a2a(*a, top_k=2, capacity_factor=cf, mesh=mesh,
                           dispatch_shuffle=sh)

    def loss(*a):
        o, aux = f(*a)
        return jnp.sum(o * ct) + aux
    o, aux = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    out[f"{tag}_out"] = np.asarray(o)
    out[f"{tag}_aux"] = np.asarray(aux)
    for i, g in enumerate(grads):
        out[f"{tag}_g{i}"] = np.asarray(g)
np.savez(dst, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 4 fake CPU devices (a subprocess) and the port on
    4 gloo ranks, every mesh and case, run side by side once for the
    file."""
    d = tmp_path_factory.mktemp("a2a")
    data = {}
    for name, (inputs, ct, kw) in CASES.items():
        for i, a in enumerate(inputs):
            data[f"{name}_{i}"] = a
        data[f"{name}_ct"] = ct
        data[f"{name}_cf"] = kw["capacity_factor"]
        data[f"{name}_shuffle"] = kw.get("dispatch_shuffle", False)
    data["runs"] = np.array([f"{a}x{b}_{name}" for (a, b), name in REF_RUNS])
    np.savez(d / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jobs = [(shape, name) + CASES[name] for shape, name in RUNS]
    port, out = _torch_mesh.with_subprocess(
        [sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz")], env, ROOT, 240,
        lambda: _torch_mesh.spawn(_torch_mesh.a2a_worker, 4, d / "port",
                                  jobs, timeout=180))
    assert "OK" in out
    return dict(np.load(d / "out.npz")), port


@pytest.fixture(scope="module")
def ref4(runs):
    """The reference's results, by mesh and case."""
    return runs[0]


@pytest.fixture(scope="module")
def port4(runs):
    """Each rank's results, by mesh and case."""
    return runs[1]


@pytest.fixture(scope="module")
def mesh1():
    mesh = make_dev_mesh(1, 1, device="cpu")
    yield mesh
    mesh.close()


def _jmesh(shape):
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
          if hasattr(jax.sharding, "AxisType") else {})
    return jax.make_mesh(shape, ("data", "model"), **kw)


def test_cases_clear_the_routing_margin():
    for inputs, _, _ in CASES.values():
        assert _margin(inputs[0], inputs[1]) > MARGIN


# ---------------------------------------------------------------------------
# the slot shuffle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4])
def test_slot_shuffle_round_trip_with_metadata(n):
    rng = np.random.default_rng(n)
    cap = 1 << n
    buf = rng.standard_normal((3, cap, 5)).astype(np.float32)
    eid = rng.integers(0, 7, (3, cap)).astype(np.int64)
    b = TBmmc.bit_reverse(n)
    got = TA._slot_shuffle(torch.from_numpy(buf), b)
    got_eid = TA._slot_shuffle(torch.from_numpy(eid), b)
    rb = RBmmc.bit_reverse(n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RA._slot_shuffle(jnp.asarray(buf), rb)))
    np.testing.assert_array_equal(
        got_eid.numpy(),
        np.asarray(RA._slot_shuffle(jnp.asarray(eid.astype(np.int32)), rb)))
    # out[bitrev(i)] = x[i]: a row and its metadata move together
    rev = [int(format(i, f"0{n}b")[::-1], 2) for i in range(cap)]
    np.testing.assert_array_equal(got.numpy()[:, rev], buf)
    np.testing.assert_array_equal(got_eid.numpy()[:, rev], eid)
    back = TA._slot_shuffle(got, b, inverse=True)
    back_eid = TA._slot_shuffle(got_eid, b, inverse=True)
    assert torch.equal(back, torch.from_numpy(buf))
    assert torch.equal(back_eid, torch.from_numpy(eid))


def test_slot_shuffle_gradient_is_the_inverse_shuffle():
    """The VJP is the inverse permutation through the same engine: one
    K4a dispatch forward, one backward (plain versions here, counted by
    ``obs``)."""
    rng = np.random.default_rng(5)
    b = TBmmc.bit_reverse(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 6)).astype(
        np.float32)).requires_grad_()
    ct = torch.from_numpy(rng.standard_normal((2, 16, 6)).astype(np.float32))
    obs.reset()
    obs.enable(sync=False)
    try:
        y = TA._slot_shuffle(x, b)
        fwd = obs.kernel_counts()
        (y * ct).sum().backward()
        both = obs.kernel_counts()
    finally:
        obs.disable()
        obs.reset()
    assert fwd == {"tiled": 1} and both == {"tiled": 2}
    assert torch.equal(x.grad, bmmc_ref(ct, b.inverse(), batched=True))


# ---------------------------------------------------------------------------
# moe_ffn_a2a: one rank in this process
# ---------------------------------------------------------------------------

def _port_case(mesh, name, **over):
    inputs, ct, kw = CASES[name]
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    y, aux = TA.moe_ffn_a2a(*ts, mesh=mesh, **{**kw, **over})
    ((y * torch.from_numpy(ct)).sum() + aux).backward()
    return y.detach().numpy(), aux.item(), [t.grad.numpy() for t in ts]


@functools.lru_cache(maxsize=None)
def _ref1(name):
    inputs, ct, kw = CASES[name]
    mesh = _jmesh((1, 1))
    args = [jnp.asarray(a) for a in inputs]

    def f(*a):
        return RA.moe_ffn_a2a(*a, mesh=mesh, **kw)

    def loss(*a):
        o, aux = f(*a)
        return jnp.sum(o * ct) + aux
    o, aux = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    return np.asarray(o), float(aux), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_rank_matches_the_reference(mesh1, name):
    out, aux, grads = _port_case(mesh1, name)
    r_out, r_aux, r_grads = _ref1(name)
    np.testing.assert_allclose(out, r_out, **F32_TOL)
    np.testing.assert_allclose(aux, r_aux, **F32_TOL)
    for g, rg in zip(grads, r_grads):
        np.testing.assert_allclose(g, rg, **F32_TOL)
    if name == "drop":   # tokens whose every copy was dropped
        dropped = np.abs(r_out).sum(-1) == 0
        assert dropped.any()
        np.testing.assert_array_equal(np.abs(out).sum(-1) == 0, dropped)


def test_one_rank_shuffle_is_neutral_and_runs_k4a(mesh1):
    """The shuffle on ``cuda`` (K4a's plain version here), on ``ref`` and
    off give bit-equal outputs and aux; on ``cuda`` K4a is dispatched 2
    times a forward and 2 more a backward, and no other kernel."""
    inputs, ct, kw = CASES["main"]
    outs = {}
    for eng in ("cuda", "ref", None):
        ts = [torch.tensor(a, requires_grad=True) for a in inputs]
        obs.reset()
        obs.enable(sync=False)
        try:
            y, aux = TA.moe_ffn_a2a(*ts, mesh=mesh1, top_k=K,
                                    capacity_factor=8.0,
                                    dispatch_shuffle=eng is not None,
                                    shuffle_engine=eng or "cuda")
            fwd = obs.kernel_counts()
            ((y * torch.from_numpy(ct)).sum() + aux).backward()
            both = obs.kernel_counts()
        finally:
            obs.disable()
            obs.reset()
        outs[eng] = (y.detach(), aux.detach(), [t.grad for t in ts])
        if eng == "cuda":
            # the metadata's shuffle is a plain gather (``ref``)
            assert fwd == {"tiled": 2, "ref": 1}
            assert both == {"tiled": 4, "ref": 1}
        else:
            assert fwd.get("tiled", 0) == 0
    for eng in ("ref", None):
        assert torch.equal(outs[eng][0], outs["cuda"][0])
        assert torch.equal(outs[eng][1], outs["cuda"][1])
    for g, h in zip(outs["cuda"][2], outs["ref"][2]):
        assert torch.equal(g, h)


# ---------------------------------------------------------------------------
# moe_ffn_a2a: four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["drop", "main", "shuffle"])
def test_four_ranks_match_the_reference(ref4, port4, shape, name):
    tag = f"{shape[0]}x{shape[1]}_{name}"
    got = port4[0][(shape, name)]
    np.testing.assert_allclose(got["out"], ref4[f"{tag}_out"], **F32_TOL)
    np.testing.assert_allclose(got["aux"], ref4[f"{tag}_aux"], **F32_TOL)
    for i, g in enumerate(got["grads"]):
        np.testing.assert_allclose(g, ref4[f"{tag}_g{i}"], **F32_TOL)
    if name == "drop":
        dropped = np.abs(ref4[f"{tag}_out"]).sum(-1) == 0
        np.testing.assert_array_equal(np.abs(got["out"]).sum(-1) == 0,
                                      dropped)


@pytest.mark.parametrize("shape", SHAPES)
def test_four_ranks_agree_bit_for_bit(port4, shape):
    """Every rank holds the same output, aux and gradients."""
    for name in ("main", "shuffle", "drop"):
        want = port4[0][(shape, name)]
        for rank in port4[1:]:
            got = rank[(shape, name)]
            assert np.array_equal(got["out"], want["out"])
            assert np.array_equal(got["aux"], want["aux"])
            for g, h in zip(got["grads"], want["grads"]):
                assert np.array_equal(g, h)


@pytest.mark.parametrize("shape", SHAPES)
def test_four_ranks_shuffle_is_neutral(ref4, port4, shape):
    """At power-of-two capacities the shuffle leaves outputs and aux bit
    for bit, in the port as in the reference."""
    a, b = port4[0][(shape, "main")], port4[0][(shape, "shuffle")]
    assert np.array_equal(a["out"], b["out"])
    assert np.array_equal(a["aux"], b["aux"])
    tag = f"{shape[0]}x{shape[1]}"
    assert np.array_equal(ref4[f"{tag}_main_out"], ref4[f"{tag}_shuffle_out"])


def test_drop_case_drops_on_every_mesh(ref4):
    for shape in SHAPES:
        out = ref4[f"{shape[0]}x{shape[1]}_drop_out"]
        assert (np.abs(out).sum(-1) == 0).any(), shape


def test_pod_mesh_matches_the_reference_on_its_token_cut(ref4, port4):
    """On a (pod, data, model) = (2, 2, 1) mesh the port cuts the tokens
    as a (4, 1) mesh does and gathers the expert weights back in order:
    output, aux and gradients equal the reference's (4, 1) run."""
    got = port4[0][((2, 2, 1), "pod")]
    np.testing.assert_allclose(got["out"], ref4["4x1_pod_out"], **F32_TOL)
    np.testing.assert_allclose(got["aux"], ref4["4x1_pod_aux"], **F32_TOL)
    for i, g in enumerate(got["grads"]):
        np.testing.assert_allclose(g, ref4[f"4x1_pod_g{i}"], **F32_TOL)
    for rank in port4[1:]:
        assert np.array_equal(rank[((2, 2, 1), "pod")]["out"], got["out"])
