"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's, on duck-typed meshes (only ``axis_names`` and ``shape`` are
read, so production shapes need no process group).

The port's specs are plain tuples; each equals ``tuple()`` of the
reference's ``PartitionSpec``. The divisibility-guard cases repeat
``tests/test_sharding.py`` against the port.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_config
from repro.models import model as RM
from repro.parallel import sharding as RS
from repro_torch.configs import get_config as t_config
from repro_torch.launch import hw
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as TS


class FakeMesh:
    """Duck-typed mesh: only .axis_names and .shape are consulted."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH3,
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x1": FakeMesh({"data": 1, "model": 1})}

LOGICAL = ("batch", "vocab", "heads", "kv_heads", "seq_kv", "mlp",
           "experts", "embed", "state", "head_dim", "layers", "opt_shard",
           None)
DIMS = (1, 2, 7, 8, 16, 32, 36, 48, 64, 128, 384, 4096, 49152, 50280)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rules_and_sizes_equal_the_reference(name):
    mesh = MESHES[name]
    assert TS.dp_axes(mesh) == RS.dp_axes(mesh)
    assert TS.dp_size(mesh) == RS.dp_size(mesh)
    for fsdp in (True, False):
        assert (TS.logical_rules(mesh, fsdp=fsdp)
                == RS.logical_rules(mesh, fsdp=fsdp))
    assert TS.dp_size(None) == RS.dp_size(None) == 1


@pytest.mark.parametrize("name", sorted(MESHES))
def test_spec_for_and_batch_spec_equal_the_reference(name):
    mesh = MESHES[name]
    rng = np.random.default_rng(len(name))
    for _ in range(300):
        nd = int(rng.integers(1, 5))
        axes = tuple(LOGICAL[i] for i in rng.integers(0, len(LOGICAL), nd))
        shape = tuple(int(DIMS[i]) for i in rng.integers(0, len(DIMS), nd))
        for fsdp in (True, False):
            for min_shard in (1, 2, 4):
                got = TS.spec_for(mesh, axes, shape, fsdp=fsdp,
                                  min_shard=min_shard)
                want = RS.spec_for(mesh, axes, shape, fsdp=fsdp,
                                   min_shard=min_shard)
                assert got == tuple(want), (axes, shape)
        for b in (1, 2, 4, 6, 32, 256):
            assert TS.batch_spec(mesh, b, nd) == tuple(
                RS.batch_spec(mesh, b, nd))


@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_param_shardings_over_every_configuration(arch):
    """Every parameter of every configuration (full size, ``meta`` tensors
    on the port's side) gets the reference's spec on both production
    meshes, and the reference's ``NamedSharding`` spec on a real
    one-device mesh."""
    tshapes, taxes = TM.param_shapes(t_config(arch)), TM.param_axes(
        t_config(arch))
    rshapes, raxes = RM.param_shapes(r_config(arch)), RM.param_axes(
        r_config(arch))
    assert jax.tree.map(lambda s: tuple(s.shape), rshapes) == _tree(
        tshapes, lambda t: tuple(t.shape))
    assert all(t.device.type == "meta" for t in _leaves(tshapes))

    def spec_tree(mesh, shapes, axes, fsdp):
        return _tree_pair(shapes, axes, lambda s, a: tuple(
            RS.spec_for(mesh, a, s.shape, fsdp=fsdp)))

    for mesh in (MESH, MESH3):
        for fsdp in (True, False):
            got = TS.param_shardings(mesh, tshapes, taxes, fsdp=fsdp)
            assert got == spec_tree(mesh, rshapes, raxes, fsdp)
    one = jax.make_mesh((1, 1), ("data", "model"))
    named = RS.param_shardings(one, rshapes, raxes)
    got = TS.param_shardings(FakeMesh({"data": 1, "model": 1}), tshapes,
                             taxes)
    assert got == jax.tree.map(lambda ns: tuple(ns.spec), named)


def _tree(t, fn):
    return {k: _tree(v, fn) for k, v in t.items()} if isinstance(
        t, dict) else fn(t)


def _tree_pair(s, a, fn):
    return {k: _tree_pair(s[k], a[k], fn) for k in s} if isinstance(
        s, dict) else fn(s, a)


def _leaves(t):
    return [x for v in t.values() for x in _leaves(v)] if isinstance(
        t, dict) else [t]


# the divisibility-guard cases of tests/test_sharding.py, on the port

def test_vocab_sharded_when_divisible():
    assert TS.spec_for(MESH, ("vocab", "embed"), (49152, 4608)) == tuple(
        P("model", "data"))


def test_divisibility_guard_falls_back():
    s = TS.spec_for(MESH, ("vocab", "embed"), (50280, 768))
    assert s[0] is None
    s2 = TS.spec_for(MESH, ("embed", "heads", "head_dim"), (4608, 36, 128))
    assert s2 == tuple(P("data", None, None))


def test_each_axis_used_once():
    s = TS.spec_for(MESH, ("experts", "embed", "mlp"), (384, 7168, 2048))
    assert s == tuple(P("model", "data", None))


def test_pod_composes_with_data():
    s = TS.spec_for(MESH3, ("embed", "mlp"), (8192, 28672))
    assert s == tuple(P(("pod", "data"), "model"))
    assert TS.dp_axes(MESH3) == ("pod", "data")


def test_seq_kv_cache_rule():
    s = TS.spec_for(MESH, ("batch", "seq_kv", "kv_heads", None),
                    (128, 32768, 8, 128))
    assert s == tuple(P("data", "model", None, None))


def test_batch_spec_guard():
    assert TS.batch_spec(MESH, 256, 2) == tuple(P("data", None))
    assert TS.batch_spec(MESH, 1, 2) == tuple(P(None, None))
    assert TS.batch_spec(MESH3, 256, 3) == tuple(P(("pod", "data"), None,
                                                   None))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("seq_parallel", [False, True])
def test_constrainers_are_value_neutral_and_name_the_reference_spec(
        name, seq_parallel, monkeypatch):
    """The port's constrainers return their input unchanged; ``.spec``
    is the spec the reference hands ``with_sharding_constraint``."""
    mesh = MESHES[name]
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    monkeypatch.setattr(RS, "NamedSharding", lambda m, spec: _Named(spec))
    act_t = TS.activation_constrainer(mesh, seq_parallel=seq_parallel)
    act_r = RS.activation_constrainer(mesh, seq_parallel=seq_parallel)
    moe_t, moe_r = TS.moe_buffer_constrainer(mesh), \
        RS.moe_buffer_constrainer(mesh)
    for shape in ((4, 512, 64), (3, 256, 64), (32, 4096, 8), (1, 7, 8)):
        x = torch.zeros(shape)
        assert act_t(x) is x
        act_r(np.zeros(shape, np.float32))
        assert act_t.spec(x) == seen.pop()
    for shape in ((2, 4, 8, 16), (16, 16, 8, 16), (3, 5, 8, 16)):
        x = torch.zeros(shape)
        assert moe_t(x) is x
        moe_r(np.zeros(shape, np.float32))
        assert moe_t.spec(x) == seen.pop()
    assert TS.moe_buffer_constrainer(None) is RS.moe_buffer_constrainer(None)
    x = torch.zeros(2)
    assert TS.activation_constrainer(None)(x) is x


class _Named:
    def __init__(self, spec):
        self.spec = spec


def test_h100_constants():
    """The H100's own values (data sheet), none of the reference's v5e."""
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.ICI_BW == 450e9 and hw.HBM_BYTES == 80e9
    assert hw.GPUS_PER_NODE == 8
    assert (hw.CHIPS_SINGLE_POD, hw.CHIPS_MULTI_POD) == (256, 512)


def test_meshes_refuse_a_wrong_world_or_backend():
    """``make_dev_mesh`` / ``make_production_mesh`` raise when the world
    does not hold the shape's ranks, and a mesh on ``"cuda"`` refuses a
    gloo group (no fallback between backends); a one-rank mesh starts
    and destroys its own group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (Mesh, make_dev_mesh,
                                         make_production_mesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        make_dev_mesh(2, 2, device="cpu")
    mesh = make_dev_mesh(1, 1, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and mesh.shape == {
            "data": 1, "model": 1}
        assert mesh.coords == {"data": 0, "model": 0}
        assert mesh.rank_of({"data": 0, "model": 0}) == 0
        assert mesh.coords_of(0) == mesh.coords
        with pytest.raises(ValueError, match="4 ranks"):
            make_dev_mesh(2, 2, device="cpu")
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="nccl"):
            Mesh((1, 1), ("data", "model"), device="cuda")
        with pytest.raises(ValueError, match="mesh's order"):
            mesh.group(("model", "data"))
    finally:
        mesh.close()
    assert not dist.is_initialized()
