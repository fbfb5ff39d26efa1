"""The port's op counter (``repro_torch.launch.op_analysis``), the kernel
route under a dry run, and the dry-run mesh, on the CPU.

* The per-rank program of ``tests/test_hlo_analysis.py::
  test_analyzer_hand_count`` written out by hand on a fake (4, 2) world
  (rows cut over ``data``, ``w`` over ``model``, 5 iterations): the
  counter gives that test's numbers.
* A counter over real tensors (a one-rank gloo group) and a dry run of
  the same program agree.
* A fake tensor through ``bmmc_permute`` counts one K4a launch with the
  schedule ``k4a_schedule`` picks and leaves the device cache empty; a
  fake tensor outside a dry run raises; a real tensor never takes the
  dry branch and is refused by a collective of the fake backend; K4b and
  K5 launches through a smoke ``PermuteLayer`` are counted.
* Phi's smoke step on a fake (4, 2) world: its ``all-to-all`` bytes
  equal a hand count from the capacity, ``d_model`` and the item size.
"""
import random

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.bmmc import Bmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import ops as pops
from repro_torch.launch.mesh import all_gather, all_to_all, make_dev_mesh
from repro_torch.launch.op_analysis import (COLLECTIVE_KINDS, OpCounter,
                                            dry_run)


@pytest.fixture
def fake_mesh(request):
    shape = getattr(request, "param", (4, 2))
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_dev_mesh(*shape, device="cpu", dry_run=True)
    yield mesh
    mesh.close()
    assert not dist.is_initialized()


def test_hand_count_matches_the_reference_analyzer(fake_mesh):
    """``test_analyzer_hand_count``'s program, per rank: x (256, 64) with
    rows over data (4) is (64, 64) here; w (64, 128) with columns over
    model (2) is (64, 64). Each of 5 iterations: ``c @ w``, then ``c @
    w.T``, whose contraction runs over the sharded columns, so a partial
    sum all-reduced over model; then the sum, all-reduced everywhere."""
    M, N, K, T = 256, 128, 64, 5
    with dry_run() as c:
        x = torch.empty(M // 4, K)
        w = torch.empty(K, N // 2)
        for _ in range(T):
            x = x @ w
            x = x @ w.t()
            dist.all_reduce(x, group=fake_mesh.group("model"))
        s = x.sum()
        dist.all_reduce(s, group=fake_mesh.group(("data", "model")))
    r = c.result()
    assert r["all-reduce"] == 5 * 64 * 64 * 4 + 4
    assert r["dot_flops"] == 5 * 2 * (2 * 64 * 64 * 64)
    assert r["collective_total"] == r["all-reduce"]
    cb = c.collective_bytes()
    assert set(cb) == set(COLLECTIVE_KINDS) | {"total"}
    assert cb["total"] == cb["all-reduce"] == r["all-reduce"]


def _program(mesh, x, w):
    """A matmul chain with an all-to-all and a gather over ``mesh``."""
    y = (x @ w).relu() @ w.t()
    y = all_to_all(y, mesh.group("model"))
    return torch.cat(all_gather(y, mesh.group("data")))


def test_a_counter_over_real_tensors_agrees_with_a_dry_run():
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_dev_mesh(1, 1, device="cpu")
    try:
        x, w = torch.randn(8, 16), torch.randn(16, 32)
        with OpCounter() as real:
            real.hold(x, w)
            _program(mesh, x, w)
    finally:
        mesh.close()
    mesh = make_dev_mesh(1, 1, device="cpu", dry_run=True)
    try:
        with dry_run() as dry:
            _program(mesh, torch.empty(8, 16), torch.empty(16, 32))
    finally:
        mesh.close()
    a, b = real.result(), dry.result()
    # (the dry run's aten calls also make its two inputs)
    for k in COLLECTIVE_KINDS + ("dot_flops", "peak_bytes"):
        assert a[k] == b[k], k
    assert a["all-to-all"] == 8 * 16 * 4 and a["dot_flops"] == 4 * 8 * 16 * 32


@pytest.mark.parametrize("shape,dtype,batched,schedule", [
    ((2048, 8, 128), torch.bfloat16, True, "wide"),
    ((1 << 10,), torch.int32, False, "narrow")])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_fake_tensor_through_bmmc_permute_counts_one_k4a_launch(
        shape, dtype, batched, schedule, device):
    """The plan is built (numpy), the launch counted with the schedule the
    card's record would hold, nothing uploaded, no record made, nothing
    launched; a fake ``cuda`` tensor goes the same way on a CPU-only
    build."""
    pk.clear_device_tables()
    before = pk.launch_counts()
    n = shape[1 if batched else 0].bit_length() - 1
    b = Bmmc.bit_reverse(n)
    with dry_run() as c:
        x = torch.empty(shape, dtype=dtype, device=device)
        out = pops.bmmc_permute(x, b, batched=batched)
    assert out.shape == x.shape and out.dtype == dtype
    assert out.device.type == device
    xc = x.reshape(shape[0] if batched else 1, 1 << n, -1)
    t = pops.choose_tile(n, x.element_size(), xc.shape[2])
    kernel, plans = pops.class_plan(b, t)
    assert kernel == "tiled" and len(plans) == 1
    want = pk.k4a_schedule(pk.plan_geometry(plans[0]), xc.shape[0],
                           xc.shape[2], x.element_size(), 0)
    assert want.schedule == schedule
    nbytes = 2 * x.numel() * x.element_size()
    assert c.result()["kernel_launches"] == {
        f"tile_{schedule}": {"launches": 1, "bytes": nbytes}}
    assert pk._DEV_CACHE.cache_info()[3] == 0
    assert pk.device_copies(plans[0], "tables") == {}
    assert pk.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["bmmc_permute", "tiled_permute",
                                     "block", "lane", "copy"])
def test_a_fake_tensor_outside_a_dry_run_raises(wrapper):
    b = Bmmc.bit_reverse(10)
    with FakeTensorMode():
        x = torch.empty(1 << 10, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="outside a dry run"):
            if wrapper == "bmmc_permute":
                pops.bmmc_permute(x, b)
            elif wrapper == "tiled_permute":
                pk.tiled_permute(x, pops.class_plan(b, 3)[1][0])
            elif wrapper == "copy":
                pk.copy_blocks(x)
            else:
                n, rng = 10, random.Random(3)
                ident = tuple(1 << i for i in range(n))
                if wrapper == "block":
                    sub = Bmmc.random(n - n // 2, rng)
                    bb = Bmmc(ident[:n // 2] + tuple(
                        r << (n // 2) for r in sub.rows), 0)
                else:
                    bb = Bmmc(tuple(Bmmc.random(2, rng).rows) + ident[2:], 0)
                kernel, p = pops.class_plan(bb, 3)
                assert kernel == wrapper
                (pk.block_permute if wrapper == "block"
                 else pk.lane_permute)(x, p)


def test_a_real_tensor_never_takes_the_dry_branch():
    """Under a dry counter but no fake mode, a real CPU tensor runs the
    plain version, bit for bit, and counts no launch."""
    b = Bmmc.bit_reverse(10)
    x = torch.arange(1 << 10, dtype=torch.int32)
    with OpCounter(dry=True) as c:
        got = pops.bmmc_permute(x, b)
    assert torch.equal(got, pk.tiled_permute_plain(
        x, pops.class_plan(b, pops.choose_tile(10, 4))[1][0]))
    assert c.result()["kernel_launches"] == {}


@pytest.mark.parametrize("fake_mesh", [(2, 1)], indirect=True)
def test_a_real_tensor_on_the_fake_backend_raises(fake_mesh):
    x = torch.ones(4, 4)
    with pytest.raises(RuntimeError, match="real tensor"):
        all_to_all(x, fake_mesh.group("data"))
    with pytest.raises(RuntimeError, match="real tensor"):
        all_gather(x, fake_mesh.group("data"))


def test_a_dry_run_mesh_refuses_a_live_group_and_closes_its_own(fake_mesh):
    assert dist.get_backend() == "fake" and dist.get_world_size() == 8
    assert fake_mesh.rank == 0 and fake_mesh.coords == {"data": 0,
                                                        "model": 0}
    with pytest.raises(RuntimeError, match="initialized already"):
        make_dev_mesh(1, 1, device="cpu", dry_run=True)


def test_k4b_and_k5_launches_through_a_permute_layer_are_counted():
    """A smoke ``PermuteLayer(sort_expr(8))`` in a loss: the forward runs
    one K4b pass per compute cluster, the backward one K5 pass per
    compute cluster, none of them real."""
    from repro_torch.combinators.optimize import FusedStage
    from repro_torch.combinators.sort import sort_expr
    from repro_torch.models.permute import PermuteLayer
    n = 8
    layer = PermuteLayer(sort_expr(n), axis=1)
    t = pops.choose_tile(n, 4, 1)
    clusters = sum(isinstance(st, FusedStage) and bool(st.computes)
                   for st in layer.compiled.clustered_program(n, t))
    assert clusters > 0
    before = pk.launch_counts()
    with dry_run() as c:
        x = torch.empty((4, 1 << n), requires_grad=True)
        loss = (layer(x) * torch.empty(4, 1 << n)).sum()
        fwd = dict(c.result()["kernel_launches"])
        loss.backward()
    r = c.result()["kernel_launches"]
    assert fwd["tile_fused"]["launches"] == clusters
    assert "tile_bwd" not in fwd
    assert r["tile_bwd"]["launches"] == clusters
    assert r["tile_bwd"]["bytes"] == clusters * 3 * 4 * (1 << n) * 4
    assert pk.launch_counts() == before


def _phi_smoke():
    from repro_torch.configs import get_config, reduce_for_smoke
    return reduce_for_smoke(get_config("phi3.5-moe-42b-a6.6b"))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_phi_all_to_all_bytes_on_a_fake_4x2_world(fake_mesh, kind):
    """Per rank and MoE layer: the batch over data (4) and the sequence
    over model (2) leave ``t`` tokens; ``cap`` slots a peer; the payload
    ``(2, cap, d_model)`` float32 goes out and comes back, the expert ids
    ``(2, cap)`` int64 go out. A step adds the payload's two transposed
    exchanges and the reduce-scatter of each expert weight's gradient
    over data (an all-to-all of its ``(2, d_model, d_ff)`` float32
    whole)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    cfg = _phi_smoke()
    b, s = 4, 16
    t = (b // 4) * (s // 2)
    cap = -(-cfg.top_k * t * cfg.capacity_factor // 2)
    cap = max(8, -(-int(cap) // 8) * 8)
    e, f, xpp = cfg.d_model, cfg.moe_d_ff, cfg.n_experts // 2
    layers = cfg.layer_kinds.count("moe")
    fwd = 2 * (2 * cap * e * 4) + 2 * cap * 8
    want = layers * (fwd if kind == "prefill" else
                     fwd + 2 * (2 * cap * e * 4) + 3 * (xpp * e * f * 4))
    fn, args, _ = D.build_cell(cfg, ShapeConfig("s", s, b, kind), fake_mesh)
    r = D.trace_step(fn, args, kind).result()
    assert r["all-to-all"] == want
    assert r["all-gather"] > 0 and r["all-reduce"] == 0


def test_moe_expert_counts_are_a_fixed_size_count():
    """The aux loss's expert counts (``scatter_add_`` of ones where
    ``bincount`` stood): equal to ``bincount`` on real ids, traceable on
    fake ones."""
    from repro_torch.models.moe import _expert_counts
    ids = torch.randint(0, 6, (3, 10, 2), generator=torch.Generator(
        ).manual_seed(0))
    want = torch.stack([torch.bincount(r.reshape(-1), minlength=6)
                        for r in ids]).float()
    assert torch.equal(_expert_counts(ids, 6), want)
    with dry_run():
        got = _expert_counts(torch.empty((3, 10, 2), dtype=torch.int64), 6)
    assert got.shape == (3, 6) and got.dtype == torch.float32
