"""The kernels of the PyTorch port held against the JAX reference.

On the CPU every wrapper runs its kernel's plain PyTorch version, so here
each plain version is held against the reference's Pallas function in
interpret mode on the reference's OWN tables (through
``plan_from_arrays``): a mismatch then lies in the port's kernel
schedule, not in its planner. ``ops.bmmc_permute`` is held end to end
against ``repro.kernels.ops.bmmc_permute`` and ``bmmc_ref``. Inputs are
made with numpy from a seed and handed to both packages; outputs are
compared bit for bit through integer views (tolerance: none — a
permutation moves data, it computes nothing).

The CUDA kernels themselves are held against their plain versions in
``tests/test_torch_cuda.py``, which runs on the card.
"""
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import tiling as rtiling
from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels import bmmc_permute as rk
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import guard as pguard
from repro_torch import obs as pobs
from repro_torch.core import tiling as ptiling
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import build as pbuild
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

def _payload(shape, dtype, seed, quiet=True):
    """Random bits of ``dtype`` (NaN payloads and -0.0 included) as a
    numpy array. XLA's CPU gather rewrites every bfloat16 NaN to the
    canonical one (sign kept), so payloads compared with JAX carry only
    canonical bfloat16 NaNs (``quiet=True``); the port itself moves every
    bit pattern (``test_port_moves_every_nan_payload``)."""
    raw = np.random.default_rng(seed).integers(
        0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    dt = np.dtype(dtype)
    if dt.itemsize == 2:
        raw = raw.astype(np.uint16)
        if quiet and dt == np.dtype(ml_dtypes.bfloat16):
            nan = ((raw & 0x7F80) == 0x7F80) & ((raw & 0x7F) != 0)
            raw = np.where(nan, (raw & 0x8000) | 0x7FC0, raw).astype(np.uint16)
    return raw.view(dt)


def _both(arr):
    """The same numpy array as a jax array and as a CPU torch tensor."""
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if (
        arr.dtype == np.dtype(ml_dtypes.bfloat16)) else torch.from_numpy(arr)
    return jnp.asarray(arr), t


def _assert_bitwise(want, got, ctx):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, ctx
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), ctx


def _port_bmmc(b):
    return PBmmc(b.rows, b.c)


def _from_ref_tile(p):
    return ptiling.plan_from_arrays(
        p.bmmc.rows, p.bmmc.c, p.t, p.in_rows, p.out_rows, p.xor_low, p.src0,
        p.in_run, p.out_run, row_cols=p.row_cols, n_over=p.n_over,
        tb_positions=p.tb_positions, row_dirs=p.row_dirs)


# ---------------------------------------------------------------------------
# each kernel's plain version vs the reference's Pallas kernel
# ---------------------------------------------------------------------------

_TILE_CASES = [  # (n, t, bmmc kind, dtype, shape tail, batch)
    (8, 3, "bitrev", np.float32, (), None),
    (8, 3, "bmmc", ml_dtypes.bfloat16, (), None),
    (9, 3, "bpc", np.int32, (3,), None),
    (8, 2, "bmmc", np.int32, (), 2),
    (10, 4, "mixed", np.float32, (2,), 2),
]


def _ref_bmmc(kind, n, rng):
    return {"bitrev": lambda: RBmmc.bit_reverse(n),
            "bpc": lambda: RBmmc.random_bpc(n, rng),
            "bmmc": lambda: RBmmc.random(n, rng),
            "mixed": lambda: RBmmc.xor_shift(n, 3 | (1 << (n - 1)))}[kind]()


@pytest.mark.parametrize("n,t,kind,dtype,tail,batch", _TILE_CASES)
def test_tile_plain_matches_pallas_on_reference_tables(n, t, kind, dtype,
                                                       tail, batch):
    b = _ref_bmmc(kind, n, random.Random(n * 31 + t))
    plan = rtiling.plan_bmmc(b, t)[0]
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    jx, tx = _both(_payload(shape, dtype, n + t))
    want = rk.tiled_permute(jx, plan, interpret=True, batched=bool(batch))
    got = pk.tiled_permute(tx, _from_ref_tile(plan), batched=bool(batch))
    _assert_bitwise(want, got, (n, t, kind))
    # and the port's own planner drives the same output
    own = ptiling.plan_bmmc(_port_bmmc(b), t)[0]
    _assert_bitwise(want, pk.tiled_permute(tx, own, batched=bool(batch)),
                    (n, t, kind, "own plan"))


@pytest.mark.parametrize("dtype,tail,batch", [
    (np.float32, (), None), (ml_dtypes.bfloat16, (3,), None),
    (np.int32, (), 3)])
def test_block_plain_matches_pallas_on_reference_tables(dtype, tail, batch):
    n, t = 10, 3
    ident = tuple(1 << i for i in range(n))
    sub = RBmmc.random(n - 5, random.Random(4))
    b = RBmmc(ident[:5] + tuple(r << 5 for r in sub.rows), sub.c << 5)
    plan = rtiling.plan_block(b, t)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    jx, tx = _both(_payload(shape, dtype, 9))
    want = rk.block_permute(jx, plan, interpret=True, batched=bool(batch))
    port = ptiling.block_plan_from_arrays(plan.bmmc.rows, plan.bmmc.c,
                                          plan.b, plan.src_rows)
    _assert_bitwise(want, pk.block_permute(tx, port, batched=bool(batch)),
                    "block")
    _assert_bitwise(want, pk.block_permute_plain(tx, port,
                                                 batched=bool(batch)), "plain")


@pytest.mark.parametrize("dtype,tail,batch", [
    (np.float32, (), None), (ml_dtypes.bfloat16, (2,), None),
    (np.int32, (), 2)])
def test_lane_plain_matches_pallas_on_reference_tables(dtype, tail, batch):
    n, t = 10, 4
    ident = tuple(1 << i for i in range(n))
    sub = RBmmc.random(t, random.Random(8))
    b = RBmmc(tuple(sub.rows) + ident[t:], sub.c)
    plan = rtiling.plan_lane(b, t)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    jx, tx = _both(_payload(shape, dtype, 10))
    want = rk.lane_permute(jx, plan, interpret=True, batched=bool(batch))
    port = ptiling.lane_plan_from_arrays(plan.bmmc.rows, plan.bmmc.c, plan.t,
                                         plan.src_lane, plan.rows_per_block)
    _assert_bitwise(want, pk.lane_permute(tx, port, batched=bool(batch)),
                    "lane")


@pytest.mark.parametrize("size", [4096, 3 * 2048 + 37])
def test_copy_plain_matches_pallas_copy(size):
    arr = _payload((size,), np.float32, size)
    jx, tx = _both(arr)
    want = rk.copy_through_vmem(jx, interpret=True)
    _assert_bitwise(want, pk.copy_blocks(tx), size)
    assert pk.copy_pad_elems(size) == rk.copy_pad_elems(size)


# ---------------------------------------------------------------------------
# ops.bmmc_permute end to end
# ---------------------------------------------------------------------------

_E2E_KINDS = ("bitrev", "transpose", "reverse", "bpc", "bmmc", "block",
              "lane", "mixed", "identity", "high")


def _e2e_bmmc(kind, n, rng):
    ident = tuple(1 << i for i in range(n))
    if kind == "block":
        sub = RBmmc.random(n - n // 2, rng)
        return RBmmc(ident[:n // 2] + tuple(r << (n // 2) for r in sub.rows),
                     sub.c << (n // 2))
    if kind == "lane":
        sub = RBmmc.random(2, rng)
        return RBmmc(tuple(sub.rows) + ident[2:], sub.c)
    return {"bitrev": lambda: RBmmc.bit_reverse(n),
            "transpose": lambda: RBmmc.matrix_transpose(n // 2, n - n // 2),
            "reverse": lambda: RBmmc.reverse_array(n),
            "bpc": lambda: RBmmc.random_bpc(n, rng),
            "bmmc": lambda: RBmmc.random(n, rng),
            "mixed": lambda: RBmmc.xor_shift(n, 5 | (1 << (n - 2))),
            "identity": lambda: RBmmc.identity(n),
            "high": lambda: RBmmc.xor_shift(n, 3 << (n - 2))}[kind]()


@pytest.mark.parametrize("kind", _E2E_KINDS)
@pytest.mark.parametrize("dtype,tail,batch", [
    (np.float32, (), None), (ml_dtypes.bfloat16, (), None),
    (np.int32, (), None), (np.float32, (3,), None), (np.int32, (), 3),
    (ml_dtypes.bfloat16, (2,), 2)])
def test_bmmc_permute_matches_reference_gather(kind, dtype, tail, batch):
    n = 10
    b = _e2e_bmmc(kind, n, random.Random(17))
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    jx, tx = _both(_payload(shape, dtype, 3))
    want = rref.bmmc_ref(jx, b, batched=bool(batch))
    for t in (None, 2, 4):
        got = pops.bmmc_permute(tx, _port_bmmc(b), t=t, batched=bool(batch))
        _assert_bitwise(want, got, (kind, t))
    _assert_bitwise(want, pops.bmmc_permute(tx, _port_bmmc(b), engine="ref",
                                            batched=bool(batch)), "ref")


@pytest.mark.parametrize("kind,t", [("bmmc", 3), ("block", 2), ("lane", 2)])
def test_bmmc_permute_matches_reference_pallas_path(kind, t):
    """Same dispatch, same plans, same output as the reference's own
    class-dispatched Pallas path (interpret mode)."""
    n = 8
    b = _e2e_bmmc(kind, n, random.Random(23))
    jx, tx = _both(_payload((1 << n,), np.int32, 5))
    want = rops.bmmc_permute(jx, b, t=t)
    assert pops.class_plan(_port_bmmc(b), t)[0] == rops.class_plan(b, t)[0]
    _assert_bitwise(want, pops.bmmc_permute(tx, _port_bmmc(b), t=t), kind)


def test_dispatch_counters_equal_reference():
    """The telemetry of one dispatch per class: kernel and class counts,
    modeled descriptors and round trips, key for key."""
    n = 8
    rng = random.Random(29)
    cases = [(_e2e_bmmc(k, n, rng), t) for k, t in
             (("bmmc", 3), ("block", 2), ("lane", 2), ("mixed", 2),
              ("identity", 2))]
    # cold plan caches in both packages, so each counts its plan store's
    # builds (store.plan_built) for the same plans
    rops._class_plan_cached.cache_clear()
    pops._class_plan_cached.cache_clear()
    robs.reset()
    pobs.reset()
    robs.enable()
    pobs.enable()
    try:
        for b, t in cases:
            arr = _payload((1 << n,), np.float32, 1)
            jx, tx = _both(arr)
            rops.bmmc_permute(jx, b, t=t)
            pops.bmmc_permute(tx, _port_bmmc(b), t=t)
        # the tiny-array rule: t > n/2 falls back to the gather in both
        jx, tx = _both(_payload((16,), np.int32, 2))
        b = RBmmc.random(4, rng)
        rops.bmmc_permute(jx, b, t=3)
        pops.bmmc_permute(tx, _port_bmmc(b), t=3)
        assert pobs.counter_value("store.plan_built", kind="class") > 0
        assert pobs.counters() == robs.counters()
        assert pobs.kernel_counts() == robs.kernel_counts()
        assert pobs.class_counts() == robs.class_counts()
    finally:
        robs.disable()
        pobs.disable()
        robs.reset()
        pobs.reset()


def test_port_moves_every_nan_payload():
    """Every bit pattern survives the port's paths: bfloat16 NaN payloads
    (signaling and quiet) and -0.0 included."""
    arr = _payload((4, 1 << 10), ml_dtypes.bfloat16, 6, quiet=False)
    arr.view(np.uint16)[0, :3] = (0x7F81, 0xFF90, 0x8000)
    x = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    for b in (PBmmc.random(10, random.Random(6)), PBmmc.bit_reverse(10)):
        want = pref.bmmc_ref(x, b, batched=True).view(torch.int16)
        got = pops.bmmc_permute(x, b, t=3, batched=True).view(torch.int16)
        assert torch.equal(got, want)
        src = torch.from_numpy(pref.bmmc_indices(b)).long()
        assert torch.equal(want, x.view(torch.int16)[:, src])


def test_device_oracle_matches_host_oracle():
    rng = random.Random(31)
    for n in (3, 9, 12):
        b = _port_bmmc(RBmmc.random(n, rng))
        x = torch.from_numpy(_payload((2, 1 << n), np.int32, n))
        want = pref.bmmc_ref(x, b, batched=True)
        assert torch.equal(pref.bmmc_ref_device(x, b, batched=True, chunk=100),
                           want)
        assert torch.equal(pref.bmmc_src_index(b, "cpu"),
                           torch.from_numpy(pref.bmmc_indices(b)).long())
        assert np.array_equal(pref.bmmc_indices(b),
                              rref.bmmc_indices(RBmmc(b.rows, b.c)))
        assert pref.audit_src_table(b) is not None


# ---------------------------------------------------------------------------
# refusals: no epilogue, no quiet fallback, guarded launches
# ---------------------------------------------------------------------------

def test_tile_epilogue_raises_not_implemented():
    """Every compute epilogue is ported (K4b, ``tests/test_torch_fused.py``
    and ``tests/test_torch_map_epilogue.py``), ``map`` included: on a CPU
    tensor its function runs on the tile. What the wrapper still refuses
    raises ValueError: a map without its function, and one that turns the
    tile into another dtype."""
    plan = ptiling.plan_bmmc(PBmmc.bit_reverse(8), 3)[0]
    x = torch.arange(256, dtype=torch.float32)
    kw = dict(geometry=pk.plan_geometry(plan), epilogue=(("map", "neg"),),
              epi_scalar=((),), epi_vmem=((),))
    tabs = (plan.in_rows, plan.out_rows, plan.xor_low, plan.src0)
    got = pk.tiled_permute_tables(x, *tabs, map_fns=(torch.neg,), **kw)
    assert torch.equal(got, -pk.tiled_permute(x, plan))
    with pytest.raises(ValueError, match="map_fns"):
        pk.tiled_permute_tables(x, *tabs, **kw)
    with pytest.raises(ValueError, match="turned"):
        pk.tiled_permute_tables(x, *tabs, map_fns=(torch.Tensor.double,),
                                **dict(kw, epilogue=(("map", "f64"),)))


def test_device_cache_keeps_no_value_larger_than_itself():
    """A value larger than the whole store is returned and not kept (an
    active pin still holds it, for the graph that reads it); smaller ones
    are kept and evicted oldest first."""
    cache = pk._DeviceCache(max_bytes=64)
    big = cache.get(None, "big", "cpu", lambda: torch.zeros(32))  # 128 B
    assert big.numel() == 32 and cache.cache_info()[3] == 0
    small = [cache.get(None, k, "cpu", lambda: torch.zeros(4))   # 16 B
             for k in range(5)]
    assert cache.cache_info()[3] == 4
    assert cache.get(None, 4, "cpu", lambda: None) is small[4]
    with pk.pin_device_tables() as pinned:
        again = cache.get(None, "big", "cpu", lambda: torch.ones(32))
    assert cache.cache_info()[3] == 4
    assert [v for _, v in pinned.values()] == [again]


def test_no_kernel_for_other_devices():
    plan = ptiling.plan_bmmc(PBmmc.bit_reverse(8), 3)[0]
    x = torch.empty(256, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        pk.tiled_permute(x, plan)
    with pytest.raises(ValueError, match="no kernel for device"):
        pk.copy_blocks(x)


def test_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(pbuild, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(pbuild, "_libs", {})
    with pytest.raises(pbuild.KernelBuildError):
        pbuild.load("tile")
    assert not list(tmp_path.glob("*.so"))


def test_guarded_launch_refuses_out_of_bounds_table():
    import dataclasses
    plan = ptiling.plan_bmmc(PBmmc.random(8, random.Random(2)), 3)[0]
    bad = plan.out_rows.copy()
    bad[0, 0] = 1 << 8
    poisoned = dataclasses.replace(plan, out_rows=bad)
    x = torch.arange(256, dtype=torch.int32)
    with pguard.guarded():
        with pytest.raises(pguard.DescriptorOOB):
            pk.tiled_permute(x, poisoned)
    assert not pguard.enabled()


def test_choose_tile_fits_shared_memory():
    assert pops.choose_tile(30, 4) == 6
    assert pops.choose_tile(30, 2) == 6
    assert pops.choose_tile(30, 4, 8) == 4
    assert pops.choose_tile(8, 4) == 4
    assert pops.choose_tile(1, 4) is None
    assert pops.choose_tile(8, 4, t=5) is None
    for n, item, d in ((30, 4, 1), (20, 2, 3), (16, 8, 2)):
        t = pops.choose_tile(n, item, d)
        assert (1 << (2 * t)) * item * d <= pops._SMEM_TILE_BYTES


def test_wrong_axis_length_raises_bad_input():
    b = PBmmc.bit_reverse(8)
    for x, batched in ((torch.zeros(128), False), (torch.zeros(256, 2), True),
                       (torch.zeros(()), False)):
        for engine in ("cuda", "ref"):
            with pytest.raises(pguard.BadInput):
                pops.bmmc_permute(x, b, engine=engine, batched=batched)
    with pytest.raises(pguard.UnknownEngine):
        pops.bmmc_permute(torch.zeros(256), b, engine="pallas")


def test_num_passes_and_closure_match_reference():
    rng = random.Random(37)
    for n, t in ((8, 3), (10, 2), (9, 4)):
        b = RBmmc.random(n, rng)
        assert pops.num_passes(_port_bmmc(b), t) == rops.num_passes(b, t)
        fn = pops.make_bmmc_permute(_port_bmmc(b), t=t)
        x = torch.from_numpy(_payload((1 << n,), np.int32, n))
        assert torch.equal(fn(x), pref.bmmc_ref(x, _port_bmmc(b)))


def test_obs_report_snapshot_and_trace_export(tmp_path):
    import json
    pobs.reset()
    pobs.enable()
    try:
        x = torch.from_numpy(_payload((1 << 8,), np.int32, 4))
        pops.bmmc_permute(x, PBmmc.bit_reverse(8), t=3)
        snap = pobs.snapshot()
        assert snap["kernel_counts"] == {"tiled": 1}
        assert snap["model_vs_measured"]["modeled_round_trips"] == 1
        assert "kernel dispatches" in pobs.report()
        path = pobs.export_trace(str(tmp_path / "t.json"))
        events = json.load(open(path))["traceEvents"]
        assert [e["name"] for e in events] == ["kernel.dispatch"]
        assert events[0]["args"]["kernel"] == "tiled"
    finally:
        pobs.disable()
        pobs.reset()
