"""Rings 2 and 3 of the PyTorch port's guard (``repro_torch.guard.runtime``
and ``.inject``) held against the JAX reference on the CPU, where every
guarded kernel runs its guarded plain version.

* ``resolve_flags`` and ``TRAP_KINDS`` equal the reference's.
* A guarded call's output is bit-equal to the unguarded call's and to the
  reference's unguarded output, with no trap, no fallback and the breaker
  board closed. (The reference's guarded ``ops.bmmc_permute`` recurses
  into itself under its own jit on this tree, so the reference's
  unguarded output is the oracle.)
* A poisoned table traps, falls back to ``ref`` and recovers, with the
  guard's counters equal to the reference's ``guarded_call`` in the same
  case: the port records the out-of-bounds trap only, where the
  reference's clamped gather may also trip its parity probe (the port's
  guarded kernel never makes the out-of-range read).
* ``run_fault_matrix`` catches every kind with the reference's verdicts,
  on both engines.
* The guarded plain versions of K2, K3, K4a and K4b set bit 1 exactly
  when an entry of a table is out of range, skip exactly the accesses it
  addresses (an independent numpy model of the guarded schedule), and
  equal the unguarded plain versions on clean tables.

Inputs are made with numpy from a seed and handed to both packages.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro import guard as rguard
from repro import resilience as rres
from repro.combinators import vocab as RV
from repro.core.bmmc import Bmmc as RBmmc
from repro.guard import inject as rinject
from repro.guard import runtime as rrt
from repro.kernels import ops as rops
import repro_torch.combinators as pc
from repro_torch import guard as pguard
from repro_torch import resilience as pres
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.fft import fft_expr as p_fft_expr
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.guard import inject as pinject
from repro_torch.guard import runtime as prt
from repro_torch.guard import validate as pv
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref


@pytest.fixture(autouse=True)
def _clean():
    pguard.disable()
    rguard.disable()
    pex.clear_caches()
    rres.reset()
    rguard.reset_stats()
    rinject._fresh_guard_state()
    yield
    pguard.disable()
    rguard.disable()
    pex.clear_caches()
    rres.reset()
    rguard.reset_stats()
    rinject._fresh_guard_state()


def test_flags_vocabulary_equals_the_reference():
    assert prt.TRAP_KINDS == rrt.TRAP_KINDS
    for mask in range(8):
        assert prt.resolve_flags(mask) == rrt.resolve_flags(mask)
    assert pinject.FAULT_KINDS == rinject.FAULT_KINDS
    assert pinject.STORE_FAULT_KINDS == rinject.STORE_FAULT_KINDS


def _bmmcs(n: int, t: int):
    """(name, reference BMMC, port BMMC) of each dispatch case."""
    rows = [1 << i for i in range(n)]
    rng = random.Random(9)
    hi = rows[t:]
    rng.shuffle(hi)
    lo = rows[:t]
    rng.shuffle(lo)
    rb = RBmmc.random(n, random.Random(4))
    bpc = RBmmc.random_bpc(n, random.Random(5))
    cases = [("bit-reverse", RBmmc.bit_reverse(n)),
             ("block", RBmmc(tuple(rows[:t] + hi), 5 << t)),
             ("lane", RBmmc(tuple(lo + rows[t:]), 3)),
             ("bpc", bpc), ("general", rb)]
    return [(name, b, PBmmc(b.rows, b.c)) for name, b in cases]


def _board_closed() -> bool:
    return not pres.board().engaged("cuda") and not pres.board().snapshot()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_guarded_bmmc_permute_equals_unguarded_and_the_reference(dtype):
    n = 8
    x = np.random.default_rng(2).integers(-2**31, 2**31 - 1, 1 << n,
                                          dtype=np.int64).astype(np.int32)
    x = x.view(dtype)
    xt = torch.from_numpy(x.copy())
    t = pops.choose_tile(n, 4)
    for name, rb, pb in _bmmcs(n, t):
        want = np.asarray(rops.bmmc_permute(jnp.asarray(x), rb,
                                            engine="pallas"))
        plain = pops.bmmc_permute(xt, pb)
        with pguard.guarded():
            got = pops.bmmc_permute(xt, pb)
            got_ref = pops.bmmc_permute(xt, pb, engine="ref")
        for y in (plain, got, got_ref):
            assert np.array_equal(y.numpy().view(np.int32),
                                  want.view(np.int32)), name
    s = pguard.stats()
    assert s["traps"] == {} and s["fallbacks"] == {} and s["raised"] == {}
    assert _board_closed()


def test_guarded_programs_equal_unguarded_and_the_reference():
    n = 8
    rng = np.random.default_rng(6)
    keys = rng.permutation(1 << n).astype(np.int32)
    floats = rng.standard_normal(1 << n).astype(np.float32)
    planar = rng.standard_normal((1 << n, 2)).astype(np.float32)
    from repro.combinators.fft import fft_expr as r_fft_expr
    from repro.combinators.sort import sort_expr as r_sort_expr
    for rexpr, pexpr, x, exact in (
            (r_sort_expr(n), p_sort_expr(n), keys, True),
            (r_sort_expr(n), p_sort_expr(n), floats, True),
            (RV.bit_reverse(n) >> RV.transpose(4, 4),
             PV.bit_reverse(n) >> PV.transpose(4, 4), floats, True),
            (r_fft_expr(n), p_fft_expr(n), planar, False)):
        f = pc.compile_expr(pexpr)
        xt = torch.from_numpy(x.copy())
        plain = f(xt)
        with pguard.guarded():
            got = f(xt)
            again = f(xt)
        want = np.asarray(rc.compile_expr(rexpr, engine="pallas")(
            jnp.asarray(x)))
        assert torch.equal(got, plain) and torch.equal(again, plain)
        if exact:
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    s = pguard.stats()
    assert s["traps"] == {} and s["fallbacks"] == {}
    assert _board_closed()


def test_poisoned_table_traps_falls_back_with_the_reference_counters():
    n = 6
    bmmc_p, bmmc_r = PBmmc.bit_reverse(n), RBmmc.bit_reverse(n)
    xp = torch.arange(1 << n, dtype=torch.float32)
    xr = jnp.arange(1 << n, dtype=jnp.float32)
    pf = pc.compile_expr(PV.bit_reverse(n), optimize=False)
    rf = rc.compile_expr(RV.bit_reverse(n), engine="pallas", optimize=False)
    pt, rt = pops.choose_tile(n, 4), rops.choose_tile(n, 4)
    with pguard.guarded():
        pf(xp)
        with pinject.poison_plan(bmmc_p, pt):
            y = pf(xp)
    with rguard.guarded():
        rf(xr)
        with rinject.poison_plan(bmmc_r, rt):
            rinject._clear_runtime_only()
            yr = rf(xr)
    assert np.array_equal(y.numpy(), np.asarray(yr))
    got, want = pguard.stats(), rguard.stats()
    assert got["traps"] == {("oob", "cuda"): 1}
    assert want["traps"][("oob", "pallas")] == 1
    for k in ("fallbacks", "recovered", "raised", "store_quarantined"):
        assert got[k] == want[k], k
    assert got["fallbacks"] == {"ref": 1} and got["recovered"] == 1


def test_poisoned_kernel_and_ref_tables_raise_cache_poisoned():
    n = 6
    b = PBmmc.bit_reverse(n)
    x = torch.arange(1 << n, dtype=torch.float32)
    f = pc.compile_expr(PV.bit_reverse(n), optimize=False)
    t = pops.choose_tile(n, 4)
    with pguard.guarded():
        f(x)
        with pinject.poison_plan(b, t), pinject.poison_ref_table(b):
            with pytest.raises(pguard.CachePoisoned):
                f(x)
        fr = pc.compile_expr(PV.bit_reverse(n), engine="ref", optimize=False)
        with pinject.poison_ref_table(b):
            with pytest.raises(pguard.GuardTrap):
                fr(x)   # the engine of last resort traps: no fallback
    s = pguard.stats()
    assert s["raised"] == {"CachePoisoned": 1, "GuardTrap": 1}


def test_device_copy_poisoning_is_seen_by_the_fingerprints():
    n, t = 8, 3
    b = PBmmc.bit_reverse(n)
    pv.validate_dispatch(b.rows, b.c, t)
    plan = pops.class_plan(b, t)[1][0]
    prog = (pc.Perm(b),)
    assert pv.check_fingerprints(prog, t) == []
    pk.device_tables(plan, torch.device("cpu"))   # a kept device copy
    assert pv.check_fingerprints(prog, t) == []
    with pinject.poison_device_table(plan, "cpu"):
        assert pv.check_fingerprints(prog, t) == [("class", b.rows, b.c, t)]
        flags = torch.zeros(1, dtype=torch.int32)
        tabs = pk.device_tables(plan, torch.device("cpu"))
        pk.tiled_permute_tables(torch.arange(1 << n), *tabs,
                                geometry=pk.plan_geometry(plan), flags=flags)
        assert int(flags) == 1
    assert pv.check_fingerprints(prog, t) == []


@pytest.mark.parametrize("engine", ["cuda", "ref"])
def test_fault_matrix_equals_the_reference(engine):
    got = pinject.run_fault_matrix(engine, n=6, device="cpu")
    want = rinject.run_fault_matrix("pallas" if engine == "cuda"
                                    else "ref", n=6)
    assert got["injected"] == got["caught"] == len(pinject.FAULT_KINDS)
    assert [(c["kind"], c["caught"], c["how"]) for c in got["cases"]] == [
        (c["kind"], c["caught"], c["how"]) for c in want["cases"]]


def test_validate_input_equals_the_reference():
    for shape, batched, n in (((8,), False, None), ((8, 2), False, 3),
                              ((2, 8), True, None), ((24,), False, None),
                              ((), False, None), ((8, 2, 2), False, None),
                              ((8,), False, 4), ((2,), True, None)):
        try:
            want = ("ok", rguard.validate_input(shape, np.float32,
                                                batched=batched, n=n))
        except rguard.BadInput:
            want = ("BadInput",)
        try:
            got = ("ok", pguard.validate_input(shape, torch.float32,
                                               batched=batched, n=n))
        except pguard.BadInput:
            got = ("BadInput",)
        assert got == want, shape


def test_guards_off_is_a_noop_and_stats_surface():
    x = torch.arange(256.0)
    f = pc.compile_expr(PV.bit_reverse(8))
    y = f(x)
    s = pguard.stats()
    assert s["traps"] == {} and s["fallbacks"] == {} and s["recovered"] == 0
    with pguard.guarded():
        assert torch.equal(f(x), y)
    cs = pex.cache_stats()
    assert cs["guard_program"].currsize == 1 and "store" in cs
    pex.clear_caches()
    assert pex.cache_stats()["guard_program"].currsize == 0


# ---------------------------------------------------------------------------
# the guarded plain versions, against an independent numpy model
# ---------------------------------------------------------------------------

def _model_tile(x, in_rows, out_rows, xor_low, src0, n, t, rpt):
    """The guarded K4a schedule, element by element, in numpy: (out, the
    mask of written outputs, flag)."""
    row_len, n_rows = 1 << t, 1 << (n - t)
    out = np.zeros_like(x)
    written = np.zeros(x.shape[0], bool)
    flag = 0
    for g in range(in_rows.shape[0]):
        rows_ok = [(0 <= v < n_rows) for v in in_rows[g]]
        flag |= not all(rows_ok) or not all(0 <= v < n_rows
                                            for v in out_rows[g])
        xl_ok = 0 <= xor_low[g] < row_len
        flag |= not xl_ok
        for j in range(rpt * row_len):
            rp, cp = divmod(j, row_len)
            val = 0
            if xl_ok:
                s = int(src0.reshape(-1)[(rp << t) | (cp ^ int(xor_low[g]))])
                if 0 <= s < rpt * row_len:
                    r, c = divmod(s, row_len)
                    if rows_ok[r]:
                        val = x[int(in_rows[g, r]) * row_len + c]
                else:
                    flag = 1
            orow = int(out_rows[g, rp])
            if 0 <= orow < n_rows:
                out[orow * row_len + cp] = val
                written[orow * row_len + cp] = True
    flag |= bool(((src0 < 0) | (src0 >= rpt * row_len)).any())
    return out, written, int(flag)


@pytest.mark.parametrize("table,value", [
    (None, 0), ("in_rows", -1), ("in_rows", 10**6), ("out_rows", 99),
    ("xor_low", 8), ("xor_low", -3), ("src0", 64), ("src0", -1)])
def test_guarded_tile_plain_sets_bit1_exactly_on_a_bad_entry(table, value):
    n, t = 8, 3
    plan = pops.class_plan(PBmmc.bit_reverse(n), t)[1][0]
    tabs = {k: getattr(plan, k).copy()
            for k in ("in_rows", "out_rows", "xor_low", "src0")}
    if table is not None:
        tabs[table].reshape(-1)[1 % tabs[table].size] = value
    x = np.random.default_rng(1).integers(0, 1 << 20, 1 << n).astype(
        np.int32)
    flags = torch.zeros(1, dtype=torch.int32)
    got = pk.tiled_permute_tables(
        torch.from_numpy(x), *(tabs[k] for k in ("in_rows", "out_rows",
                                                  "xor_low", "src0")),
        geometry=pk.plan_geometry(plan), flags=flags).numpy()
    want, written, flag = _model_tile(
        x, tabs["in_rows"], tabs["out_rows"], tabs["xor_low"], tabs["src0"],
        n, t, plan.rows_per_tile)
    assert int(flags) == flag == (table is not None)
    assert np.array_equal(got[written], want[written])
    if table is None:
        assert written.all()
        assert np.array_equal(got, pk.tiled_permute_plain(
            torch.from_numpy(x), plan).numpy())


@pytest.mark.parametrize("value", [None, -1, 128, 10**6])
def test_guarded_block_and_lane_plain_set_bit1_exactly(value):
    n, t = 10, 3
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1 << 20, (3, 1 << n)).astype(np.int32))
    rows = [1 << i for i in range(n)]
    blk = pops.class_plan(PBmmc(tuple(rows[:t] + rows[t:][::-1]), 0), t)
    lane = pops.class_plan(PBmmc(tuple(rows[:t][::-1] + rows[t:]), 0), t)
    assert blk[0] == "block" and lane[0] == "lane"
    for kernel, plan, wrap, key in (
            ("block", blk[1], pk.block_permute_plain, "src_rows"),
            ("lane", lane[1], pk.lane_permute_plain, "src_lane")):
        tab = getattr(plan, key).copy()
        if value is not None:
            tab[2] = value
        flags = torch.zeros(1, dtype=torch.int32)
        got = wrap(x, plan, batched=True, flags=flags, **{key: tab})
        clean = wrap(x, plan, batched=True)
        assert int(flags) == (value is not None), kernel
        if kernel == "block":
            blk_len = 1 << plan.b
            g = got.reshape(3, -1, blk_len)
            want = clean.reshape(3, -1, blk_len).clone()
            if value is not None:
                want[:, 2] = 0
            assert torch.equal(g, want)
        else:
            g = got.reshape(3, -1, 1 << t)
            want = clean.reshape(3, -1, 1 << t).clone()
            if value is not None:
                want[:, :, 2] = 0
            assert torch.equal(g, want)


def test_guarded_fused_plain_equals_unguarded_and_traps_on_a_bad_row():
    n = 8
    f = pc.compile_expr(p_sort_expr(n))
    t = pops.choose_tile(n, 4)
    prog = f.clustered_program(n, t)
    fs = next(s for s in prog if isinstance(s, pc.FusedStage) and s.computes)
    plans, entries = pex._fused_plan_cached(fs, t)
    plan = plans[0]
    x = torch.from_numpy(np.random.default_rng(3).permutation(
        1 << n).astype(np.int32))
    tabs, epi = pex._pass_tables(plan, entries, x)
    geo = pk.plan_geometry(plan)
    clean = pk.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    flags = torch.zeros(1, dtype=torch.int32)
    got = pk.tiled_permute_tables(x, *tabs, geometry=geo, flags=flags, **epi)
    assert int(flags) == 0 and torch.equal(got, clean)
    bad = plan.out_rows.copy()
    bad[0, 0] = -5
    got = pk.tiled_permute_tables(x, tabs[0], bad, tabs[2], tabs[3],
                                  geometry=geo, flags=flags, **epi)
    assert int(flags) == 1
    # every output row but the one the bad entry addressed is written
    row_len = 1 << t
    skip = np.zeros(1 << n, bool)
    skip[plan.out_rows[0, 0] * row_len:(plan.out_rows[0, 0] + 1)
         * row_len] = True
    assert torch.equal(got[torch.from_numpy(~skip)],
                       clean[torch.from_numpy(~skip)])


def test_guarded_ref_clamps_and_flags():
    b = PBmmc.bit_reverse(6)
    x = torch.arange(64.0)
    flags = torch.zeros(1, dtype=torch.int32)
    with pk.guard_flags(flags):
        assert torch.equal(pref.bmmc_ref(x, b), pref.bmmc_ref(x, b))
    assert int(flags) == 0
    with pinject.poison_ref_table(b):
        with pk.guard_flags(flags):
            y = pref.bmmc_ref(x, b)
    assert int(flags) == 1 and y.shape == x.shape
