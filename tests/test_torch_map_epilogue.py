"""``Map`` epilogues of the PyTorch port (K4b and K5) held against the JAX
reference on the CPU.

A ``Map``'s torch function runs inside the fused kernels as the tape
``kernels/map_lower.py`` lowers it to; the kernels themselves run only on
the card, and their plain versions (what a CPU tensor runs) call the
function, as the reference's kernel does. Here:

* the lowering: for each op of the list, in each dtype it takes, the
  tape's plain emulation (the ops one by one, as the kernels run them)
  equals the function bit for bit, and the tape's reverse mode (K5's
  arithmetic, rounded as eager autograd rounds on the tensor's device)
  equals autograd within 1e-6 relative plus 1e-6 absolute (float32) or
  one bfloat16 ulp; functions outside the list, whose trace fails, that
  change dtype, whose float32 and bfloat16 traces differ or that are too
  long are not lowered; tapes are cached per name and dtype, each
  holding its function, in a bounded cache; the raw wrappers run the
  function they are given; a bfloat16 chain rounds after each op;
* K4b's plain version with maps equals the reference's
  ``tiled_permute_tables(..., map_fns=...)`` in Pallas interpret mode:
  int32 bit for bit, float32 within 1e-6 (torch's and XLA's ``tanh`` on
  the CPU differ by ulps), bfloat16 within one ulp (XLA may keep a fused
  chain of bfloat16 ops in float32);
* K5's plain version with maps equals the reference's
  ``_fused_bwd_pallas`` within 1e-5 relative plus 1e-6 absolute (the
  tolerance of ``tests/test_torch_autodiff.py``);
* the program ``riffle >> emap(tanh) >> bit_reverse >> emap(sq)``
  (the reference's ``tests/test_autodiff.py``) forward and ``grad``
  against ``jax.grad`` with that tolerance, an int32 program with maps
  bit for bit, each with its maps fused (no fused fallback) and its
  counted round trips equal to ``program_cost`` and ``vjp_round_trips``.

Inputs are made with numpy from a seed and handed to both packages.
"""
import random

import jax
import jax.numpy as jnp
import ml_dtypes
import functools

import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators import vocab as RV
from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels import bmmc_permute as rk
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import epilogue_plan as EP
from repro_torch.kernels import map_lower as ML
from repro_torch.kernels.ops import choose_tile

BF16 = np.dtype(ml_dtypes.bfloat16)
F32, BF, I32 = torch.float32, torch.bfloat16, torch.int32

# name, function, the dtypes it lowers for, its tape length
LISTED = [
    ("add", lambda v: v + 3, (F32, BF, I32), 1),
    ("add_self", lambda v: v + v * 3, (F32, BF, I32), 2),
    ("sub", lambda v: v - 2, (F32, BF, I32), 1),
    ("rsub", lambda v: 1 - v, (F32, BF, I32), 1),
    ("mul", lambda v: v * v, (F32, BF, I32), 1),
    ("div", lambda v: v / 3, (F32, BF), 1),
    ("div_self", lambda v: v / (v * v + 1), (F32, BF), 3),
    ("neg", torch.neg, (F32, BF, I32), 1),
    ("abs", torch.abs, (F32, BF, I32), 1),
    ("clamp", lambda v: v.clamp(-1, 1), (F32, BF, I32), 2),
    ("clamp_min", lambda v: torch.clamp(v, min=0.3), (F32, BF), 1),
    ("clamp_max", lambda v: torch.clamp(v, max=-2), (F32, BF, I32), 1),
    ("relu", torch.relu, (F32, BF, I32), 1),
    ("exp", lambda v: torch.exp(v * 0.5), (F32, BF), 2),
    ("expm1", torch.expm1, (F32, BF), 1),
    ("log", lambda v: torch.log(v * v + 0.5), (F32, BF), 3),
    ("log1p", lambda v: torch.log1p(torch.abs(v)), (F32, BF), 2),
    ("sqrt", lambda v: torch.sqrt(torch.abs(v)), (F32, BF), 2),
    ("rsqrt", lambda v: torch.rsqrt(torch.abs(v) + 1), (F32, BF), 3),
    ("tanh", torch.tanh, (F32, BF), 1),
    ("sigmoid", torch.sigmoid, (F32, BF), 1),
    ("silu", lambda v: v * torch.sigmoid(v), (F32, BF), 2),
    ("not", torch.bitwise_not, (I32,), 1),
    ("and", lambda v: v & 0x0F0F, (I32,), 1),
    ("or", lambda v: v | 6, (I32,), 1),
    ("xor", lambda v: v ^ -7, (I32,), 1),
    ("shl", lambda v: v << 5, (I32,), 1),
    ("shr", lambda v: v >> 3, (I32,), 1),
    ("wrap", lambda v: v * 1000003 + 7, (F32, BF, I32), 2),
    # DAG tapes: a value read by two ops, and a chain past 8 ops
    ("two_branches", lambda v: torch.tanh(v) * torch.exp(v), (F32, BF), 3),
    ("too_long", lambda v: ((((v + 1) * 2 + 3) * 4 + 5) * 6 + 7) * 8 + 9,
     (F32, BF, I32), 9),
]


def _inputs(dtype, seed, size=2048):
    rng = np.random.default_rng(seed)
    if dtype == I32:
        return torch.from_numpy(rng.integers(-2**31, 2**31, size).astype(
            np.int32))
    v = (rng.normal(size=size) * 3).astype(np.float32)
    v[:4] = [0.0, -0.0, 1.0, -1.0]
    return torch.from_numpy(v).to(dtype)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("name,fn,dtypes,length", LISTED,
                         ids=[c[0] for c in LISTED])
def test_each_listed_op_lowers_and_its_tape_equals_the_function(
        name, fn, dtypes, length):
    for dtype in (F32, BF, I32):
        tape = ML.lower_map(name, fn, dtype)
        assert tape.lowered == (dtype in dtypes), (name, dtype)
        if not tape.lowered:
            continue
        assert len(tape.ops) == length
        # the gradient mask, a word an op, two words a constant
        assert len(ML.tape_words(tape)) == 1 + length + 2 * len(
            ML.tape_constants(tape))
        u = _inputs(dtype, seed=len(name))
        assert torch.equal(_bits(ML.eval_tape(tape, u)), _bits(fn(u)))
        if dtype == I32:
            continue
        ct = torch.from_numpy(np.random.default_rng(7).normal(
            size=u.shape).astype(np.float32)).to(dtype)
        uu = u.clone().requires_grad_(True)
        want = torch.autograd.grad(fn(uu), uu, ct)[0].float()
        got = ML.tape_vjp(tape, u, ct).float()
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)), name
        tol = 1e-6 if dtype == F32 else 2 ** -7
        assert torch.allclose(got[fin], want[fin], rtol=tol, atol=1e-6), name


@pytest.mark.parametrize("name,fn", [
    ("sort", lambda v: torch.sort(v).values),
    ("item", lambda v: v * float(v.sum())),
    ("branch", lambda v: v if bool((v > 0).all()) else -v),
    ("to_float", lambda v: v.to(torch.float64)),
    # tan, erfinv and casts lower since typed tapes; the cases keep their
    # ids and hold functions still outside the list
    pytest.param("digamma", torch.digamma, id="tan-tan"),
    ("tensor_const", lambda v: torch.maximum(v, torch.tensor(0.0))),
    ("reduce", lambda v: v - v.sum()),
    ("ops_33", lambda v: functools.reduce(lambda a, k: a * 1.5 + k,
                                          range(16), v) + 1),
    ("cast", lambda v: v.to(torch.complex64).real.to(v.dtype)),
    pytest.param("lgamma", torch.lgamma, id="erfinv-erfinv"),
])
def test_functions_outside_the_list_are_not_lowered(name, fn):
    for dtype in (F32, BF):
        assert not ML.lower_map(name, fn, dtype).lowered, (name, dtype)


def test_tapes_are_cached_by_name_and_dtype_and_cleared():
    pex.clear_caches()
    a = ML.lower_map("cached", torch.tanh, F32)
    assert ML.lower_map("cached", torch.tanh, F32) is a
    assert ML.lower_map("cached", torch.tanh, BF) is not a
    # another function under a cached name is lowered anew: the tape
    # returned always holds the function it was given
    b = ML.lower_map("cached", torch.neg, F32)
    assert b.fn is torch.neg and b.ops != a.ops
    assert ML.lower_map("cached", torch.neg, F32) is b
    st = pex.cache_stats()["map_tapes"]
    assert (st.hits, st.misses, st.currsize) == (2, 3, 2)
    for k in range(ML._CACHE_MAX + 5):           # the cache is bounded
        ML.lower_map(f"bound{k}", torch.neg, F32)
    assert pex.cache_stats()["map_tapes"].currsize == ML._CACHE_MAX
    pex.clear_caches()
    assert pex.cache_stats()["map_tapes"].currsize == 0


def test_a_float_map_lowers_for_both_float_types_or_neither():
    def by_dtype(v):   # a trace that depends on the dtype
        return torch.tanh(v) if v.dtype == F32 else torch.exp(v)
    for dtype in (F32, BF):
        assert not ML.lower_map("by_dtype", by_dtype, dtype).lowered
    # a clamp bound rounds to bfloat16 but keeps the ops: both lower
    assert ML.lower_map("clamp3", lambda v: v.clamp(max=0.3), BF).lowered


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference
# ---------------------------------------------------------------------------

def _to_torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


# the maps of each dtype, a torch function and its jnp twin
MAPS = {
    np.float32: (("tanh", torch.tanh, jnp.tanh),
                 ("sq", lambda v: v * v, lambda v: v * v)),
    np.int32: (("wrap", lambda v: v * 1000003 + 7,
                lambda v: v * 1000003 + 7),
               ("not", torch.bitwise_not, jnp.bitwise_not)),
    BF16: (("affine", lambda v: (v * 3 + 1) * 0.5,
            lambda v: (v * 3 + 1) * 0.5),
           ("neg", torch.neg, jnp.negative)),
}


def _map_program(V, Bmmc, n, dtype, torch_side):
    """Perm, compare, map, perm, compare, map, perm: clusters that hold a
    map between two compares and a map at their end."""
    (n1, t1, j1), (n2, t2, j2) = MAPS[dtype]
    f1, f2 = (t1, t2) if torch_side else (j1, j2)
    rng = random.Random(9)
    return V.seq(V.perm(Bmmc.random_bpc(n, rng)), V.cmp_halves(),
                 V.emap(n1, f1), V.perm(Bmmc.random_bpc(n, rng)),
                 V.cmp_halves(), V.emap(n2, f2),
                 V.perm(Bmmc.random(n, rng)))


def _map_clusters(n, t, dtype):
    rp = rc.compile_expr(_map_program(RV, RBmmc, n, dtype, False),
                         engine="pallas").clustered_program(n, t)
    pp = pc.compile_expr(_map_program(PV, PBmmc, n, dtype, True),
                         engine="cuda").clustered_program(n, t)
    rf = [s for s in rp if isinstance(s, rc.FusedStage) and s.computes]
    pf = [s for s in pp if isinstance(s, pc.FusedStage) and s.computes]
    assert len(rf) == len(pf) > 0
    pairs = [(r, p) for r, p in zip(rf, pf)
             if any(isinstance(c, pc.Map) for c, _ in p.computes)]
    assert pairs
    return pairs


def _values(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31, size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _assert_close(got, want, dtype, rtol=None):
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.int32:
        assert np.array_equal(got, want)
        return
    tol = rtol or (1e-6 if dtype == np.float32 else 2 ** -7)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=tol, atol=1e-6)


@pytest.mark.parametrize("dtype,shape,batched", [
    (np.float32, (1 << 8,), False), (np.int32, (1 << 8,), False),
    (BF16, (1 << 8,), False), (np.float32, (3, 1 << 8), True),
    (np.int32, (1 << 8, 3), False)])
def test_map_epilogues_match_reference(dtype, shape, batched):
    n, t = 8, 4
    for rfs, pfs in _map_clusters(n, t, dtype):
        x = _values(shape, dtype, seed=len(pfs.stages))
        rplans, rents = rex._fused_plan_cached(rfs, t)
        rsig, rscal, rvm, rmaps = rex._fused_kernel_args(rents, dtype)
        rp = rplans[0]
        want = np.asarray(rk.tiled_permute_tables(
            jnp.asarray(x), rp.in_rows, rp.out_rows, rp.xor_low, rp.src0,
            geometry=rk.plan_geometry(rp), epilogue=rsig, epi_scalar=rscal,
            epi_vmem=rvm, map_fns=rmaps, batched=batched))
        for plan in rplans[1:]:
            want = np.asarray(rk.tiled_permute(jnp.asarray(want), plan,
                                               batched=batched))
        got = pex._fused_cuda(_to_torch(x), pfs, t, batched=batched)
        assert pk.launch_counts()["tile_fused"] == 0   # CPU: the plain version
        _assert_close(_to_numpy(got), want, dtype)


@pytest.mark.parametrize("dtype,shape,batched", [
    (np.float32, (1 << 8,), False), (BF16, (1 << 8,), False),
    (np.float32, (2, 1 << 8, 3), True)])
def test_map_epilogue_backward_matches_reference(dtype, shape, batched):
    n, t = 8, 4
    for rfs, pfs in _map_clusters(n, t, dtype):
        x = _values(shape, dtype, seed=3)
        ct = _values(shape, dtype, seed=4)
        want = np.asarray(rex._fused_bwd_pallas(
            rfs, t, batched, jnp.asarray(x), jnp.asarray(ct)))
        got = pex._fused_bwd_cuda(pfs, t, batched, _to_torch(x),
                                  _to_torch(ct))
        assert pk.launch_counts()["tile_bwd"] == 0
        _assert_close(_to_numpy(got), want, dtype,
                      rtol=1e-5 if dtype == np.float32 else None)


def test_raw_wrappers_run_the_function_they_are_given():
    """Two functions under one map name: each call of the raw wrappers
    (and their plain versions) runs the function it was passed, as the
    reference's raw wrapper does."""
    n, t = 8, 4
    (_, pfs), *_ = _map_clusters(n, t, np.float32)
    plans, entries = pex._fused_plan_cached(pfs, t)
    sig, scal, vmem, _ = pex._fused_kernel_args(entries, torch.float32)
    p = plans[0]
    tabs = (p.in_rows, p.out_rows, p.xor_low)
    s0 = p.src0.reshape(-1)
    inv = np.empty_like(s0)
    inv[s0] = np.arange(s0.size, dtype=s0.dtype)
    x = _to_torch(_values((1 << n,), np.float32, seed=5))
    ct = _to_torch(_values((1 << n,), np.float32, seed=6))
    n_maps = sum(sg[0] == "map" for sg in sig)

    def run(name, fn):
        sg = tuple(("map", name) if e[0] == "map" else e for e in sig)
        kw = dict(geometry=pk.plan_geometry(p), epilogue=sg, epi_scalar=scal,
                  epi_vmem=vmem, map_fns=(fn,) * n_maps)
        return (pk.tiled_permute_tables(x, *tabs, p.src0, **kw),
                pk.tiled_permute_bwd_tables(x, ct, *tabs,
                                            inv.reshape(p.src0.shape), **kw))

    def cube(v):
        return v * v * v

    for fn in (torch.tanh, cube, torch.tanh):
        shared, own = run("one_name", fn), run(f"own_{fn.__name__}", fn)
        for a, b in zip(shared, own):
            assert torch.equal(_bits(a), _bits(b)), fn.__name__
    assert not torch.equal(run("one_name", cube)[0],
                           run("one_name", torch.tanh)[0])


def test_bfloat16_tape_rounds_after_each_op():
    """The bfloat16 chain of the chip check, on continuous inputs: eager
    torch's per-op rounding, which the tape keeps, differs from a
    computation rounded once at the end on some inputs, so a kernel that
    rounded once would fail the chip check's bit comparison."""
    def chain(v):
        return (v * 3 + 1) / 7
    tape = ML.lower_map("bf16_chain", chain, BF)
    assert tape.lowered and len(tape.ops) == 3
    rng = np.random.default_rng(11)
    u = torch.from_numpy(((rng.random(4096) - 0.5) * 8).astype(
        np.float32)).to(BF)
    per_op = ML.eval_tape(tape, u)
    assert torch.equal(_bits(per_op), _bits(chain(u)))
    once = chain(u.float()).to(BF)
    assert int((_bits(per_op) != _bits(once)).sum()) > 100


def test_map_plan_records_hold_the_tape():
    n, t = 8, 4
    (_, pfs), *_ = _map_clusters(n, t, np.float32)
    plans, entries = pex._fused_plan_cached(pfs, t)
    x = torch.zeros(1 << n)
    sig, scal, vmem, fns = pex._fused_kernel_args(entries, x.dtype)
    ents = pk._epi_entries(sig, scal, vmem, fns, x.dtype)
    geometry = pk.plan_geometry(plans[0])
    for n_buf in (1, 2):
        _, _, words, _ = pk._epi_launch_args(x.reshape(1, -1, 1), geometry,
                                             ents, n_buf=n_buf)
        w = words.numpy()
        maps = [k for k, e in enumerate(ents) if e[0] == EP.KIND_MAP]
        assert words.info["maps"] == len(maps) >= 1
        for slot, k in enumerate(maps):
            ep = EP.epi_slice(w, k)
            tape = ents[k][9]
            assert ep[EP.EP_KIND] == EP.KIND_MAP
            assert ep[EP.EP_MAP_SLOT] == slot
            assert ep[EP.EP_MAP_FROM] == -1       # every input kept
            assert ep[EP.EP_MAP_LEN] == len(tape.ops)
            tw, at = ML.tape_words(tape), int(ep[EP.EP_MAP_TAPE])
            assert list(w[at:at + len(tw)]) == tw
        assert sum(int(EP.phase_slice(w, p)[EP.PH_MAPS])
                   for p in range(words.info["n_phases"])) == len(maps)


# ---------------------------------------------------------------------------
# whole programs
# ---------------------------------------------------------------------------

def _tanh_sq(V, n, tanh):
    return (V.riffle(n) >> V.emap("tanh", tanh) >> V.bit_reverse(n)
            >> V.emap("sq", lambda v: v * v))


def _counted(f, x, w=None):
    """(output, forward round trips, forward fallbacks, backward round
    trips, backward fallbacks, gradient) of one cold call."""
    pex.clear_caches()
    pobs.reset()
    pobs.enable()
    try:
        xt = x.clone().requires_grad_(w is not None)
        y = f(xt)
        fwd = pobs.counter_total("model.round_trips")
        fb0 = pobs.counter_total("dispatch.fused_fallback")
        bwd = fb1 = None
        if w is not None:
            (w * y).sum().backward()
            bwd = pobs.counter_total("model.vjp_round_trips")
            fb1 = pobs.counter_total("dispatch.fused_fallback") - fb0
    finally:
        pobs.disable()
        pobs.reset()
    return y.detach(), fwd, fb0, bwd, fb1, xt.grad


def test_map_program_forward_and_gradient_match_reference():
    n = 7
    rng = np.random.default_rng(12)
    x = rng.normal(size=1 << n).astype(np.float32)
    w = rng.normal(size=1 << n).astype(np.float32)
    rf = rc.compile_expr(_tanh_sq(RV, n, jnp.tanh), engine="pallas")
    want_y = np.asarray(rf(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.asarray(w) * rf(v)))(jnp.asarray(x)))
    f = pc.compile_expr(_tanh_sq(PV, n, torch.tanh))
    t = choose_tile(n, 4)
    prog = f.clustered_program(n, t)
    assert any(isinstance(s, pc.FusedStage) and any(
        isinstance(c, pc.Map) for c, _ in s.computes) for s in prog)
    y, fwd, fb0, bwd, fb1, g = _counted(f, torch.from_numpy(x),
                                        torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5, atol=1e-6)
    assert fb0 == fb1 == 0
    assert fwd == f.cost(n, t, clustered=True)["round_trips"]
    assert bwd == f.vjp_round_trips(n, t)


def test_int32_map_program_bitwise_equal_reference():
    n = 8
    x = np.random.default_rng(13).integers(-2**31, 2**31, 1 << n).astype(
        np.int32)

    def expr(V, Bmmc, fns):
        rng = random.Random(4)
        return (V.riffle(n) >> V.emap("wrap", fns[0])
                >> V.perm(Bmmc.random(n, rng)) >> V.emap("not", fns[1]))
    rf = rc.compile_expr(expr(RV, RBmmc, (lambda v: v * 1000003 + 7,
                                          jnp.bitwise_not)), engine="pallas")
    f = pc.compile_expr(expr(PV, PBmmc, (lambda v: v * 1000003 + 7,
                                         torch.bitwise_not)))
    y, fwd, fb0, _, _, _ = _counted(f, torch.from_numpy(x))
    assert np.array_equal(y.numpy(), np.asarray(rf(jnp.asarray(x))))
    t = choose_tile(n, 4)
    assert fb0 == 0 and fwd == f.cost(n, t, clustered=True)["round_trips"]


def test_descending_sort_through_not_maps():
    """``not >> sort >> not`` sorts int32 keys in descending order, its
    maps fused into the first and last clusters."""
    from repro_torch.combinators.sort import sort_expr
    n = 10
    x = torch.from_numpy(np.random.default_rng(14).integers(
        -2**31, 2**31, 1 << n).astype(np.int32))
    f = pc.compile_expr(PV.emap("not", torch.bitwise_not) >> sort_expr(n)
                        >> PV.emap("not", torch.bitwise_not))
    y, fwd, fb0, _, _, _ = _counted(f, x)
    assert torch.equal(y, torch.sort(x, descending=True).values)
    t = choose_tile(n, 4)
    assert fb0 == 0 and fwd == f.cost(n, t, clustered=True)["round_trips"]
