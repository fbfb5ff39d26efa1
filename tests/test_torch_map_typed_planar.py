"""Typed maps beside butterflies (K4b's and K5's planar ext map kernels)
through the fused kernels' plain versions on the CPU, held against the
reference, and the two repairs of the map model.

* Exact typed maps (casts that keep the value, a product by a power of
  two, masks, bools) before the FFT's first two stages, on planar
  float32, bfloat16, float16 and float64: one cluster holds the map and
  the butterflies, runs fused (no fallback), and equals the reference's
  ``compile_expr(..., engine="pallas")`` bit for bit; K5's plain version
  on that cluster equals the reference's ``_fused_bwd_pallas``. Those
  stages' twiddles are 1 and -i, whose products are exact, so XLA's
  contraction of a product and a sum into an FMA (the port rounds each
  on its own) changes no rounding; only a zero's sign may differ, where
  a product and a sum of zeros meet.
* ``emap(m) >> fft`` whole, the exact maps and ``tanh(v.float()).to(
  v.dtype)``: fused in both directions, bit-equal to the same program
  stage by stage on the ``ref`` engine (eager torch) and its gradient to
  autograd through it; within ``8 * log2(N)`` unit roundoffs of the
  reference (bit-equal on bfloat16, which XLA computes in float32); the
  counted K5 passes equal ``vjp_round_trips(n, t, dtype)``.
* A map that reads its input's shape is not lowered, and a program that
  holds it runs stage by stage; a map that lowers for float32 and not
  for bfloat16 is modelled per type.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators import fft as rfft
from repro.combinators import vocab as RV
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import fft as pfft
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import sort_expr
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import map_lower as ML
from repro_torch.kernels import ops as pops
from _torch_dtypes import BF16, _observed, _to_torch

FLOATS = ("float32", "bfloat16", "float16", "float64")
_UNIT = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8,
         "float16": 2.0 ** -11, "float64": 2.0 ** -53}
_INT = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32),
        8: (torch.int64, np.int64)}

# name, torch function, jnp function: exact typed maps (tests/
# _torch_typed_maps.py's cast_affine with a power-of-two scale,
# cast_int_floor, cast_mask, cast_bool)
EXACT = [
    ("cast_affine", lambda v: (v.float() * 0.5 + 1).to(v.dtype),
     lambda v: (v.astype(jnp.float32) * 0.5 + 1).astype(v.dtype)),
    ("cast_int_floor", lambda v: (v.int() * 3).to(v.dtype) + v,
     lambda v: (v.astype(jnp.int32) * 3).astype(v.dtype) + v),
    ("cast_mask", lambda v: (v > 0).to(v.dtype) * v,
     lambda v: (v > 0).astype(v.dtype) * v),
    ("cast_bool", lambda v: v.bool().to(v.dtype) + v,
     lambda v: (v != 0).astype(v.dtype) + v),
]
CAST_TANH = ("cast_tanh", lambda v: torch.tanh(v.float()).to(v.dtype))


def _head(V, F, n, stages, name, fn):
    """``emap(name, fn)``, then the bit reversal and the first ``stages``
    butterfly stages of the package's 2^n-point FFT."""
    parts = [V.emap(name, fn), V.bit_reverse(n)]
    for s in range(stages):
        e = F._stage_core(s)
        for _ in range(n - s - 1):
            e = V.two(e)
        parts.append(e)
    return V.seq(*parts)


def _planar(dtype, n, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    p = np.stack([z.real, z.imag], axis=-1)
    if dtype == "float64":
        return p
    return p.astype(np.float32).astype(BF16 if dtype == "bfloat16" else dtype)


def _same_but_zero_signs(got: torch.Tensor, want) -> None:
    """Bit for bit, but where both are zeros (of either sign)."""
    ti, ni = _INT[got.element_size()]
    want = np.asarray(want)
    gb, wb = got.view(ti).numpy(), want.view(ni)
    zeros = (got.double().numpy() == 0) & (want.astype(np.float64) == 0)
    assert np.array_equal(gb[~zeros], wb[~zeros])
    assert zeros.sum() < gb.size


def _clusters(pexpr, rexpr, n, t):
    pp = pc.compile_expr(pexpr, engine="cuda").clustered_program(n, t)
    rp = rc.compile_expr(rexpr, engine="pallas").clustered_program(n, t)
    pf = [s for s in pp if isinstance(s, pc.FusedStage) and s.computes]
    rf = [s for s in rp if isinstance(s, rc.FusedStage) and s.computes]
    assert len(pf) == len(rf) == 1
    assert {type(c).__name__ for c, _ in pf[0].computes} == {"Map", "Bfly"}
    return pf[0], rf[0]


@pytest.mark.parametrize("name,tfn,jfn", EXACT, ids=[m[0] for m in EXACT])
@pytest.mark.parametrize("dtype", FLOATS)
def test_typed_map_beside_butterflies_matches_reference(dtype, name, tfn,
                                                        jfn):
    """Forward: the program through the fused plain path against the
    reference's pallas program; backward: K5's plain version on the
    cluster against ``_fused_bwd_pallas``."""
    n = 8
    tt = getattr(torch, dtype)
    tape = ML.lower_map(name, tfn, tt)
    assert tape.lowered
    # the ext kernels' (a cast to the map's own dtype is no op; a bool
    # value is the register path's)
    assert tape.typed == (name == "cast_int_floor" or (
        name == "cast_affine" and dtype != "float32"))
    pexpr, rexpr = (_head(PV, pfft, n, 2, name, tfn),
                    _head(RV, rfft, n, 2, name, jfn))
    x, ct = _planar(dtype, n, 11), _planar(dtype, n, 12)
    t = pops.choose_tile(n, x.itemsize, 2)
    pfs, rfs = _clusters(pexpr, rexpr, n, t)
    got, hist, fall = _observed(pobs, lambda: pc.compile_expr(
        pexpr, engine="cuda")(_to_torch(x)))
    assert fall == 0 and hist.get("fused", 0) == 1, hist
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(rc.compile_expr(rexpr, engine="pallas")(
            jnp.asarray(x)))
        want_b = np.asarray(rex._fused_bwd_pallas(
            rfs, t, False, jnp.asarray(x), jnp.asarray(ct)))
    _same_but_zero_signs(got, want)
    got_b = pex._fused_bwd_cuda(pfs, t, False, _to_torch(x), _to_torch(ct))
    assert pk.launch_counts()["tile_bwd"] == 0    # CPU: the plain version
    _same_but_zero_signs(got_b, want_b)


def _counted(f, x, w):
    """A cold forward and backward of ``(w * f(x)).sum()`` with obs on:
    (output, gradient, forward fallbacks, backward fallbacks, counted
    backward round trips)."""
    pobs.reset()
    pobs.enable()
    try:
        xt = x.clone().requires_grad_(True)
        y = f(xt)
        fb0 = pobs.counter_total("dispatch.fused_fallback")
        (w * y).sum().backward()
        return (y.detach(), xt.grad, fb0,
                pobs.counter_total("dispatch.fused_fallback") - fb0,
                pobs.counter_total("model.vjp_round_trips"))
    finally:
        pobs.disable()
        pobs.reset()


def _eager(f, x, w):
    xt = x.clone().requires_grad_(True)
    y = f(xt)
    (w * y).sum().backward()
    return y.detach(), xt.grad


@pytest.mark.parametrize("name,tfn,jfn", EXACT + [CAST_TANH + (None,)],
                         ids=[m[0] for m in EXACT] + ["cast_tanh"])
@pytest.mark.parametrize("dtype", FLOATS)
def test_map_then_fft_fuses_both_ways_and_equals_eager(dtype, name, tfn,
                                                       jfn):
    n = 8
    tt = getattr(torch, dtype)
    pexpr = PV.seq(PV.emap(name, tfn), pfft.fft_expr(n))
    f = pc.compile_expr(pexpr, engine="cuda")
    xn = _planar(dtype, n, 21)
    x, w = _to_torch(xn), _to_torch(_planar(dtype, n, 22))
    t = pops.choose_tile(n, x.element_size(), 2)
    assert any({"Map", "Bfly"} <= {type(c).__name__ for c, _ in s.computes}
               for s in f.clustered_program(n, t)
               if isinstance(s, pc.FusedStage))
    y, g, fb_f, fb_b, rt = _counted(f, x, w)
    assert fb_f == fb_b == 0
    assert rt == f.vjp_round_trips(n, t, tt) is not None
    ey, eg = _eager(pc.compile_expr(pexpr, engine="ref"), x, w)
    ti = _INT[y.element_size()][0]
    assert torch.equal(y.view(ti), ey.view(ti))
    assert torch.equal(g.view(ti), eg.view(ti))
    if jfn is None:      # jnp.tanh and torch.tanh differ by ulps
        return
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(rc.compile_expr(
            RV.seq(RV.emap(name, jfn), rfft.fft_expr(n)), engine="pallas")(
                jnp.asarray(xn)))
    if dtype == "bfloat16":
        assert np.array_equal(y.view(torch.int16).numpy(),
                              want.view(np.int16))
    got, want = y.double().numpy(), want.astype(np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 8 * n * _UNIT[dtype], rel


SHAPE_READERS = [
    ("reads_len", lambda v: v * len(v)),
    ("reads_size", lambda v: v / v.size(-1)),
    ("reads_numel", lambda v: v + v.numel()),
]


@pytest.mark.parametrize("name,fn", SHAPE_READERS,
                         ids=[m[0] for m in SHAPE_READERS])
def test_a_map_that_reads_its_shape_is_not_lowered(name, fn):
    """Traced on one element its length would be a constant of the tape;
    the map is refused for every type, and a sort after it runs its map
    cluster stage by stage (a fused fallback), equal to the ref engine
    and to the function on the whole array."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64, torch.int32):
        assert not ML.lower_map(name, fn, dtype).lowered, dtype
    assert ML.lower_map("times_two", lambda v: v * 2, torch.float32).lowered
    n = 7
    expr = PV.emap(name, fn) >> sort_expr(n)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=1 << n).astype(np.float32))
    got, _, fall = _observed(pobs, lambda: pc.compile_expr(
        expr, engine="cuda")(x))
    assert fall >= 1
    assert torch.equal(got, pc.compile_expr(expr, engine="ref")(x))
    assert torch.equal(got, torch.sort(fn(x)).values)


def test_the_backward_model_counts_by_element_type():
    """A map that lowers for float32 and not for bfloat16 (it reads its
    length on bfloat16 only): the model counts the K5 pass on float32,
    and is None on bfloat16, where the cluster runs stage by stage in
    both directions; the float32 count is the default's."""
    def fn(v):
        return v * len(v) if v.dtype == torch.bfloat16 else v * 2
    assert ML.lower_map("len_on_bf16", fn, torch.float32).lowered
    assert not ML.lower_map("len_on_bf16", fn, torch.bfloat16).lowered
    n = 8
    f = pc.compile_expr(PV.seq(PV.emap("len_on_bf16", fn), pfft.fft_expr(n)),
                        engine="cuda")
    for dtype in ("float32", "bfloat16"):
        tt = getattr(torch, dtype)
        x = _to_torch(_planar(dtype, n, 31))
        w = _to_torch(_planar(dtype, n, 32))
        t = pops.choose_tile(n, x.element_size(), 2)
        _, _, fb_f, fb_b, rt = _counted(f, x, w)
        model = f.vjp_round_trips(n, t, tt)
        if dtype == "float32":
            assert fb_f == fb_b == 0
            assert rt == model == f.vjp_round_trips(n, t)
        else:
            assert fb_f >= 1 and fb_b >= 1
            assert model is None
