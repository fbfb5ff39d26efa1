"""Programs whose maps hold casts (typed tapes) and the new element-wise
ops, through the fused kernels' plain versions on the CPU, held against
the reference.

* Forward: programs whose maps use exact ops (casts that keep the value,
  products by powers of two, ``copysign``, ``nan_to_num``,
  ``hardshrink``, ``remainder`` between two int32 values), written once in
  torch and once in jnp, equal the reference's ``compile_expr(...,
  engine="pallas")`` bit for bit, with no fused fallback, on bfloat16,
  float16, float32 and int32.
* Backward: their clusters' transposes (K5's plain version) equal the
  reference's ``_fused_bwd_pallas`` bit for bit, and a sort after a cast
  map differentiates with no fused fallback.

Inputs are made with numpy from a seed and handed to both packages.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators import vocab as RV
from repro.core.bmmc import Bmmc as RBmmc
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import map_lower as ML

_JT = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16,
       np.float16: jnp.float16, np.int32: jnp.int32}
_TT = {np.float32: torch.float32, "bfloat16": torch.bfloat16,
       np.float16: torch.float16, np.int32: torch.int32}


def _fallbacks(fn):
    pobs.reset()
    pobs.enable()
    try:
        out = fn()
        return out, pobs.counter_total("dispatch.fused_fallback")
    finally:
        pobs.disable()
        pobs.reset()


def _half_maps():
    return [
        ("t_affine", lambda v: (v.float() * 0.5 + 0.25).to(v.dtype),
         lambda v: (v.astype(jnp.float32) * 0.5 + 0.25).astype(v.dtype)),
        ("t_mask", lambda v: (v > 0).to(v.dtype) * v,
         lambda v: (v > 0).astype(v.dtype) * v),
        ("t_shrink", lambda v: F.hardshrink(v, 0.5),
         lambda v: jnp.where((v >= -0.5) & (v <= 0.5), 0, v).astype(v.dtype)),
    ]


# the maps of each dtype: (name, torch function, jnp function), exact ops
EXACT = {
    "bfloat16": _half_maps(),
    np.float16: _half_maps(),
    np.float32: [
        ("t_mask", lambda v: (v > 0).to(v.dtype) * v,
         lambda v: (v > 0).astype(v.dtype) * v),
        ("t_copysign", lambda v: torch.copysign(v, v - 1),
         lambda v: jnp.copysign(v, v - 1)),
        ("t_nan_to_num", lambda v: torch.nan_to_num(v / 0.0, 1.0, 2.0, -3.0)
         + v, lambda v: jnp.nan_to_num(v / 0.0, nan=1.0, posinf=2.0,
                                       neginf=-3.0) + v),
    ],
    np.int32: [
        ("t_half", lambda v: (v.float() * 0.5).to(v.dtype),
         lambda v: (v.astype(jnp.float32) * 0.5).astype(v.dtype)),
        ("t_rem", lambda v: torch.remainder(v, v.abs() % 7 + 1),
         lambda v: jnp.remainder(v, jnp.abs(v) % 7 + 1)),
    ],
}


def _program(V, Bmmc, n, maps):
    rng = random.Random(30)
    parts = [V.perm(Bmmc.random_bpc(n, rng))]
    for name, fn in maps:
        parts += [V.cmp_halves(), V.emap(name, fn),
                  V.perm(Bmmc.random_bpc(n, rng))]
    return V.seq(*parts, V.perm(Bmmc.random(n, rng)))


def _x(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:   # |v| < 2^24: exact in float32
        return rng.integers(-(1 << 24) + 1, 1 << 24, 1 << n).astype(np.int32)
    return (rng.integers(-16, 17, 1 << n) / 4).astype(np.float32)


def _torch_in(x, dtype):
    return torch.from_numpy(x).to(_TT[dtype])


def _jnp_in(x, dtype):
    return jnp.asarray(x).astype(_JT[dtype])


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", list(EXACT), ids=str)
def test_exact_typed_maps_match_reference_bit_for_bit(dtype):
    n = 7
    maps = EXACT[dtype]
    tt = _TT[dtype]
    for name, fn, _ in maps:
        assert ML.lower_map(name, fn, tt).lowered, name
    assert any(ML.lower_map(m, f, tt).typed for m, f, _ in maps)
    pf = pc.compile_expr(_program(PV, PBmmc, n, [(m, f) for m, f, _ in maps]),
                         engine="cuda")
    rf = rc.compile_expr(_program(RV, RBmmc, n, [(m, j) for m, _, j in maps]),
                         engine="pallas")
    x = _x(dtype, n, 5)
    got, fb = _fallbacks(lambda: pf(_torch_in(x, dtype)))
    assert fb == 0
    want = np.asarray(rf(_jnp_in(x, dtype)))
    got = (got.view(torch.int16) if got.element_size() == 2
           else got.view(torch.int32)).numpy()
    assert np.array_equal(got, _bits(want))


def _clusters(maps, n, t, side):
    V, Bmmc, lib = (PV, PBmmc, pc) if side == 1 else (RV, RBmmc, rc)
    engine = "cuda" if side == 1 else "pallas"
    prog = lib.compile_expr(_program(V, Bmmc, n, [(m[0], m[side])
                                                  for m in maps]),
                            engine=engine).clustered_program(n, t)
    return [s for s in prog if isinstance(s, lib.FusedStage) and any(
        type(c).__name__ == "Map" for c, _ in s.computes)]


@pytest.mark.parametrize("dtype", ["bfloat16", np.float16, np.float32],
                         ids=str)
def test_typed_map_clusters_backward_match_reference(dtype):
    """K5's plain version on the clusters of the exact maps (but
    ``nan_to_num``, whose input is infinite) against the reference's
    ``_fused_bwd_pallas``, bit for bit but a zero's sign (jax on the CPU
    gives float16's ``g * 0`` as +0 where autograd, and IEEE, give -0 for
    a negative ``g``); inputs hold no zero (``copysign``'s derivative at 0
    is 0 in autograd, the partner's in jax)."""
    n, t = 7, 3
    maps = [m for m in EXACT[dtype] if m[0] != "t_nan_to_num"]
    pcs, rcs = _clusters(maps, n, t, 1), _clusters(maps, n, t, 2)
    assert len(pcs) == len(rcs) >= 1
    rng = np.random.default_rng(7)
    x = (rng.integers(1, 17, 1 << n) * rng.choice([-1, 1], 1 << n) / 4
         ).astype(np.float32)
    ct = (rng.integers(-8, 9, 1 << n) / 8).astype(np.float32)
    for pfs, rfs in zip(pcs, rcs):
        want = np.asarray(rex._fused_bwd_pallas(
            rfs, t, False, _jnp_in(x, dtype), _jnp_in(ct, dtype)))
        got = pex._fused_bwd_cuda(pfs, t, False, _torch_in(x, dtype),
                                  _torch_in(ct, dtype))
        assert pk.launch_counts()["tile_bwd"] == 0    # CPU: the plain version
        zero = (got.float().numpy() == 0) & (want.astype(np.float32) == 0)
        got = (got.view(torch.int16) if got.element_size() == 2
               else got.view(torch.int32)).numpy()
        assert np.array_equal(got[~zero], _bits(want)[~zero])
        assert zero.sum() < got.size


def test_cast_map_sort_gradient_has_no_fallback():
    """``emap(tanh(v.float()).to(v.dtype)) >> sort`` on bfloat16: forward
    and gradient through the fused kernels' plain versions with no fused
    fallback, equal to the same program stage by stage on the ``ref``
    engine."""
    n = 7
    expr = PV.emap("t_cast_tanh", lambda v: torch.tanh(v.float()).to(
        v.dtype)) >> sort_expr(n)
    f = pc.compile_expr(expr, engine="cuda")
    fr = pc.compile_expr(expr, engine="ref")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.permutation(1 << n).astype(np.float32) / 64
                         - 1).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=1 << n).astype(np.float32)).to(
        torch.bfloat16)

    def grad(fn):
        v = x.clone().requires_grad_(True)
        out = fn(v)
        (w * out).sum().backward()
        return out.detach(), v.grad
    (out, g), fb = _fallbacks(lambda: grad(f))
    assert fb == 0
    want_out, want_g = grad(fr)
    assert torch.equal(out.view(torch.int16), want_out.view(torch.int16))
    assert torch.equal(g.view(torch.int16), want_g.view(torch.int16))


def test_typed_clusters_run_in_the_ext_map_kernels():
    """A cluster that holds a typed tape takes K4b's and K5's ext map
    kernels (the same sources built with ``-DREPRO_MAP_EXT=1`` to ``=4``
    into libraries of their own, by element class and layout: beside
    butterflies, planar pairs in parts 3 and 4); its map record says
    typed and points at the tape's words, type words included; an
    untyped cluster keeps the base kernels."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import epilogue_plan as EP
    n, t = 7, 3
    for maps, typed in ((EXACT["bfloat16"][:1], True),
                        (EXACT[np.float32][:1], False)):
        (fs,) = _clusters(maps, n, t, 1)[:1]
        dtype = torch.bfloat16 if typed else torch.float32
        plans, entries = pex._fused_plan_cached(fs, t)
        ents = pk._epi_entries(*pex._fused_kernel_args(entries, dtype),
                               dtype)
        assert pk._map_path(ents) == ("ext" if typed else None)
        x = torch.zeros(1 << n, dtype=dtype)
        words = pk._epi_launch_args(x.reshape(1, -1, 1), pk.plan_geometry(
            plans[0]), ents)[2]
        flat = words.numpy().reshape(-1)
        for e, ent in enumerate(ents):
            if ent[0] != EP.KIND_MAP:
                continue
            rec = EP.epi_slice(words, e)
            assert rec[EP.EP_MAP_TYPED] == (2 if ent[9].mixed else int(typed))
            assert ent[9].mixed == typed   # the float family: cast, affine
            tape = ML.tape_words(ent[9])
            at = int(rec[EP.EP_MAP_TAPE])
            assert list(flat[at:at + len(tape)]) == tape
            n_ops, pool = len(ent[9].ops), ML.tape_constants(ent[9])
            assert len(tape) == 1 + n_ops * (2 if typed else 1) + 2 * len(
                pool)
    for k in ("tile_fused", "tile_bwd"):
        for part in (1, 2, 3, 4):
            lib = f"{k}_ext{part}"
            assert B.KERNELS[lib][:2] == B.KERNELS[k][:2]
            assert f"-DREPRO_MAP_EXT={part}" in B._flags(lib)
            assert B._lib_path(lib) != B._lib_path(k)
        assert len({B._lib_path(f"{k}_ext{p}") for p in (1, 2, 3, 4)}) == 4
        # the parts split the element classes as kExtPart does: single
        # values in parts 1 and 2, planar pairs beside butterflies in 3
        # (float32, float64) and 4 (bfloat16, float16)
        assert [B.ext_library(k, pk._ELEM_TYPE[d]) for d in (
            torch.int32, torch.float32, torch.bfloat16, torch.float16,
            torch.int8, torch.bool, torch.int64, torch.float64)] == [
            f"{k}_ext1"] * 3 + [f"{k}_ext2"] * 5
        assert [B.ext_library(k, pk._ELEM_TYPE[d], 2) for d in (
            torch.float32, torch.float64, torch.bfloat16, torch.float16)] == [
            f"{k}_ext3"] * 2 + [f"{k}_ext4"] * 2
