"""The element types the reference's fused kernel takes, held against it
on the CPU: float16, 8- and 16-bit integers, uint32 and bool (the
permutations, the sorts and the maps; the kernels cluster by cluster in
``test_torch_fused_dtypes_kernels.py``).

* uint16 and uint32 permutations through every dispatch class (block,
  lane, tiled, general) run on the CPU (torch has no index ops for them
  there; the plain versions move a signed view of the same width) and
  equal the reference's Pallas path bit for bit.
* ``sort`` of 2^8 and 2^12 keys of each new type is bit-equal to the
  reference's ``compiled_sort(n, engine="pallas")``, with no fused
  fallback and the reference's kernel histogram (each compute cluster one
  K4b pass, its plain version here).
* Which maps lower for which type: a map torch does not define for a
  type (most ops on uint16 and uint32) does not lower, and its cluster
  falls back stage by stage and counts; ``sin`` and ``cos`` lower for the
  float types.

Inputs are made with numpy from a seed and handed to both packages.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro import obs as robs
from repro.combinators import vocab as RV
from repro.combinators.sort import compiled_sort as r_compiled_sort
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels import ops as rops
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import compiled_sort as p_compiled_sort
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import map_lower
from repro_torch.kernels import ops as pops
from _torch_dtypes import (NEW_TYPES, _TORCH, _keys, _observed,
                           _same_bits, _to_numpy, _to_torch)


# ---------------------------------------------------------------------------
# uint16 and uint32 through every dispatch class
# ---------------------------------------------------------------------------

def _class_bmmc(kind: str, n: int, rng):
    ident = tuple(1 << i for i in range(n))
    if kind == "block":
        sub = RBmmc.random(n - n // 2, rng)
        return RBmmc(ident[:n // 2] + tuple(r << (n // 2) for r in sub.rows),
                     sub.c << (n // 2))
    if kind == "lane":
        sub = RBmmc.random(2, rng)
        return RBmmc(tuple(sub.rows) + ident[2:], sub.c)
    if kind == "tiled":
        return RBmmc.random_bpc(n, rng)
    return RBmmc.random(n, rng)                     # general


@pytest.mark.parametrize("kind,t", [("block", 2), ("lane", 2), ("tiled", 3),
                                    ("general", 3)])
@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_unsigned_permutations_through_every_class(dtype, kind, t):
    """The plain versions move unsigned elements as a signed view of their
    width (torch on the CPU has no index_select or index_put for uint16
    and uint32): each dispatch class, batched with a tail too, equals the
    reference's Pallas path and its class, bit for bit."""
    n = 8
    b = _class_bmmc(kind, n, random.Random(41))
    pb = PBmmc(b.rows, b.c)
    for shape, batched in (((1 << n,), False), ((2, 1 << n, 3), True)):
        x = _keys(dtype, shape, seed=len(kind))
        want, rk_, _ = _observed(robs, lambda: np.asarray(rops.bmmc_permute(
            jnp.asarray(x), b, t=t, batched=batched)))
        got, pk_, _ = _observed(pobs, lambda: pops.bmmc_permute(
            _to_torch(x), pb, t=t, batched=batched))
        assert pk_ == rk_ == {kind: 1}, (pk_, rk_)
        _same_bits(_to_numpy(got), want, (dtype, kind, shape))
        _same_bits(_to_numpy(pops.bmmc_permute(_to_torch(x), pb,
                                               engine="ref",
                                               batched=batched)),
                   want, (dtype, kind, "ref"))


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_unsigned_compare_orders_the_whole_range(dtype):
    """cmp_max / cmp_min order uint16 and uint32 as unsigned (a signed
    view with the sign bit flipped), into ``out`` views too."""
    x = _keys(dtype, (2, 512), seed=3)
    a, b = _to_torch(x[0]), _to_torch(x[1])
    _same_bits(_to_numpy(pk.cmp_max(a, b)), np.maximum(x[0], x[1]))
    _same_bits(_to_numpy(pk.cmp_min(a, b)), np.minimum(x[0], x[1]))
    out = torch.empty(2, 512, dtype=a.dtype)
    pk.cmp_min(a, b, out=out[0])
    pk.cmp_max(a, b, out=out[1])
    _same_bits(_to_numpy(out), np.stack([np.minimum(x[0], x[1]),
                                         np.maximum(x[0], x[1])]))


# ---------------------------------------------------------------------------
# the sort of every new type: fused, bit-equal, the reference's histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("dtype", NEW_TYPES)
def test_sort_fuses_and_equals_reference(dtype, n):
    x = _keys(dtype, (1 << n,), seed=n)
    want, rhist, rfall = _observed(robs, lambda: np.asarray(
        r_compiled_sort(n, engine="pallas")(jnp.asarray(x))))
    got, phist, pfall = _observed(pobs, lambda: p_compiled_sort(n)(
        _to_torch(x)))
    assert rfall == pfall == 0
    assert phist == rhist and phist.get("fused", 0) > 0, (phist, rhist)
    if n == 8:
        assert sum(phist.values()) == 13 and phist["fused"] == 8
    got = _to_numpy(got)
    if dtype == "float16":    # NaNs by position (XLA's CPU rewrites them)
        nan = np.isnan(want)
        assert np.array_equal(nan, np.isnan(got))
        got, want = got[~nan], want[~nan]
    _same_bits(got, want, (dtype, n))


# ---------------------------------------------------------------------------
# which maps lower for which type
# ---------------------------------------------------------------------------

_MAPS = {"not": lambda v: ~v, "xor5": lambda v: v ^ 5,
         "add1": lambda v: v + 1, "shr1": lambda v: v >> 1,
         "x3": lambda v: v * 3, "sin": torch.sin, "cos": torch.cos}
# what lowers: torch on the CPU defines few ops for uint16 and uint32, and
# bool keeps only the ops that map 0 and 1 to 0 and 1 (~ as an XOR with 1)
_LOWERS = {
    "int8": {"not", "xor5", "add1", "shr1", "x3"},
    "uint8": {"not", "xor5", "add1", "shr1", "x3"},
    "int16": {"not", "xor5", "add1", "shr1", "x3"},
    "uint16": {"xor5", "x3"},
    "uint32": {"xor5", "x3"},
    "bool": {"not"},
    "float16": {"add1", "x3", "sin", "cos"},
    "bfloat16": {"add1", "x3", "sin", "cos"},
    "float32": {"add1", "x3", "sin", "cos"},
}


@pytest.mark.parametrize("dtype", sorted(_LOWERS))
def test_which_maps_lower_for_each_type(dtype):
    """The tape lowers exactly ``_LOWERS[dtype]``; where it lowers, its
    plain evaluation equals the function (exactly for the integers and
    the products, sin and cos on the CPU as torch computes them)."""
    got = set()
    for name, fn in _MAPS.items():
        tape = map_lower.lower_map(f"pin_{name}", fn, _TORCH[dtype])
        if not tape.lowered:
            continue
        got.add(name)
        u = _to_torch(_keys(dtype, (64,), seed=1))
        if dtype in ("float16", "bfloat16", "float32"):
            u = torch.where(torch.isnan(u), torch.zeros_like(u), u)
        _same_bits(_to_numpy(map_lower.eval_tape(tape, u)),
                   _to_numpy(fn(u)), (dtype, name))
    assert got == _LOWERS[dtype], (dtype, got)


@pytest.mark.parametrize("dtype,name", [("int8", "shr1"), ("bool", "not"),
                                        ("uint16", "add1")])
def test_map_cluster_fuses_where_it_lowers(dtype, name):
    """``emap >> sort >> emap`` of a new type: a map that lowers runs in
    K4b (no fallback), one that does not (uint16 + 1: torch has no CPU
    add for it) falls back stage by stage and counts; where both packages
    run it, the outputs are bit-equal."""
    n = 7
    fn = _MAPS[name]

    def expr(V, sort_expr):
        return V.seq(V.emap(name, fn), sort_expr(n), V.emap(name, fn))
    x = _keys(dtype, (1 << n,), seed=9)
    lowered = name in _LOWERS[dtype]
    if lowered:
        got, _, fall = _observed(pobs, lambda: pc.compile_expr(
            expr(PV, p_sort_expr), engine="cuda")(_to_torch(x)))
        assert fall == 0
        want = np.asarray(rc.compile_expr(expr(RV, r_sort_expr),
                                          engine="pallas")(jnp.asarray(x)))
        _same_bits(_to_numpy(got), want, (dtype, name))
    else:
        f = pc.compile_expr(expr(PV, p_sort_expr), engine="cuda")
        pobs.reset()
        pobs.enable()
        try:
            with pytest.raises(Exception):   # torch has no such op here
                f(_to_torch(x))
            assert pobs.counter_total("dispatch.fused_fallback") >= 1
        finally:
            pobs.disable()
            pobs.reset()


def test_sin_cos_gradients_round_as_autograd():
    """K5's derivative formulas for sin and cos (tape_vjp, as the kernel
    computes them): autograd's ``grad * x.cos()`` and ``grad * -x.sin()``,
    each op rounded to the type; on the CPU equal to eager autograd within
    a few ulps (the CPU's vectorized sin and cos differ from the scalar
    ones by ulps)."""
    rng = np.random.default_rng(4)
    for dtype, tol in ((torch.float32, 4e-7), (torch.bfloat16, 1e-2),
                       (torch.float16, 2e-3)):
        u = torch.from_numpy(rng.normal(size=256).astype(np.float32) * 3).to(
            dtype)
        ct = torch.from_numpy(rng.normal(size=256).astype(np.float32)).to(
            dtype)
        for name in ("sin", "cos"):
            fn = _MAPS[name]
            tape = map_lower.lower_map(f"vjp_{name}", fn, dtype)
            assert tape.lowered
            uu = u.clone().requires_grad_(True)
            want = torch.autograd.grad(fn(uu), uu, ct)[0].float()
            got = map_lower.tape_vjp(tape, u, ct).float()
            assert float((got - want).abs().max()) <= tol * 4, (dtype, name)
