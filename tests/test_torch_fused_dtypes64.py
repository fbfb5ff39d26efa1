"""The 64-bit element types (int64, uint64, float64), held against the
reference on the CPU: the permutations, the compares and the maps (the
sorts in ``test_torch_fused_dtypes64_sort.py``, the kernels cluster by
cluster in ``test_torch_fused_dtypes64_kernels.py``).

The reference runs only inside ``jax.enable_x64(True)`` (scoped: other
tests in the same process keep jax's 32-bit default); outside it jax
would narrow the inputs to 32 bits.

* int64, uint64 and float64 permutations through every dispatch class
  equal the reference's Pallas path bit for bit (the plain versions move
  a signed view of the same width; torch on the CPU has no index ops for
  uint64).
* ``cmp_max`` / ``cmp_min`` order uint64 as unsigned and float64 as
  ``jnp.maximum`` / ``jnp.minimum`` do (NaN first, max(-0, +0) = +0).
* Which maps lower for which 64-bit type, and a map constant that 32 bits
  would cut keeps all 64 bits in the tape's words and through the fused
  cluster.

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
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels import ops as rops
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import epilogue_plan as EP
from repro_torch.kernels import map_lower
from repro_torch.kernels import ops as pops
from _torch_dtypes import (WIDE_TYPES, _TORCH, _keys, _observed,
                           _same_bits, _to_numpy, _to_torch)


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
@pytest.mark.parametrize("dtype", WIDE_TYPES)
def test_wide_permutations_through_every_class(dtype, kind, t):
    """Each dispatch class, batched with a tail too, equals the
    reference's Pallas path under x64 and its class, bit for bit."""
    n = 8
    b = _class_bmmc(kind, n, random.Random(43))
    pb = PBmmc(b.rows, b.c)
    for shape, batched in (((1 << n,), False), ((2, 1 << n, 3), True)):
        x = _keys(dtype, shape, seed=len(kind))
        with jax.enable_x64(True):
            want, rk_, _ = _observed(robs, lambda: np.asarray(
                rops.bmmc_permute(jnp.asarray(x), b, t=t, batched=batched)))
        assert want.dtype == x.dtype
        got, pk_, _ = _observed(pobs, lambda: pops.bmmc_permute(
            _to_torch(x), pb, t=t, batched=batched))
        assert pk_ == rk_ == {kind: 1}, (pk_, rk_)
        _same_bits(_to_numpy(got), want, (dtype, kind, shape))


@pytest.mark.parametrize("dtype", WIDE_TYPES)
def test_wide_compare_equals_jnp_maximum_minimum(dtype):
    """cmp_max / cmp_min on 64-bit values against ``jnp.maximum`` /
    ``jnp.minimum`` under x64: uint64 as unsigned (a signed view with the
    sign bit flipped), float64 with NaN first and the signed zeros' AND
    and OR; into ``out`` views too."""
    x = _keys(dtype, (2, 512), seed=5)
    if dtype == "float64":   # every pairing of -0, +0 and NaN besides
        x[0, :9] = [0.0, -0.0, 0.0, -0.0, np.nan, 1.0, np.nan, -0.0, 2.0]
        x[1, :9] = [-0.0, 0.0, 0.0, -0.0, 1.0, np.nan, np.nan, np.nan, -0.0]
    with jax.enable_x64(True):
        hi = np.asarray(jnp.maximum(jnp.asarray(x[0]), jnp.asarray(x[1])))
        lo = np.asarray(jnp.minimum(jnp.asarray(x[0]), jnp.asarray(x[1])))
    a, b = _to_torch(x[0]), _to_torch(x[1])
    _same_bits(_to_numpy(pk.cmp_max(a, b)), hi, "max")
    _same_bits(_to_numpy(pk.cmp_min(a, b)), lo, "min")
    out = torch.empty(2, 512, dtype=a.dtype)
    pk.cmp_min(a, b, out=out[0])
    pk.cmp_max(a, b, out=out[1])
    _same_bits(_to_numpy(out), np.stack([lo, hi]), "out")


# ---------------------------------------------------------------------------
# maps on 64-bit values
# ---------------------------------------------------------------------------

_MAPS = {"not": lambda v: ~v, "xor5": lambda v: v ^ 5,
         "add1": lambda v: v + 1, "shr1": lambda v: v >> 1,
         "shr40": lambda v: v >> 40, "x3": lambda v: v * 3,
         "sin": torch.sin, "tanh": torch.tanh}
# what lowers: torch on the CPU defines few ops for uint64 (xor and mul),
# and a shift by 40 lowers only where the type has 64 bits
_LOWERS = {
    "int64": {"not", "xor5", "add1", "shr1", "shr40", "x3"},
    "uint64": {"xor5", "x3"},
    "float64": {"add1", "x3", "sin", "tanh"},
    "int32": {"not", "xor5", "add1", "shr1", "x3"},
}


@pytest.mark.parametrize("dtype", sorted(_LOWERS))
def test_which_maps_lower_for_each_64bit_type(dtype):
    """The tape lowers exactly ``_LOWERS[dtype]`` (int32 beside them: its
    shifts stop at 31); where it lowers, its plain evaluation equals the
    function."""
    got = set()
    for name, fn in _MAPS.items():
        tape = map_lower.lower_map(f"pin64_{name}", fn, _TORCH[dtype])
        if not tape.lowered:
            continue
        got.add(name)
        u = _to_torch(_keys(dtype, (64,), seed=1)) if dtype != "int32" else \
            torch.arange(-32, 32, dtype=torch.int32) * 99991
        if dtype == "float64":
            u = torch.where(torch.isnan(u), torch.zeros_like(u), u)
        _same_bits(_to_numpy(map_lower.eval_tape(tape, u)),
                   _to_numpy(fn(u)), (dtype, name))
    assert got == _LOWERS[dtype], (dtype, got)


# constants 32 bits would cut: past 2^32, and a double float32 rounds
_WIDE_CONSTANTS = {
    "int64": (lambda v: v * 1000003 + ((1 << 40) + 7), (1 << 40) + 7),
    "uint64": (lambda v: v ^ ((1 << 63) + (1 << 35) + 5),
               (1 << 63) + (1 << 35) + 5),
    "float64": (lambda v: v * 0.1 + 1e300, 1e300),
}


@pytest.mark.parametrize("dtype", WIDE_TYPES)
def test_map_constant_keeps_all_64_bits(dtype):
    """A 64-bit tape keeps each constant whole: the tape words' constant
    pool (``tape_words``: a low and a high word a constant) gives back the
    constant's 64 bits, where one 32-bit word would cut it; a 32-bit
    type's high words are 0; the tape evaluates as eager torch does."""
    fn, const = _WIDE_CONSTANTS[dtype]
    tape = map_lower.lower_map(f"wide_const_{dtype}", fn, _TORCH[dtype])
    assert tape.lowered
    words = map_lower.tape_words(tape)
    pool = words[1 + len(tape.ops):]
    got = [((h & 0xFFFFFFFF) << 32) | (w & 0xFFFFFFFF)
           for w, h in zip(pool[0::2], pool[1::2])]
    bits = (int(np.float64(const).view(np.uint64)) if dtype == "float64"
            else const & 0xFFFFFFFFFFFFFFFF)
    assert bits in got and bits >> 32, (got, bits)
    want = [int(np.float64(c).view(np.uint64)) if dtype == "float64"
            else int(c) & 0xFFFFFFFFFFFFFFFF
            for _, opnds in tape.ops for k, c in opnds if k == map_lower.C]
    assert got == list(dict.fromkeys(want))
    narrow = map_lower.lower_map("wide_const_int32", lambda v: v + 7,
                                 torch.int32)
    assert map_lower.tape_words(narrow)[2:] == [7, 0]
    u = _to_torch(_keys(dtype, (256,), seed=2))
    if dtype == "float64":
        u = torch.where(torch.isnan(u), torch.zeros_like(u), u)
    _same_bits(_to_numpy(map_lower.eval_tape(tape, u)), _to_numpy(fn(u)),
               dtype)


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_wide_constant_in_the_epilogue_plan(dtype):
    """The plan of a map cluster holds the map's tape with its constants'
    high words, and the cluster (``emap >> sort >> emap``) runs fused (its
    plain version here) bit-equal to the reference under x64."""
    n = 7
    fn = {"int64": lambda v: v ^ ((1 << 40) + 3),
          "float64": lambda v: v * 3 + 1e300}[dtype]
    name = f"plan_wide_{dtype}"

    def expr(V, sort_expr):
        return V.seq(V.emap(name, fn), sort_expr(n), V.emap(name, fn))
    x = _keys(dtype, (1 << n,), seed=9)
    if dtype == "float64":
        x = np.where(np.isnan(x), 0.0, x)
    got, _, fall = _observed(pobs, lambda: pc.compile_expr(
        expr(PV, p_sort_expr), engine="cuda")(_to_torch(x)))
    assert fall == 0
    with jax.enable_x64(True):
        want = np.asarray(rc.compile_expr(expr(RV, r_sort_expr),
                                          engine="pallas")(jnp.asarray(x)))
    _same_bits(_to_numpy(got), want, dtype)
    t = pops.choose_tile(n, 8)
    prog = pc.compile_expr(expr(PV, p_sort_expr)).clustered_program(n, t)
    fs = next(s for s in prog if isinstance(s, pc.FusedStage)
              and any(isinstance(c, pc.Map) for c, _ in s.computes))
    plans, entries = pex._fused_plan_cached(fs, t)
    xz = torch.zeros(1 << n, dtype=_TORCH[dtype])
    ents = pk._epi_entries(*pex._fused_kernel_args(entries, xz.dtype),
                           xz.dtype)
    _, _, words, _ = pk._epi_launch_args(xz.reshape(1, -1, 1),
                                         pk.plan_geometry(plans[0]), ents)
    k = next(k for k, e in enumerate(ents) if e[0] == EP.KIND_MAP)
    tape, w = ents[k][9], words.numpy()
    tw = map_lower.tape_words(tape)
    at = int(EP.epi_slice(w, k)[EP.EP_MAP_TAPE])
    assert list(w[at:at + len(tw)]) == tw
    assert any(tw[1 + len(tape.ops) + 1::2])     # a constant's high word
