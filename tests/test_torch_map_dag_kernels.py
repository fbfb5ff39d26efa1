"""Programs whose maps the chain tapes left out, through the fused kernels'
plain versions on the CPU, held against the reference.

* Forward: programs whose maps use exact ops (``where``, comparisons,
  ``maximum`` / ``minimum``, ``floor``, ``abs``, products by powers of
  two, integer ``//`` and ``%``), written once in torch and once in jnp,
  equal the reference's ``compile_expr(..., engine="pallas")`` bit for
  bit, with no fused fallback.
* Backward: a cluster of 6 and one of 12 maps (a sort with a map after
  each of its last compares) equal the reference's ``_fused_bwd_pallas``,
  the program's gradient runs with no fused fallback, and K5's plan keeps
  every map input or, with less room, recomputes some.

Inputs are made with numpy from a seed and handed to both packages.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro.combinators import execute as rex
from repro.combinators import vocab as RV
from repro.combinators.sort import compiled_sort as r_compiled_sort
from repro.core.bmmc import Bmmc as RBmmc
import repro_torch.combinators as pc
from repro_torch import obs as pobs
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import compiled_sort as p_compiled_sort
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import epilogue_plan as EP


def _fallbacks(fn):
    pobs.reset()
    pobs.enable()
    try:
        out = fn()
        return out, pobs.counter_total("dispatch.fused_fallback")
    finally:
        pobs.disable()
        pobs.reset()


# the maps of each dtype: (name, torch function, jnp function), exact ops
EXACT_MAPS = {
    np.float32: [
        ("leaky4", lambda v: torch.where(v > 0, v, v * 0.25),
         lambda v: jnp.where(v > 0, v, v * 0.25)),
        ("max_floor", lambda v: torch.maximum(v * 2, torch.floor(v)),
         lambda v: jnp.maximum(v * 2, jnp.floor(v))),
        ("band", lambda v: torch.where(torch.logical_and(v > -1, v <= 1),
                                       torch.abs(v) * 4, -v),
         lambda v: jnp.where(jnp.logical_and(v > -1, v <= 1),
                             jnp.abs(v) * 4, -v)),
    ],
    np.int32: [
        ("fdiv", lambda v: v // 3, lambda v: v // 3),
        ("rem", lambda v: v % -7 + torch.minimum(v, v * 2),
         lambda v: v % -7 + jnp.minimum(v, v * 2)),
        ("sel", lambda v: torch.where(v != 5, v * 4, torch.abs(v)),
         lambda v: jnp.where(v != 5, v * 4, jnp.abs(v))),
    ],
}


def _program(V, Bmmc, n, maps):
    rng = random.Random(29)
    parts = [V.perm(Bmmc.random_bpc(n, rng))]
    for name, fn in maps:
        parts += [V.cmp_halves(), V.emap(name, fn),
                  V.perm(Bmmc.random_bpc(n, rng))]
    return V.seq(*parts, V.perm(Bmmc.random(n, rng)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_exact_dag_maps_match_reference_bit_for_bit(dtype):
    n = 8
    maps = EXACT_MAPS[dtype]
    pf = pc.compile_expr(_program(PV, PBmmc, n, [(m, f) for m, f, _ in maps]),
                         engine="cuda")
    rf = rc.compile_expr(_program(RV, RBmmc, n, [(m, j) for m, _, j in maps]),
                         engine="pallas")
    rng = np.random.default_rng(5)
    if dtype == np.int32:
        x = rng.integers(-1000, 1000, 1 << n).astype(np.int32)
    else:
        x = (rng.integers(-16, 17, 1 << n) / 4).astype(np.float32)
        x[::3] = rng.normal(size=x[::3].shape) * 3
    got, fb = _fallbacks(lambda: pf(torch.from_numpy(x)).numpy())
    assert fb == 0
    want = np.asarray(rf(jnp.asarray(x)))
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# differentiable maps, bounded, with values read by several ops
GRAD_MAPS = [
    ("g_leaky", lambda v: torch.where(v > 0, v, v * 0.25),
     lambda v: jnp.where(v > 0, v, v * 0.25)),
    ("g_tanhv", lambda v: torch.tanh(v) * v * 0.5,
     lambda v: jnp.tanh(v) * v * 0.5),
    ("g_affine_tanh", lambda v: v * 0.5 + torch.tanh(v),
     lambda v: v * 0.5 + jnp.tanh(v)),
    ("g_band", lambda v: torch.where(v < 1, v * 2, v - 1),
     lambda v: jnp.where(v < 1, v * 2, v - 1)),
    ("g_frac", lambda v: v - torch.floor(v) * 0.5,
     lambda v: v - jnp.floor(v) * 0.5),
    ("g_sq", lambda v: v * v * 0.25 - v,
     lambda v: v * v * 0.25 - v),
]


def _sort_with_maps(compiled_sort, V, n, k, side):
    """The sort of 2^n with a map after each of its last ``k`` compares
    (``side`` 1: torch functions, 2: jnp)."""
    stages = list(compiled_sort(n).program(n))
    at = [i for i, s in enumerate(stages) if type(s).__name__ == "CmpHalves"]
    for j, i in enumerate(reversed(at[-k:])):
        m = GRAD_MAPS[j % len(GRAD_MAPS)]
        stages.insert(i + 1, V.emap(f"{m[0]}_{j}", m[side]))
    return V.seq(*stages)


def _most_maps(prog, FusedStage):
    return max((i for i, s in enumerate(prog)
                if isinstance(s, FusedStage) and s.computes),
               key=lambda i: sum(type(c).__name__ == "Map"
                                 for c, _ in prog[i].computes))


@pytest.mark.parametrize("k", [6, 12])
def test_clusters_of_many_maps_backward_match_reference(k):
    n, t = 8, 4
    rp = rc.compile_expr(_sort_with_maps(r_compiled_sort, RV, n, k, 2),
                         engine="pallas").clustered_program(n, t)
    pf = pc.compile_expr(_sort_with_maps(p_compiled_sort, PV, n, k, 1),
                         engine="cuda")
    pp = pf.clustered_program(n, t)
    i = _most_maps(pp, pc.FusedStage)
    pfs, rfs = pp[i], rp[i]
    n_maps = sum(type(c).__name__ == "Map" for c, _ in pfs.computes)
    assert n_maps >= min(k, 6)
    assert [type(c).__name__ for c, _ in pfs.computes] == [
        type(c).__name__ for c, _ in rfs.computes]
    rng = np.random.default_rng(k)
    x = rng.normal(size=1 << n).astype(np.float32)
    ct = rng.normal(size=1 << n).astype(np.float32)
    want = np.asarray(rex._fused_bwd_pallas(rfs, t, False, jnp.asarray(x),
                                            jnp.asarray(ct)))
    got = pex._fused_bwd_cuda(pfs, t, False, torch.from_numpy(x),
                              torch.from_numpy(ct))
    assert pk.launch_counts()["tile_bwd"] == 0    # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # K5's plan for the cluster: every input kept, or with room for three
    # sets, the first map's of each phase kept and the rest recomputed
    plans, entries = pex._fused_plan_cached(pfs, t)
    xt = torch.from_numpy(x)
    ents = pk._epi_entries(*pex._fused_kernel_args(entries, xt.dtype),
                           xt.dtype)
    geo = pk.plan_geometry(plans[0])
    words = pk._epi_launch_args(xt.reshape(1, -1, 1), geo, ents, n_buf=2)[2]
    assert words.info["maps"] == n_maps
    assert words.info["map_slots"] == n_maps
    phases = words.info["n_phases"]
    small = EP.plan_epilogues(
        [e[:3] + tuple(None if a is None else np.asarray(a) for a in e[3:9])
         + (e[9] if e[0] == EP.KIND_MAP else None,) for e in ents],
        geo, pk._epi_item(geo, 4)[0], elem_bytes=4,
        stride_bytes=pk._epi_item(geo, 4)[1], access=4, dv=1, reg_bits=3,
        map_slots=phases + 1)
    frm = [int(EP.epi_slice(small[0], e)[EP.EP_MAP_FROM])
           for e in range(len(ents)) if ents[e][0] == EP.KIND_MAP]
    assert sum(f < 0 for f in frm) == min(phases, n_maps)
    assert small[1]["map_slots"] == min(phases + 1, n_maps)


@pytest.mark.parametrize("k", [6, 12])
def test_program_gradient_with_many_maps_has_no_fallback(k):
    """The gradient of a sort with a map after each of its last ``k``
    compares runs each map cluster through K5 (its plain version here),
    with no fused fallback, equal to autograd through the same program
    stage by stage on the ``ref`` engine."""
    n = 7
    expr = _sort_with_maps(p_compiled_sort, PV, n, k, 1)
    f = pc.compile_expr(expr, engine="cuda")
    fr = pc.compile_expr(expr, engine="ref")
    rng = np.random.default_rng(k + 1)
    x = torch.from_numpy(rng.normal(size=1 << n).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=1 << n).astype(np.float32))

    def grad(fn):
        v = x.clone().requires_grad_(True)
        (w * fn(v)).sum().backward()
        return v.grad
    got, fb = _fallbacks(lambda: grad(f))
    assert fb == 0
    want = grad(fr)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
