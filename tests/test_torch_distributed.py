"""The port's distributed BMMC (``repro_torch.core.distributed``) against
the reference, on the CPU.

* The planners are the reference's numpy code: for each ``n`` in 5..12
  and ``s`` in 1..4 (the reference test's ranges), random BPC and general
  BMMCs with nonzero complements give plans equal round for round, field
  for field, and equal ``plan_cost`` (at most 2 exchange rounds).
* The executor runs on ``gloo`` worlds of 2, 4 and 8 spawned ranks
  (``_torch_mesh.spawn``), each rank holding its shard; the shards of
  the output, concatenated in rank order, equal the reference's
  ``repro.kernels.ref.bmmc_ref`` of the whole array bit for bit.
"""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh
from repro.core import distributed as RD
from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels.ref import bmmc_ref
from repro_torch.core import distributed as TD
from repro_torch.core.bmmc import Bmmc as TBmmc


def _bmmc(n, seed, bpc):
    rng = random.Random(seed)
    b = RBmmc.random_bpc(n, rng) if bpc else RBmmc.random(n, rng)
    c = b.c or 1          # a nonzero complement
    return RBmmc(b.rows, c), TBmmc(b.rows, c)


def _fields(plan):
    return [(type(r).__name__, dataclasses.astuple(r)) for r in plan]


@pytest.mark.parametrize("n,s", [(n, s) for n in range(5, 13)
                                 for s in range(1, 5) if s < n - 1])
def test_plans_equal_the_reference_round_for_round(n, s):
    for seed in range(3):
        for bpc in (True, False):
            rb, tb = _bmmc(n, 1000 * n + 10 * s + seed, bpc)
            rplan, tplan = RD.make_plan(rb, s), TD.make_plan(tb, s)
            assert _fields(tplan) == _fields(rplan)
            got = TD.plan_to_bmmc(tplan, n, s)
            assert got.rows == tb.rows and got.c == tb.c
            cost = TD.plan_cost(tplan)
            assert cost == RD.plan_cost(rplan)
            assert cost["exchange"] <= 2 and cost["permute"] <= 6


def test_separable_needs_no_exchange():
    n, s = 10, 3
    local = TBmmc.random(n - s, random.Random(0))
    rows = tuple(local.rows) + tuple(1 << i for i in range(n - s, n))
    cost = TD.plan_cost(TD.make_plan(TBmmc(rows, 5), s))
    assert cost["exchange"] == 0 and cost["permute"] <= 1


def _exec_cases(s):
    """(rows, c, n, x) for a world of 2^s ranks: BPC and general BMMCs
    with nonzero complements at two sizes, one with a d = 3 tail."""
    rng = np.random.default_rng(s)
    cases = []
    for n in (s + 2, s + 5):
        for trial in range(3):
            _, b = _bmmc(n, 97 * s + 7 * n + trial, trial % 2 == 0)
            shape = (1 << n,) if trial < 2 else (1 << n, 3)
            x = rng.standard_normal(shape).astype(np.float32)
            cases.append((b.rows, b.c, n, x))
    return cases


@pytest.mark.parametrize("world", [2, 4, 8])
def test_executor_on_gloo_ranks_equals_bmmc_ref(world, tmp_path):
    s = world.bit_length() - 1
    cases = _exec_cases(s)
    shards = _torch_mesh.spawn(_torch_mesh.bmmc_worker, world, tmp_path,
                               cases, timeout=150)
    for i, (rows, c, n, x) in enumerate(cases):
        got = np.concatenate([r[i] for r in shards])
        want = np.asarray(bmmc_ref(jnp.asarray(x), RBmmc(rows, c)))
        assert np.array_equal(got, want), (world, n, i)
