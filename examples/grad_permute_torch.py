"""Gradients and batches through BMMC permute layers (DESIGN.md §9), on the
PyTorch port; the twin of ``examples/grad_permute.py``.

A compiled combinator program is a differentiable torch function:
``loss.backward()`` flows through the tiled CUDA kernels via the
offline-inverted program (no gather transpose), and a leading batch dim
shares one tile plan. Where the reference takes ``jax.grad``, this script
takes ``torch.autograd``.

Step 2b goes beyond the reference: the gradient of a compute-bearing
program (the sorting network) on the gradient kernel route
(``combinators.execute.BWD_MEGAKERNEL = True``, the port's default): one
K5 pass per fused cluster on a card (its plain version on the CPU), held
bit for bit against the ``ref`` engine's gradient and against the
cotangent scattered to the sorting permutation.

Run: PYTHONPATH=src python examples/grad_permute_torch.py [--device cpu] [--n 10]
"""
import argparse
import random

import numpy as np
import torch

from repro_torch.combinators import cache_stats, compile_expr, vocab as V
from repro_torch.combinators import execute
from repro_torch.combinators.sort import compiled_sort
from repro_torch.core.bmmc import Bmmc
from repro_torch.kernels.bmmc_permute import (launch_counts,
                                              reset_launch_counts)
from repro_torch.launch.cli import (check, counting, device_of,
                                    print_launches)
from repro_torch.models.permute import PermuteLayer

# the executor caches a batched call shares with an unbatched one: plans
# and the tables kept on the device are per (matrix, t), not per shape
PLAN_CACHES = ("plans", "class_plan", "device_tables")


def plan_entries() -> dict:
    stats = cache_stats()
    return {k: stats[k].currsize for k in PLAN_CACHES}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=10,
                    help="log2 elements (default 10; the card takes 20)")
    args = ap.parse_args(argv)
    dev = device_of(args.device, "grad_permute_torch")
    check(execute.BWD_MEGAKERNEL, "the gradient kernel route is off")
    n = args.n
    rng = random.Random(0)
    b = Bmmc.random(n, rng)
    e = V.bit_reverse(n) >> V.perm(b) >> V.riffle(n)
    f = compile_expr(e, engine="cuda")
    out = {"bmmc": {"program": (b.rows, b.c)}}

    # 1. The VJP of a permutation program is its offline inverse program.
    print("forward program: ", f.program(n))
    print("vjp program:     ", f.vjp_program(n))

    # 2. autograd through the kernels == inverse permutation of the
    #    cotangent — checked against the ref-engine oracle.
    x = torch.tensor(np.random.default_rng(1).normal(size=1 << n),
                     dtype=torch.float32, device=dev)
    w = torch.tensor(np.random.default_rng(2).normal(size=1 << n),
                     dtype=torch.float32, device=dev)
    reset_launch_counts()
    xg = x.clone().requires_grad_()
    (w * f(xg)).sum().backward()
    g = xg.grad
    oracle = compile_expr(e, engine="ref").inverse(n)(w)
    exact = torch.equal(g, oracle)
    print("grad == P^-1(w):", exact)
    check(exact, "the permutation program's gradient != P^-1(w)")
    out["grad"] = g.cpu()

    # 2b. A compute-bearing program: the sorting network's gradient runs
    #     one K5 pass per fused cluster (distinct keys: the gradient is w
    #     sent back to where each sorted key came from)
    keys = torch.tensor(np.random.default_rng(4).permutation(1 << n),
                        dtype=torch.float32, device=dev)
    grads = {}
    k5 = -launch_counts()["tile_bwd"]
    for engine in ("ref", "cuda"):
        with counting() as obs:
            xk = keys.clone().requires_grad_()
            loss = (w * compiled_sort(n, engine=engine)(xk)).sum()
            fwd = obs.kernel_counts().get("fused", 0)
            loss.backward()
            fallback = obs.counter_total("dispatch.fused_fallback")
            fused_vjp = obs.kernel_counts().get("fused", 0) - fwd
        grads[engine] = xk.grad
    k5 += launch_counts()["tile_bwd"]
    scatter = torch.empty_like(w)
    scatter[torch.argsort(keys)] = w
    check(torch.equal(grads["cuda"], grads["ref"]),
          "sort gradient: cuda engine != ref engine")
    check(torch.equal(grads["cuda"], scatter),
          "sort gradient != w scattered to the sorting permutation")
    check(fused_vjp > 0 and fallback == 0,
          f"sort backward: {fused_vjp:g} fused VJPs, {fallback:g} fallbacks")
    if dev.type == "cuda":
        check(k5 == fused_vjp, f"K5 launched {k5} times for {fused_vjp:g} "
                               f"fused clusters")
    print(f"sort gradient == scattered w: True ({fused_vjp:g} fused "
          f"cluster VJPs, K5 launches {k5}, fused_fallback {fallback:g})")
    out["sort_grad"] = grads["cuda"].cpu()
    out["k5"] = k5

    # 3. A PermuteLayer in a tiny "model": gradient descent recovers a
    #    signal observed through a permuted channel.
    b = Bmmc.random(n, rng)
    out["bmmc"]["layer"] = (b.rows, b.c)
    layer = PermuteLayer(b, axis=1, engine="cuda")
    target = torch.tensor(np.random.default_rng(3).normal(size=(4, 1 << n)),
                          dtype=torch.float32, device=dev)
    y_obs = layer(target)

    def loss(params):
        return ((layer(params) - y_obs) ** 2).sum()

    # a permutation is orthogonal, so lr = 1/2 solves this in one step:
    # p - L^-1(L p - y) = L^-1 y
    params = torch.zeros_like(target, requires_grad=True)
    (grad,) = torch.autograd.grad(loss(params), params)
    params = (params - 0.5 * grad).detach()
    rec = float(loss(params))
    exact = torch.equal(params, target)
    print(f"recovery loss after 1 step: {rec:.2e}  (exact: {exact})")
    check(exact and rec == 0.0, "one step did not recover the signal")
    out["recovered"] = params.cpu()

    # 4. Batch scaling is free: the plan caches have the same entries no
    #    matter the batch size. The device tables are a byte-capped LRU,
    #    which steps 2b and 3 fill at the card's sizes; the first batched
    #    call may bring back a table of f's that a replay of f's captured
    #    graph never looked up. So the plans and class plans are held to
    #    their entries before the batches, and all three caches to the
    #    same entries at every batch size.
    before = plan_entries()
    seen = []
    for b in (2, 8, 32):
        f(x.repeat(b, 1), batched=True)
        seen.append(plan_entries())
    print("plan cache entries (plans, class plans, device tables) "
          "before/after batches:", sum(before.values()), "->",
          sum(seen[-1].values()))
    check(all(got == seen[0] for got in seen)
          and all(seen[0][k] == before[k] for k in PLAN_CACHES[:2]),
          f"a batch size added plan cache entries: {before} -> {seen}")
    print("cache_stats:", {k: v.currsize for k, v in cache_stats().items()
                           if v.currsize})
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
