"""Distributed BMMC permutation over a sharded array (beyond-paper), on the
PyTorch port; the twin of ``examples/distributed_permute.py``.

Plans a global BMMC as local rounds + shard permutes + at most 2
all-to-all exchange rounds (the sharded analogue of the paper's two-pass
theorem), runs it with ``repro_torch.core.distributed.distributed_bmmc``
on every rank of a ``torch.distributed`` world, and checks the shards of
the result, in rank order, against the single-device oracle
``repro_torch.kernels.ref.bmmc_ref``.

``--device cpu`` (the reference's layout): 2^s ``gloo`` ranks on the CPU
(default 16), spawned from this script and joined over a file store in a
temporary directory; each rank's local rounds run the kernels' plain
versions. ``--device cuda``: one NCCL rank on the card over a (1, 1)
mesh (``launch.mesh.make_dev_mesh(1, 1)``). One rank holds the whole
array, so its plan is one local round, which runs through
``kernels.ops.bmmc_permute`` (K4a for these matrices); the script prints
that one round, and beside it, marked as not run, the round counts of
the 2^s-shard plan. Running that plan on NCCL ranks, with its
exchanges between cards, waits for a machine with more than one GPU.

Run: PYTHONPATH=src python examples/distributed_permute_torch.py [--device cpu] [--s 4]
"""
import argparse
import random
import tempfile

import torch

from repro_torch.core.bmmc import Bmmc
from repro_torch.core.distributed import (LocalRound, binary_mesh,
                                          distributed_bmmc, make_plan,
                                          plan_cost, plan_to_bmmc, run_plan)
from repro_torch.kernels.bmmc_permute import reset_launch_counts
from repro_torch.kernels.ref import bmmc_ref
from repro_torch.launch.cli import check, device_of, print_launches
from repro_torch.launch.mesh import make_dev_mesh, spawn_gloo

RANK_TIMEOUT_S = 300.0


def cases(n: int):
    """The reference's three BMMCs on 2^n elements."""
    half = n // 2
    return [("bit-reverse", Bmmc.bit_reverse(n)),
            ("matrix transpose", Bmmc.matrix_transpose(half, n - half)),
            ("random BMMC", Bmmc.random(n, random.Random(0)))]


def rank_shards(rank: int, world: int, n: int) -> list:
    """This gloo rank's shard of each case's output."""
    s = world.bit_length() - 1
    mesh = binary_mesh(s, device="cpu")
    nl = n - s
    x = torch.arange(1 << n, dtype=torch.float32)
    return [distributed_bmmc(x[rank << nl:(rank + 1) << nl], b, s, mesh)
            for _, b in cases(n)]


def run_gloo(n: int, s: int) -> list:
    """Each case's output on 2^s gloo ranks: the shards concatenated in
    rank order."""
    with tempfile.TemporaryDirectory(prefix="bmmc_dist_") as d:
        shards = spawn_gloo(rank_shards, 1 << s, d, n,
                            timeout=RANK_TIMEOUT_S)
    return [torch.cat([sh[i] for sh in shards]) for i in range(len(shards[0]))]


def run_one_rank(n: int, dev: torch.device) -> list:
    """Each case's output on one NCCL rank of a (1, 1) mesh: the whole
    array is the rank's shard, the plan one local round."""
    mesh = make_dev_mesh(1, 1, device=dev.type)
    try:
        x = torch.arange(1 << n, dtype=torch.float32, device=dev)
        got = []
        for _, b in cases(n):
            plan = [LocalRound(n, b.rows, b.c, (0,) * n)]
            whole = plan_to_bmmc(plan, n, 0)
            check(whole.rows == b.rows and whole.c == b.c,
                  "the one-rank plan is not the BMMC")
            got.append(run_plan(x, plan, 0, mesh))
        torch.cuda.synchronize(dev)
        return got
    finally:
        mesh.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (one NCCL rank on the card; the default) or "
                         "cpu (2^s gloo ranks)")
    ap.add_argument("--n", type=int, default=14,
                    help="log2 elements (default 14)")
    ap.add_argument("--s", type=int, default=4,
                    help="log2 shards (default 4: 16 ranks on the CPU)")
    args = ap.parse_args(argv)
    dev = device_of(args.device, "distributed_permute_torch")
    n, s = args.n, args.s
    reset_launch_counts()
    if dev.type == "cuda":
        got = run_one_rank(n, dev)
        where = "1 NCCL rank"
    else:
        got = run_gloo(n, s)
        where = f"{1 << s} gloo ranks"
    x = torch.arange(1 << n, dtype=torch.float32)
    out = {"outputs": {}, "cost": {}}
    for (name, b), y in zip(cases(n), got):
        cost = plan_cost(make_plan(b, s))
        y = y.cpu()
        ok = torch.equal(y, bmmc_ref(x, b))
        rounds = (f"{cost['local']} local, {cost['permute']} permute, "
                  f"{cost['exchange']} all-to-all "
                  f"({cost['exchange_bits']} bits)")
        if dev.type == "cuda":
            print(f"{name:18s} rounds: 1 local  on {where}  correct={ok}; "
                  f"{1 << s}-shard plan (not run: one card): {rounds}")
        else:
            print(f"{name:18s} rounds: {rounds}  on {where}  correct={ok}")
        check(ok, f"{name} on {where} != bmmc_ref")
        out["outputs"][name] = y
        out["cost"][name] = cost
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
