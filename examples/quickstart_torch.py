"""Quickstart: BMMC permutations through the public API of the PyTorch
port (``repro_torch``); the twin of ``examples/quickstart.py``.

Each permutation runs through ``repro_torch.kernels.ops.bmmc_permute``,
which dispatches it by class to a hand-written CUDA kernel (block K2,
lane K3, tiled pass K4a) on a card, or to that kernel's plain PyTorch
version on the CPU. Every step checks its output against the plain
gather ``repro_torch.kernels.ref.bmmc_ref`` and prints the class it
dispatched to.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--n 12]
"""
import argparse
import collections
import random

import numpy as np
import torch

from repro_torch.combinators import compile_expr, fuse, lower, num_perm_stages
from repro_torch.combinators import vocab as V
from repro_torch.core.bmmc import Bmmc
from repro_torch.core.parm import parm, parm_ref
from repro_torch.kernels.ops import (bmmc_permute, class_plan,
                                     modeled_transactions, num_passes)
from repro_torch.kernels.bmmc_permute import reset_launch_counts
from repro_torch.kernels.ref import bmmc_ref
from repro_torch.launch.cli import check, device_of, print_launches


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=12,
                    help="log2 elements of the arrays (default 12)")
    args = ap.parse_args(argv)
    dev = device_of(args.device, "quickstart_torch")
    n = args.n
    x = torch.arange(1 << n, dtype=torch.float32, device=dev)
    out = {"outputs": {}, "kernel": {}, "passes": {}, "bmmc": {}}
    reset_launch_counts()

    def permute(name, b, xs, t):
        y = bmmc_permute(xs, b, t=t)
        check(torch.equal(y, bmmc_ref(xs, b)), f"{name} != bmmc_ref")
        out["outputs"][name] = y.cpu()
        out["kernel"][name] = class_plan(b, t)[0]
        out["passes"][name] = num_passes(b, t)
        out["bmmc"][name] = (b.rows, b.c, t)
        return y

    # 1. BPC permutations: bit-reversal, transpose, reversal — one tiled pass
    half = n // 2
    for name, b in [("bit-reverse", Bmmc.bit_reverse(n)),
                    (f"matrix transpose {1 << half}x{1 << (n - half)}",
                     Bmmc.matrix_transpose(half, n - half)),
                    ("array reversal", Bmmc.reverse_array(n))]:
        permute(name, b, x, 4)
        print(f"{name:24s} passes={out['passes'][name]}  "
              f"kernel={out['kernel'][name]}  ok")

    # 1b. The copy-speed classes: a BMMC that moves only tile-index bits
    #     is a block permute (K2), one that moves only lane bits a lane
    #     permute (K3)
    for name, (i, j) in [("high bit swap", (4, n - 1)),
                         ("low bit swap", (0, 3))]:
        p = list(range(n))
        p[i], p[j] = p[j], p[i]
        permute(name, Bmmc.from_perm(p), x, 4)
        print(f"{name:24s} passes={out['passes'][name]}  "
              f"kernel={out['kernel'][name]}  ok")

    # 2. A general BMMC factorizes into two tiled passes (paper §5.2)
    b = Bmmc.random(n, random.Random(0))
    permute("random BMMC", b, x, 4)
    tx = modeled_transactions(b, t=4)
    out["tx"] = tx
    print(f"random BMMC              passes={tx['passes']}  "
          f"kernel={tx['kernel']}  "
          f"modeled bw fraction vs copy={tx['bandwidth_fraction']:.2f}")

    # 3. The parm combinator (paper §7): apply f to interleaved sub-arrays
    ys = parm(0b0101, lambda h: torch.cumsum(h, dim=0), x[:16])
    out["parm"] = ys.cpu()
    check(np.array_equal(ys.cpu().numpy(), parm_ref(
        0b0101, np.cumsum, x[:16].cpu().numpy())), "parm != parm_ref")
    print("parm 0b0101 cumsum on 16 elements:",
          ys.cpu().numpy().astype(np.int32))

    # 4. Permuting (tokens, features) rows — the framework-internal layout
    #    (counted in float32 and rounded to bfloat16, as jnp.arange does)
    tok = torch.arange((1 << 10) * 8, dtype=torch.float32, device=dev).to(
        torch.bfloat16).reshape(1 << 10, 8)
    shuffled = permute("row permute", Bmmc.random(10, random.Random(1)),
                       tok, 3)
    print("row permute (2^10, 8):", tuple(shuffled.shape), shuffled.dtype,
          f"kernel={out['kernel']['row permute']}")

    # 5. The combinator IR: compose lazily, fuse, run as one tiled pass
    e = V.riffle(n) >> V.bit_reverse(n) >> V.rev(n)
    out["stages"] = (num_perm_stages(lower(e, n)),
                     num_perm_stages(fuse(lower(e, n))))
    print(f"riffle >> bit_reverse >> rev: {out['stages'][0]} perms lowered "
          f"-> {out['stages'][1]} after fusion")
    f = compile_expr(e, engine="cuda")
    g = compile_expr(e, engine="ref")
    got = f(x)
    check(torch.equal(got, g(x)), "combinator pipeline cuda != ref")
    out["outputs"]["combinator"] = got.cpu()
    print("combinator pipeline agrees across engines  ok")

    out["histogram"] = dict(collections.Counter(out["kernel"].values()))
    print("class dispatch histogram:", out["histogram"])
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
