"""Paper §7: merge sort with a balanced periodic merger, as a combinator
expression, on the PyTorch port; the twin of
``examples/sorting_network.py``.

The declarative network (``parm`` recursion in
``repro_torch.combinators.sort``) lowers to a [BMMC permute |
compare-exchange] stage program; BMMC fusion collapses most of the
permutation stages, and on the ``cuda`` engine the clustering runs the
compare-exchange sweeps inside the fused tiled passes: one launch of the
fused kernel K4b per cluster on a card (its plain version on the CPU).
The script prints the K4b launches of the cold call and checks that no
cluster fell back to stage-by-stage execution
(``dispatch.fused_fallback``).

Run: PYTHONPATH=src python examples/sorting_network_torch.py [--device cpu] [--n 10]
"""
import argparse

import numpy as np
import torch

from repro_torch.combinators import fuse, lower, num_perm_stages
from repro_torch.combinators.sort import compiled_sort, sort_expr
from repro_torch.core.sort import sort_rec
from repro_torch.kernels.bmmc_permute import (launch_counts,
                                              reset_launch_counts)
from repro_torch.launch.cli import (check, counting, device_of,
                                    print_launches, timed_ms)

# sort_rec, the paper's recursion in numpy, makes about n * 2^n calls:
# past this size the script skips it (np.sort stays the oracle)
MAX_N_RECURSION = 14


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=10,
                    help="log2 keys (default 10; the card takes 24)")
    args = ap.parse_args(argv)
    dev = device_of(args.device, "sorting_network_torch")
    n = args.n
    xs = np.random.default_rng(0).integers(0, 10**6, size=1 << n).astype(
        np.int32)
    want = np.sort(xs)

    # reference recursion (paper pseudocode, numpy)
    if n <= MAX_N_RECURSION:
        ref = sort_rec(n, xs.copy())
        check(np.array_equal(ref, want), "sort_rec != np.sort")

    # the lazy expression, lowered and fused offline
    raw = lower(sort_expr(n), n)
    prog = fuse(raw)
    stages = (num_perm_stages(raw), num_perm_stages(prog),
              len(prog) - num_perm_stages(prog))
    print(f"2^{n} elements: {stages[0]} raw perm stages "
          f"-> {stages[1]} fused BMMC stages "
          f"({stages[2]} compare-exchange sweeps)")

    # run through both engines via the compiled-plan cache
    x = torch.from_numpy(xs).to(dev)
    got_ref = compiled_sort(n, engine="ref")(x).cpu().numpy()
    cuda_sort = compiled_sort(n, engine="cuda")
    reset_launch_counts()
    with counting() as obs:
        got, cold_ms = timed_ms(lambda: cuda_sort(x), dev)
        fused = obs.kernel_counts().get("fused", 0)
        fallback = obs.counter_total("dispatch.fused_fallback")
    k4b = launch_counts()["tile_fused"]
    got = got.cpu().numpy()
    check(np.array_equal(got_ref, want), "ref engine did not sort")
    check(np.array_equal(got, want), "cuda engine did not sort")
    check(fused > 0, "no fused cluster ran")
    check(fallback == 0, f"{fallback} cluster(s) fell back stage by stage")
    if dev.type == "cuda":
        check(k4b == fused, f"K4b launched {k4b} times for {fused} clusters")
    where = "K4b" if dev.type == "cuda" else "K4b's plain version on the CPU"
    print(f"sorted correctly via the fused tiled passes ({where}; {fused} "
          f"fused clusters, K4b launches {k4b}, fused_fallback "
          f"{fallback:g}; {cold_ms:.2f} ms cold)")
    warm, warm_ms = timed_ms(lambda: cuda_sort(x), dev)
    check(np.array_equal(warm.cpu().numpy(), want), "warm re-run")
    how = "a captured CUDA graph" if dev.type == "cuda" else "cached plans"
    print(f"warm re-run {warm_ms:.3f} ms ({how})")
    launches = print_launches()
    return {"stages": stages, "sorted": got, "ref_sorted": got_ref,
            "fused": fused, "fused_fallback": fallback, "k4b": k4b,
            "launches": launches}


if __name__ == "__main__":
    main()
