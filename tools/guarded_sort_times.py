#!/usr/bin/env python3
"""Time the guarded and the unguarded 2^24 int32 sort of a checkout on one
GPU, one call each (CUDA graphs), in turns.

    python3 tools/guarded_sort_times.py --src OTHER/src --tag parent
    python3 tools/guarded_sort_times.py --src src --tag change

The checkout's ``repro_torch`` is imported from ``--src`` (its kernels
build into that checkout's ``build/kernels``); the sort is held bit for
bit against ``torch.sort`` guarded and unguarded, then timed in turns
(``chip_smoke.py``'s ``cuda_ms`` and ``in_turns``: 20 calls a reading,
three rounds each way). Two checkouts compare only within one run on one
card: run parent, change, change, parent. Imports torch and the
checkout's ``repro_torch`` only.
"""
import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="this", help="label of each line")
    args = ap.parse_args(argv)
    sys.path[:0] = [args.src, str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("guarded_sort_times: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, in_turns
    from repro_torch import guard
    from repro_torch.combinators import sort as S
    from repro_torch.kernels import build as B
    B.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = torch.randint(-2**31, 2**31 - 1, (1 << 24,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    f = S.compiled_sort(24)
    want = torch.sort(xs).values

    def guarded():
        with guard.guarded():
            return f(xs)
    if not (torch.equal(f(xs), want) and torch.equal(guarded(), want)):
        raise SystemExit("guarded_sort_times: the sort differs from torch")
    turns = in_turns({"guarded": guarded, "unguarded": lambda: f(xs)},
                     lambda fn: cuda_ms(torch, fn, 20, warmup=3), 3)
    print(args.tag, "sort 2^24 int32 one call, in turns:", turns,
          "medians", {k: statistics.median(v) for k, v in turns.items()},
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
