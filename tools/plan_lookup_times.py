#!/usr/bin/env python3
"""Time the host's per-call plan lookups of a map cluster beside
butterflies, for the first lowering of ``emap(m) >> fft`` and for the
lowering of the same FFT behind another map. Runs on the CPU (planning
only; no card).

    python3 tools/plan_lookup_times.py --src OTHER/src --n 20
    python3 tools/plan_lookup_times.py --n 20

Each lowering of an FFT lifts its own butterfly stages of 2^(n-1)
twiddles, so a cache keyed by a stage meets equal stages of other
lowerings; the second program's lookups show what comparing them costs.
Prints one JSON line: milliseconds a call of ``_fused_kernel_args`` and
``_fused_plan_cached`` for each program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src/ (default: this one's)")
    ap.add_argument("--n", type=int, default=20, help="FFT size bits")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import vocab as V

    def tanh_cast(v):
        return torch.tanh(v.float()).to(v.dtype)

    x = torch.zeros(1 << args.n, 2, dtype=torch.bfloat16)

    def lookups(f):
        prog, t = f._resolve(x, False)
        (fs,) = [s for s in prog if isinstance(s, FusedStage) and {
            "Map", "Bfly"} <= {type(c).__name__ for c, _ in s.computes}]
        _, entries = ex._fused_plan_cached(fs, t)
        ex._fused_kernel_args(entries, x.dtype)
        got = {}
        for name, call in (
                ("kernel_args", lambda: ex._fused_kernel_args(entries,
                                                              x.dtype)),
                ("plan_cached", lambda: ex._fused_plan_cached(fs, t))):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                call()
            got[name] = (time.perf_counter() - t0) / args.calls * 1e3
        return got

    expr = V.seq(V.emap("tanh_cast", tanh_cast), F.fft_expr(args.n))
    first = lookups(compile_expr(expr))
    # another map's program: lowered anew, its butterflies equal the first's
    second = lookups(compile_expr(V.seq(V.emap("tanh_cast_2", tanh_cast),
                                        F.fft_expr(args.n))))
    print(json.dumps({"src": args.src, "n": args.n,
                      "first_ms": first, "second_ms": second}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
