#!/usr/bin/env python3
"""Time the copy kernel K1 of a checkout against ``x.clone()`` on one GPU.

    python3 tools/copy_kernel_times.py                  # this checkout
    python3 tools/copy_kernel_times.py --src OTHER/src --tag parent \\
        --build-dir build/parent

For the checkout whose ``src/`` is given (its ``repro_torch`` is imported
from there, and its kernels build into ``--build-dir``), prints, each line
led by ``--tag``:

* K1 (``copy_blocks``) and ``x.clone()`` in turns (K1, clone, clone, K1,
  repeated ``--rounds`` times; each turn the median of ``--reps`` calls)
  on int32 arrays of 2^14, 2^20, 2^24 and 2^30 elements, of 2^30 - 1
  elements, and on a source view at a 4-byte offset (``x[1:]``, 2^30 - 1
  elements): every turn's reading as the time of one call (CUDA events
  around the Python call), as device time (10 calls captured in one
  CUDA graph, 2 from 2^30 on; a graph turns ``clone``'s copy into a
  memcpy node, which runs slower than the eager copy) and as device time
  from the profiler (the kernels and copies of 10 eager calls, CUPTI),
  each with the median and the spread; at
  2^14 also the host's launch path of each (host clock per call over 50
  calls queued without a wait);
* K1's path and schedule at each size (a checkout with
  ``copy_schedule``);
* with ``--bulk`` (a checkout with the bulk path): at 2^30 int32, K1's
  bulk-copy ring (``_copy_cuda(x, "bulk")``) in turns with K1's words
  path and ``clone`` (other variants: ``tools/copy_sweep.py``);
* with ``--perms``: K2 (block class), K3 (lane class) and K4a
  (bit-reverse) at 2^30 int32 through ``ops.bmmc_permute``, in turns with
  K1 and ``clone``, and each one's copy ratio (copy time / its time)
  against both.

The timers are ``chip_smoke.py``'s own (``cuda_ms``, ``device_ms``). Two
checkouts compare only within one run on one card: run them in turns
(parent, change, change, parent). Imports torch and the checkout's
``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(v: list) -> str:
    return (f"median {statistics.median(v):.4f} ms (min {min(v):.4f}, max "
            f"{max(v):.4f}; {' '.join(f'{t:.4f}' for t in v)})")


def kernel_ms(torch, fn, calls: int = 10) -> float:
    """Device milliseconds a call of ``fn`` from the profiler's record of
    the kernels and copies ``calls`` calls ran on the card (CUPTI): unlike
    a graph, it sees ``clone``'s copy as eager calls run it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not total:
        raise SystemExit("the profiler saw no device time")
    return total / calls / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="this", help="label of each line")
    ap.add_argument("--build-dir", default=None,
                    help="where its kernels build (REPRO_TORCH_BUILD_DIR)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternations of (K1, clone, clone, K1)")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per turn (the median is the turn's reading)")
    ap.add_argument("--bulk", action="store_true",
                    help="also time K1's bulk-copy ring at 2^30")
    ap.add_argument("--perms", action="store_true",
                    help="also time K2, K3 and K4a and their copy ratios")
    args = ap.parse_args(argv)
    if args.build_dir:
        os.environ["REPRO_TORCH_BUILD_DIR"] = args.build_dir
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_ms, in_turns, make_cases
    sys.path.insert(0, args.src)       # ahead of the path chip_smoke adds
    import torch
    if not torch.cuda.is_available():
        print("copy_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bmmc_permute as pk
    from repro_torch.kernels import build, ops

    tag = args.tag
    say = (lambda *a: print(tag, *a, flush=True))
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    build.build_all(["copy", "block", "lane", "tile"] if args.perms
                    else ["copy"])
    for ln in build.BUILD_LOG.get("copy", {}).get("ptxas", "").splitlines():
        if "Used" in ln or "Function properties" in ln:
            say("copy ptxas:", ln.strip())
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    has_schedule = hasattr(pk, "_copy_cuda")
    timed = (lambda fn: cuda_ms(torch, fn, args.reps))

    def path_of(x, out, path="words"):
        if not has_schedule:
            return "one path (8 x 256-element blocks, the widest word)"
        s = pk.copy_schedule(x.numel() * x.element_size(), x.data_ptr(),
                             out.data_ptr(), n_sm, path=path)
        return (f"{s.path}: head {s.head}, body {s.body}, tail {s.tail}, "
                f"word {s.word_bytes} B, chunk {s.chunk_bytes} B"
                f"{f' x {s.stages} stages' if s.stages else ''}, "
                f"grid {s.grid} x {s.threads}")

    def launch_path_ms(fn, reps=50):
        """Host milliseconds a call, over ``reps`` calls queued without a
        wait."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t1) / reps * 1e3
        torch.cuda.synchronize()
        return host

    big = torch.randint(-2**31, 2**31 - 1, (1 << 30,), device=dev,
                        dtype=torch.int32)
    cases = [(f"2^{k} int32", big[:1 << k]) for k in (14, 20, 24)]
    cases += [("2^30 int32", big), ("2^30 - 1 int32", big[:-1]),
              ("2^30 - 1 int32 at a 4-byte offset", big[1:])]
    for label, x in cases:
        out = pk.copy_blocks(x)
        torch.cuda.synchronize()
        ok = torch.equal(out, x)
        say(f"{label}: K1 {'bit-equal' if ok else 'WRONG'}; "
            f"{path_of(x, out)}")
        del out
        if not ok:
            return 1
        fns = {"K1": lambda: pk.copy_blocks(x), "clone": lambda: x.clone()}
        got = in_turns(fns, timed, args.rounds)
        for k, v in got.items():
            gbs = 2 * x.numel() * 4 / statistics.median(v) / 1e6
            say(f"{label} {k} one call: {summary(v)}, {gbs:.1f} GB/s")
        inner = 10 if x.numel() <= 1 << 24 else 2
        dv = in_turns(fns, lambda fn: device_ms(torch, fn, inner), args.rounds)
        for k, v in dv.items():
            gbs = 2 * x.numel() * 4 / statistics.median(v) / 1e6
            say(f"{label} {k} device ({inner} calls in a graph): "
                f"{summary(v)}, {gbs:.1f} GB/s")
        kv = in_turns(fns, lambda fn: kernel_ms(torch, fn), args.rounds)
        for k, v in kv.items():
            gbs = 2 * x.numel() * 4 / statistics.median(v) / 1e6
            say(f"{label} {k} device (profiler, 10 calls): {summary(v)}, "
                f"{gbs:.1f} GB/s")
        if x.numel() == 1 << 14:
            say(f"{label} host launch path: K1 "
                f"{launch_path_ms(fns['K1']):.4f} ms, clone "
                f"{launch_path_ms(fns['clone']):.4f} ms")
        torch.cuda.empty_cache()

    if args.bulk and has_schedule:
        x = big
        fns = {"bulk ring": lambda: pk._copy_cuda(x, "bulk"),
               "K1 (words)": lambda: pk.copy_blocks(x),
               "clone": lambda: x.clone()}
        y = fns["bulk ring"]()
        torch.cuda.synchronize()
        ok = torch.equal(y, x)
        say(f"2^30 int32 bulk ring: {'bit-equal' if ok else 'WRONG'}; "
            f"{path_of(x, y, 'bulk')}")
        del y
        if not ok:
            return 1
        got = in_turns(fns, timed, args.rounds)
        for k, v in got.items():
            say(f"2^30 int32 {k} one call: {summary(v)}")
        kv = in_turns(fns, lambda fn: kernel_ms(torch, fn), args.rounds)
        for k, v in kv.items():
            say(f"2^30 int32 {k} device (profiler, 10 calls): {summary(v)}")

    if args.perms:
        x = big
        n = 30
        t = ops.choose_tile(n, 4)
        named = {name: b for name, b, _ in make_cases(n, t)}
        fns = {"K1": lambda: pk.copy_blocks(x), "clone": lambda: x.clone()}
        for label, case in (("K2", "block-class"), ("K3", "lane-class"),
                            ("K4a", "bit-reverse")):
            b = named[case]
            ops.bmmc_permute(x, b)
            fns[label] = lambda b=b: ops.bmmc_permute(x, b)
        got = in_turns(fns, timed, args.rounds)
        med = {k: statistics.median(v) for k, v in got.items()}
        for k, v in got.items():
            say(f"2^30 int32 {k}: {summary(v)}")
        for k in ("K2", "K3", "K4a"):
            say(f"copy ratio of {k}: K1 / {k} {med['K1'] / med[k]:.4f}, "
                f"clone / {k} {med['clone'] / med[k]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
