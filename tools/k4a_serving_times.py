#!/usr/bin/env python3
"""Time the serving shuffle's K4a calls of a checkout on one GPU: the
host path a call and one call of a prefill layer's four shuffles.

    python3 tools/k4a_serving_times.py                  # this checkout
    python3 tools/k4a_serving_times.py --src OTHER/src --tag parent \\
        --build-dir OTHER/build/kernels

For the checkout whose ``src/`` is given (its ``repro_torch`` imported
from there, its K4a built into ``--build-dir``), at the three shapes the
kv-head shuffle of Mistral-NeMo-12B's prefill gives K4a (``(2048, 8,
128)`` bfloat16 for k and v, ``(2048, 8, 512)`` bfloat16 for the q
groups and float32 for the output; t = 1), prints:

* one call of ``tiled_permute`` at each shape (CUDA events around the
  Python call, median of ``--reps``), and the four shuffles of one layer
  (k and v counted twice), as ``chip_smoke.py`` phase 15 reports them;
* the host's launch path a call (host clock over 200 calls queued
  without a wait).

The timers are ``chip_smoke.py``'s own. Two checkouts compare only
within one run on one card: run them in turns (parent, change, change,
parent), each in its own process. Imports torch and the checkout's
``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("k, v", (2048, 8, 128), "bfloat16", 2),
          ("q groups", (2048, 8, 512), "bfloat16", 1),
          ("output", (2048, 8, 512), "float32", 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="this", help="label of each line")
    ap.add_argument("--build-dir", default=None,
                    help="where its kernels build (REPRO_TORCH_BUILD_DIR)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if args.build_dir:
        os.environ["REPRO_TORCH_BUILD_DIR"] = args.build_dir
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms
    sys.path.insert(0, args.src)       # ahead of the path chip_smoke adds
    import torch
    if not torch.cuda.is_available():
        print("k4a_serving_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.kernels import bmmc_permute as pk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    b = Bmmc.bit_reverse(3)
    layer, line = 0.0, []
    for name, shape, dtype, per_layer in SHAPES:
        x = torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dtype))
        plan = ops.class_plan(b, 1)[1][0]
        assert torch.equal(pk.tiled_permute(x, plan, batched=True),
                           pk.tiled_permute_plain(x, plan, batched=True))
        one = cuda_ms(torch, lambda: pk.tiled_permute(x, plan, batched=True),
                      args.reps, warmup=5)
        for _ in range(5):
            pk.tiled_permute(x, plan, batched=True)
        torch.cuda.synchronize()
        hosts = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                pk.tiled_permute(x, plan, batched=True)
            hosts.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        layer += per_layer * one
        line.append(f"{name} {tuple(shape)} {dtype}: one call {one:.4f} ms, "
                    f"host path {statistics.median(hosts):.2f} us")
    print(args.tag, f"{torch.cuda.get_device_name(0)}:", "; ".join(line),
          f"; the four shuffles of one layer, one call {layer:.4f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
