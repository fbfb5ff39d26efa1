#!/usr/bin/env python3
"""Where a decode step and a prefill of phi3.5-moe go with and without a
device mesh, on one GPU.

    python3 tools/mesh_profile.py [--layers 16] [--steps 8]

The model of ``chip_smoke.py`` phase 18: ``phi3.5-moe-42b-a6.6b`` at full
width, cut to ``--layers`` of its 32 layers, bf16 weights from a seed,
the kv-head shuffle on ``cuda``, batch 4, prompt 512. With a (1, 1) mesh
of one single-rank NCCL group every MoE layer runs the all-to-all branch
(``repro_torch.models.moe_a2a``); with none, the capacity branch. For
each: the host clock of a prefill and of ``--steps`` warm decode steps
(after a sync), then ``torch.profiler`` over the same steps: host time
and calls by op (self CPU time, the ops the host spends most on), device
time by kernel (NCCL's, the rest), and the device's idle share of the
wall clock.
"""
import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import model as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              n_periods=args.layers, head_shuffle="cuda")
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    sargs = S.parse_args(["--arch", cfg.name, "--batch", "4",
                          "--prompt-len", "512"])
    prompts = S.make_prompts(cfg, sargs, dev)
    p = prompts.shape[1]
    mesh = make_dev_mesh(1, 1, device="cuda")
    try:
        for label, m in (("mesh", mesh), ("none", None),
                         ("mesh", mesh), ("none", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, caches = M.prefill(cfg, params, {"tokens": prompts},
                                           mesh=m)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            caches = M.grow_caches(caches, p, p + 2 * args.steps + 1)

            def step(i, lg, caches=caches, m=m):
                tok = torch.argmax(lg[:, -1], -1)[:, None]
                with torch.no_grad():
                    return M.decode_step(cfg, params, caches, tok, p + i,
                                         mesh=m)[0]
            lg = step(0, logits)
            times = []
            for i in range(1, args.steps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg = step(i, lg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                for i in range(args.steps + 1, 2 * args.steps + 1):
                    lg = step(i, lg)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - w0) * 1e6
            ev = prof.key_averages()
            dev_us = {e.key: e.self_device_time_total for e in ev
                      if e.self_device_time_total > 0}
            busy = sum(dev_us.values())
            nccl = sum(v for k, v in dev_us.items() if "nccl" in k.lower())
            cpu = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:12]
            n = args.steps
            print(f"== {label}: prefill {pre_ms:.1f} ms; decode "
                  f"{statistics.median(times):.2f} ms/token (median of {n}); "
                  f"profiled {n} steps: wall {wall_us / n / 1e3:.2f} ms a "
                  f"step, device busy {busy / n / 1e3:.2f} ms (idle share "
                  f"{1 - busy / wall_us:.3f}), NCCL kernels "
                  f"{nccl / n / 1e3:.3f} ms a step; {smi}")
            print(f"   ops a step: "
                  f"{sum(e.count for e in ev if e.key.startswith('aten::')) / n:.0f}"
                  f" aten calls; host time by op (self CPU ms a step, calls "
                  f"a step):")
            for e in cpu:
                print(f"     {e.key[:60]:60s} {e.self_cpu_time_total / n / 1e3:8.3f}"
                      f" {e.count / n:7.1f}")
            del caches, logits, lg
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
