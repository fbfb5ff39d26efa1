#!/usr/bin/env python3
"""Where one training step of full-width Mistral-NeMo-12B goes on one GPU.

    python3 tools/train_step_profile.py [--layers 4] [--steps 3]

The model of ``chip_smoke.py`` phase 16 (full width, ``--layers`` of the
configuration's 40, bf16 weights, float32 AdamW moments, remat
``nothing``, the kv-head shuffle on ``cuda``; weights from a seed), batch
4 x seq 512 from the port's loader. The step is the one
``repro_torch.train.step.make_train_step`` builds, split at its seams:
the loss (forward), its gradients (backward, with the remat recompute
and the shuffle's VJPs), the gradient norm and the AdamW update, each
timed with CUDA events after warm-up (median of ``--steps``). Then
``torch.profiler`` records ``--steps`` whole steps: device time by
kernel, summed into matrix products (cuBLAS), K4a and the rest, and the
device's idle share of the wall clock. Beside them the least time the
products need at the card's peak rates (bf16 989 TFLOP/s, float32 67
TFLOP/s outside the tensor cores; the lm_head's products run in float32,
as the reference's ``preferred_element_type=float32`` asks).
"""
import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BF16_PEAK, F32_PEAK = 989e12, 67e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.launch.train import batch_to
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.step import init_opt, make_train_step
    from repro_torch.tree import tree_leaves, tree_unflatten

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("mistral-nemo-12b"),
                              n_periods=args.layers, head_shuffle="cuda")
    batch, seq = 4, 512
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = init_opt(cfg, params)
    step, opt_cfg = make_train_step(cfg)
    loader = ShardedLoader(DataConfig(n_samples_log2=16, seq_len=seq,
                                      vocab_size=cfg.vocab_size),
                           batch_size=batch)
    b = batch_to(next(loader), dev)
    for _ in range(2):                                  # warm
        params, opt, _ = step(params, opt, b)

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    parts = {k: [] for k in ("forward", "backward", "grad_norm", "update",
                             "step")}
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0 = ev()
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = M.loss_fn(cfg, tree_unflatten(params, leaves), b)
        e1 = ev()
        grads = torch.autograd.grad(loss, leaves)
        e2 = ev()
        torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        e3 = ev()
        params, opt = adamw_update(params, tree_unflatten(params, grads),
                                   opt, opt_cfg)
        e4 = ev()
        torch.cuda.synchronize()
        parts["step"].append((time.perf_counter() - t0) * 1e3)
        for k, (a, z) in zip(("forward", "backward", "grad_norm", "update"),
                             ((e0, e1), (e1, e2), (e2, e3), (e3, e4))):
            parts[k].append(a.elapsed_time(z))
        del leaves, loss, grads
    med = {k: statistics.median(v) for k, v in parts.items()}
    print(f"step split at its seams (CUDA events, median of {args.steps}; "
          f"step on the host clock after a sync): " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in med.items()))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]

    def dev_ms(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    total = sum(dev_ms(e) for e in kernels) / 1e3
    groups = {"matrix products (cuBLAS)": 0.0, "K4a (tile_wide/narrow)": 0.0,
              "other": 0.0}
    for e in kernels:
        name = e.key
        if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass",
                                   "Kernel2")):
            groups["matrix products (cuBLAS)"] += dev_ms(e) / 1e3
        elif "tile_wide" in name or "tile_narrow" in name:
            groups["K4a (tile_wide/narrow)"] += dev_ms(e) / 1e3
        else:
            groups["other"] += dev_ms(e) / 1e3
    n = args.steps
    print(f"profiler, {n} steps: wall {wall / n:.1f} ms a step, device "
          f"kernels {total / n:.1f} ms a step, idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    for k, v in groups.items():
        print(f"  {k}: {v / n:.1f} ms a step ({v / total * 100:.1f} %)")
    print("  top kernels (ms a step, calls a step):")
    for e in sorted(kernels, key=dev_ms, reverse=True)[:15]:
        print(f"    {dev_ms(e) / 1e3 / n:8.2f}  {e.count / n:6.1f}  "
              f"{e.key[:100]}")

    tokens = batch * seq
    e, v = cfg.d_model, cfg.vocab_size
    layer_params = sum(p.numel() for p in tree_leaves(params["stack"]))
    # forward 2, backward 4 and the remat recompute 2 FLOPs a weight a token
    bf16_flops = (8 if cfg.remat else 6) * tokens * layer_params
    head_flops = 6 * tokens * v * e
    print(f"least time of the products: bf16 layers "
          f"{bf16_flops / BF16_PEAK * 1e3:.1f} ms ({bf16_flops / 1e12:.1f} "
          f"TFLOP), float32 lm_head {head_flops / F32_PEAK * 1e3:.1f} ms "
          f"({head_flops / 1e12:.2f} TFLOP)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
