"""End-to-end training entry point with checkpoint/restart.

The counterpart of :mod:`repro.launch.train`: trains a small-profile LM
with the BMMC-shuffled data pipeline, periodic integrity-checked
checkpoints, and automatic resume. Usage::

    python -m repro_torch.launch.train --steps 200 --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train --device cpu --profile smoke
    python -m repro_torch.launch.train --arch mistral-nemo-12b   # reduced
    python -m repro_torch.launch.train --profile 100m --steps 300

It runs on the card unless ``--device cpu`` asks for the CPU; a CUDA
device that is not there fails, it does not fall back. ``main`` builds
the configuration (a profile, or ``--arch`` reduced for a smoke run, as
the reference does), the loader and the model from ``--seed``, resumes
from the latest checkpoint in ``--ckpt-dir``, and runs :func:`train`, the
loop itself: a function of ``(cfg, params, opt_state, loader, args)``
that runs any configuration at any width.

As in the reference, each step computes the warmup-cosine scale and does
not pass it to the step, and ``--lr`` is parsed and not used: both
packages train at the optimizer's constant default rate, 3e-4 (ROADMAP
Queue 3, known reference behaviour).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List

import numpy as np
import torch

from ..checkpoint import ckpt
from ..configs import get_config, reduce_for_smoke
from ..configs.base import ArchConfig
from ..data.pipeline import DataConfig, ShardedLoader
from ..models import model as M
from ..optim.schedule import warmup_cosine
from ..train.step import init_opt, make_train_step
from ..tree import tree_leaves

PROFILES = {
    # name -> (d_model, layers, heads, d_ff, vocab)  [~params]
    "smoke": (128, 4, 4, 512, 1024),          # ~1M: CI-speed
    "20m": (384, 8, 6, 1536, 8192),           # ~20M
    "100m": (768, 12, 12, 3072, 32768),       # ~124M (GPT-2-small-like)
}


def profile_config(profile: str, base: ArchConfig = None) -> ArchConfig:
    d, l, h, f, v = PROFILES[profile]
    kw = dict(d_model=d, n_heads=h, n_kv_heads=max(h // 2, 1), d_ff=f,
              vocab_size=v, n_periods=l, head_dim=d // h,
              dtype=torch.float32, remat=False, kv_block=256)
    if base is None:
        return ArchConfig(name=f"lm-{profile}", family="dense",
                          pattern=("dense",), **kw)
    return dataclasses.replace(base, **kw)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (reduced); default: plain dense LM")
    ap.add_argument("--profile", default="smoke", choices=sorted(PROFILES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device the model trains on (default cuda; the "
                         "tests pass cpu)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainResult:
    """What one training run did."""
    start: int                 # the first step this run took
    losses: List[float]        # per step
    grad_norms: List[float]
    step_s: List[float]        # host seconds of each step, device synced
    save_s: List[float]        # seconds of each checkpoint write
    params: Any                # the trained parameters (updated in place)
    opt_state: Any


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_to(batch: dict, device) -> dict:
    """A loader batch (numpy int32) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
            for k, v in batch.items()}


def train(cfg: ArchConfig, params, opt_state, loader, args, *,
          start: int = 0) -> TrainResult:
    """Train steps ``start .. args.steps - 1`` on ``loader``'s batches
    with ``make_train_step(cfg)`` (the optimizer's default learning rate:
    as in the reference, ``--lr`` is parsed and not used), checkpointing
    every ``args.ckpt_every`` steps into ``args.ckpt_dir`` (if set). Runs
    on the device of ``params``, which it updates in place."""
    step_fn, _ = make_train_step(cfg)
    device = tree_leaves(params)[0].device
    losses, norms, step_s, save_s = [], [], [], []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = batch_to(next(loader), device)
        # computed and not used, as in the reference (ROADMAP Queue 3)
        warmup_cosine(step, warmup=20, total=args.steps)
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(device)
        step_s.append(time.perf_counter() - ts)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = args.batch * args.seq * (step - start + 1) / max(dt, 1e-9)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"grad_norm {norms[-1]:.3f}  "
                  f"tok/s {tok_s:,.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ts = time.perf_counter()
            path = ckpt.save(args.ckpt_dir, step + 1, (params, opt_state),
                             extra_state={"loader": loader.state(),
                                          "arch": cfg.name})
            save_s.append(time.perf_counter() - ts)
            print(f"checkpointed -> {path}", flush=True)
    if len(losses) >= 10:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss: {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return TrainResult(start, losses, norms, step_s, save_s, params,
                       opt_state)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    device = torch.device(args.device)
    if args.arch:
        cfg = reduce_for_smoke(get_config(args.arch))
    else:
        cfg = profile_config(args.profile)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"layers={cfg.n_layers}")

    dcfg = DataConfig(n_samples_log2=16, seq_len=args.seq,
                      vocab_size=cfg.vocab_size, seed=args.seed)
    loader = ShardedLoader(dcfg, batch_size=args.batch)

    params = M.init(cfg, torch.Generator(device=device).manual_seed(args.seed))
    opt_state = init_opt(cfg, params)
    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt_state), extra = ckpt.restore(
                args.ckpt_dir, last, (params, opt_state), device=device)
            loader.restore(extra["loader"])
            start = last
            print(f"resumed from step {last} "
                  f"(epoch={loader.epoch}, loader step={loader.step})")
    return train(cfg, params, opt_state, loader, args, start=start)


if __name__ == "__main__":
    main()
