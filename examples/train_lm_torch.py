"""End-to-end driver on the PyTorch port: train an LM with the
BMMC-shuffled pipeline + checkpoint/restart, demonstrating fault
tolerance by stopping and resuming mid-run; the twin of
``examples/train_lm.py``.

Phase 1 trains to about 60 % of the steps with a checkpoint every 10;
phase 2, a "restarted job", resumes from the latest checkpoint
(parameters, optimizer state and the loader's position) through
``repro_torch.launch.train.main`` and trains to the end. The steps the
two phases share (from the checkpoint to where phase 1 stopped) must
give bit-equal losses: the resumed run continues where the stopped one
was.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]            (~1M, fast)
      PYTHONPATH=src python examples/train_lm_torch.py --profile 100m --steps 300
"""
import argparse
import math
import shutil
import tempfile

from repro_torch.kernels.bmmc_permute import reset_launch_counts
from repro_torch.launch.cli import check, device_of, print_launches
from repro_torch.launch.train import main as train_main

CKPT_EVERY = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="smoke")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = device_of(args.device, "train_lm_torch")
    common = ["--profile", args.profile, "--device", str(dev),
              "--ckpt-every", str(CKPT_EVERY)]

    ckpt_dir = tempfile.mkdtemp(prefix="bmmc_lm_ckpt_")
    reset_launch_counts()
    try:
        # phase 1: train to ~60% of steps, checkpointing along the way
        mid = max(args.steps * 6 // 10, 2)
        print(f"=== phase 1: steps 0..{mid} ===")
        first = train_main(common + ["--steps", str(mid),
                                     "--ckpt-dir", ckpt_dir])
        # phase 2: a "restarted job" resumes from the latest checkpoint —
        # including the BMMC shuffle state, so it consumes exactly the
        # unconsumed samples.
        print(f"=== phase 2: simulated restart, resume to {args.steps} ===")
        second = train_main(common + ["--steps", str(args.steps),
                                      "--ckpt-dir", ckpt_dir])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed_at = mid // CKPT_EVERY * CKPT_EVERY
    check(second.start == resumed_at,
          f"phase 2 started at step {second.start}, the latest checkpoint "
          f"is step {resumed_at}")
    shared = mid - resumed_at
    check(second.losses[:shared] == first.losses[resumed_at:],
          f"the resumed losses of steps {resumed_at}..{mid - 1} differ "
          f"from phase 1's")
    losses = second.losses
    check(all(math.isfinite(v) for v in first.losses + losses),
          "a loss is not finite")
    print(f"resumed at step {resumed_at}: {shared} shared steps bit-equal "
          f"to phase 1")
    print(f"final loss {losses[-1]:.4f}")
    launches = print_launches()
    return {"first": first.losses, "second": losses,
            "start": second.start, "launches": launches}


if __name__ == "__main__":
    main()
