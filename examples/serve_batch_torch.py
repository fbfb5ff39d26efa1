"""Serving example on the PyTorch port: batched prefill + KV-cache greedy
decode, with a durable-store warm-start demo (DESIGN.md §15); the twin
of ``examples/serve_batch.py``.

Run::

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu] [--arch <id>]

Runs the port's serving driver (``repro_torch.launch.serve.main``) twice
against the same on-disk plan store with the compiled BMMC kv-head
shuffle enabled, dropping every in-process cache in between
(``repro_torch.combinators.execute.clear_caches``). The reference passes
``--head-shuffle pallas``, its tiled kernel; here that is
``--head-shuffle cuda``, the tiled-permutation kernel K4a on a card (its
plain version on the CPU). ``--validate`` runs the guarded K4a.

* boot 1 (**cold**) — empty store: the first request plans its
  permutations from scratch and writes each plan back to disk.
* boot 2 (**disk-warm**) — same store, fresh caches: the first request
  loads every plan from disk (each one re-audited through guard
  ring 1), compiling zero plans.

Prints first-request (prefill) latency for both boots plus the
per-request ``store.hit/miss/quarantined`` deltas the driver reports
next to its guard resolution lines, and the kernel launches of each
boot. Pass ``--store PATH`` to keep the store (default: a throwaway temp
dir), or any other ``repro_torch.launch.serve`` flag to forward it.
Exits 1 unless the disk-warm boot was served wholly from the store.
"""
import argparse
import shutil
import sys
import tempfile

from repro_torch import store
from repro_torch.combinators.execute import clear_caches
from repro_torch.kernels.bmmc_permute import reset_launch_counts
from repro_torch.launch.cli import device_of, print_launches, timed_ms
from repro_torch.launch.serve import main as serve_main


def _boot(label, root, dev, extra):
    """One fresh-process-equivalent serve run: drop the in-process plan
    caches so the only warm state is the on-disk store."""
    clear_caches()
    store.reset_stats()
    reset_launch_counts()
    print(f"--- boot: {label} ---")
    _, ms = timed_ms(lambda: serve_main(
        ["--store", root, "--head-shuffle", "cuda", "--kv-heads", "4",
         "--validate", "--device", str(dev)] + extra), dev)
    s = store.stats()
    print(f"[{label}] run={ms:.1f} ms store: hits={s['hit']} "
          f"misses={s['miss']} plans_built={s['plan_built']} "
          f"quarantined={s['quarantined']}")
    s["launches"] = print_launches(f"[{label}]")
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="plan store root (default: throwaway temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    args, extra = ap.parse_known_args(argv)
    dev = device_of(args.device, "serve_batch_torch")
    if not extra:
        extra = ["--arch", "mistral-nemo-12b", "--batch", "4",
                 "--tokens", "8"]
    root = args.store or tempfile.mkdtemp(prefix="repro-serve-store-")
    try:
        cold = _boot("cold (empty store)", root, dev, extra)
        warm = _boot("disk-warm (fresh process state)", root, dev, extra)

        print("--- warm-start summary ---")
        print(f"cold boot:      {cold['plan_built']} plan(s) compiled, "
              f"{cold['write']} written to {root}")
        print(f"disk-warm boot: {warm['plan_built']} plan(s) compiled, "
              f"{warm['hit']} served from disk "
              f"({store.active().entry_count()} entries)")
    finally:
        if args.store is None:
            shutil.rmtree(root, ignore_errors=True)
    if warm["plan_built"] or warm["miss"]:
        print("WARN: disk-warm boot was not 100% store-served")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
