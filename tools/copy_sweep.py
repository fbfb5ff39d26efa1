#!/usr/bin/env python3
"""Time variants of the copy kernel K1 against ``x.clone()`` on one GPU.

    python3 tools/copy_sweep.py                 # 2^30 int32
    python3 tools/copy_sweep.py --n 24 --rounds 2

The sweep behind K1's design (``src/repro_torch/kernels/csrc/copy.cu``;
PERF.md, section 6). It builds ``tools/copy_sweep.cu`` (``nvcc`` for
``sm_90a``, with the port's ``bulk_copy.cuh``) into ``build/sweep/`` and
times, on one aligned 2^n int32 array, each variant in turns with
``x.clone()`` and with K1 itself (``copy_blocks``):

* the register copy in 16-byte words, in one pass (one block a tile) at
  256 and 1024 threads a block and 1, 2, 4 or 8 words in flight a
  thread; with plain, streaming and non-allocating loads; and on
  persistent grids of a few blocks an SM (the same kernel, grid-strided);
* the bulk-copy ring (``bulk_copy.cuh``) at several chunk and stage
  sizes on a persistent grid of as many blocks an SM as the shared
  memory holds, and in one pass (one block for one or two chunks).

Each variant is checked bit for bit against ``x`` before it is timed.
Two readings, each taken in turns (``chip_smoke.py``'s ``in_turns``,
``--rounds`` times each way): one call (the median of ``--reps`` calls,
CUDA events around the call, ``cuda_ms``) and device time (the
profiler's record of 10 eager calls, ``copy_kernel_times.kernel_ms``).
The lines are sorted by device time, with each ratio to ``clone``'s.
Imports torch and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_name("copy_sweep.cu")

# label -> (threads, words in flight a thread, hint, blocks an SM or None
# for one block a tile)
WORDS = {f"words 1 pass, {t} threads, {f} in flight, streaming":
         (t, f, 1, None) for t in (1024, 256) for f in (1, 2, 4, 8)}
WORDS.update({
    "words 1 pass, 1024 threads, 1 in flight, plain": (1024, 1, 0, None),
    "words 1 pass, 1024 threads, 1 in flight, nc no_allocate": (1024, 1, 2,
                                                                 None),
    "words persistent 2/SM, 1024 threads, 1 in flight": (1024, 1, 1, 2),
    "words persistent 4/SM, 256 threads, 4 in flight": (256, 4, 1, 4),
    "words persistent 8/SM, 256 threads, 4 in flight": (256, 4, 1, 8),
})
# label -> (chunk bytes, stages, chunks a block or None for a persistent
# grid of as many blocks an SM as the shared memory holds)
BULK = {f"bulk ring {c // 1024} KiB x {s}, persistent": (c, s, None)
        for c, s in ((32768, 4), (32768, 2), (16384, 4), (8192, 4))}
BULK.update({f"bulk 1 pass, {c // 1024} KiB x {k} a block": (c, 2, k)
             for c, k in ((4096, 1), (8192, 1), (8192, 2), (32768, 1))})
SM_SMEM = 228 * 1024      # shared memory of one multiprocessor (H100)
CTA_SMEM = 1024 + 128     # a block's reserve and barriers beside its ring


def build(out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as B
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "copy_sweep.so"
    cmd = [B.nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(lib),
           str(SRC)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"copy_sweep: nvcc failed\n{done.stdout}"
                         f"{done.stderr}")
    so = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.sweep_words.argtypes = [P, P, L, I, I, I, I, P]
    so.sweep_bulk.argtypes = [P, P, L, I, I, I, P]
    so.sweep_words.restype = so.sweep_bulk.restype = I
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30, help="2^n int32 elements")
    ap.add_argument("--rounds", type=int, default=3,
                    help="turns each way (A, B, ..., B, A)")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls a turn (the median is the turn's reading)")
    ap.add_argument("--build-dir", default=str(ROOT / "build" / "sweep"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import cuda_ms, in_turns
    from copy_kernel_times import kernel_ms
    import torch
    if not torch.cuda.is_available():
        print("copy_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bmmc_permute as pk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    so = build(Path(args.build_dir))
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.randint(-2**31, 2**31 - 1, (1 << args.n,), device=dev,
                      dtype=torch.int32)
    nbytes = x.numel() * 4

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def words(threads, f, hint, per_sm):
        n16 = nbytes // 16
        grid = (n16 // (threads * f) if per_sm is None
                else min(n_sm * per_sm, n16 // (threads * f)))

        def run():
            out = torch.empty_like(x)
            rc = so.sweep_words(x.data_ptr(), out.data_ptr(), n16, threads,
                                f, hint, grid, stream())
            if rc:
                raise SystemExit(f"copy_sweep: sweep_words error {rc}")
            return out
        return run

    def bulk(chunk, stages, per_block):
        n_chunks = -(-nbytes // chunk)
        if per_block is None:
            per_sm = SM_SMEM // (chunk * stages + CTA_SMEM)
            grid = min(n_sm * per_sm, n_chunks)
        else:
            grid = -(-n_chunks // per_block)

        def run():
            out = torch.empty_like(x)
            rc = so.sweep_bulk(x.data_ptr(), out.data_ptr(), nbytes, chunk,
                               stages, grid, stream())
            if rc:
                raise SystemExit(f"copy_sweep: sweep_bulk error {rc}")
            return out
        return run

    fns = {"clone": lambda: x.clone(), "K1 (copy_blocks)":
           lambda: pk.copy_blocks(x)}
    fns.update({k: words(*v) for k, v in WORDS.items()})
    fns.update({k: bulk(*v) for k, v in BULK.items()})
    for k, fn in fns.items():
        y = fn()
        torch.cuda.synchronize()
        if not torch.equal(y, x):
            print(f"2^{args.n} int32 {k}: WRONG", flush=True)
            return 1
        del y
    one = in_turns(fns, lambda fn: cuda_ms(torch, fn, args.reps),
                   args.rounds)
    dev = in_turns(fns, lambda fn: kernel_ms(torch, fn), args.rounds)
    med1 = {k: statistics.median(v) for k, v in one.items()}
    med = {k: statistics.median(v) for k, v in dev.items()}
    print(f"2^{args.n} int32, ms: device median (min-max) / clone's; "
          f"one call median / clone's", flush=True)
    for k in sorted(med, key=med.get):
        print(f"{k:<56} {med[k]:.4f} ({min(dev[k]):.4f}-{max(dev[k]):.4f})"
              f" {med[k] / med['clone']:.4f}; {med1[k]:.4f} "
              f"{med1[k] / med1['clone']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
