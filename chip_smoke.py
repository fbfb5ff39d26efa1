#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run, one card
    python3 chip_smoke.py --n 22 --n-sort 20 --n-fft 18   # a quick check

Phases (each fails loudly; a failure exits non-zero and prints no result):

1. environment: Python, torch and CUDA versions, ``nvcc --version`` and
   the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel compiled from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), with seconds and ptxas usage;
3. kernel vs plain: each permutation kernel (copy, block, lane, tile)
   held bit for bit against its plain PyTorch version on the card, at a
   small size (int32, bfloat16, float32 with a d = 8 tail, a batch of 3,
   a ragged copy, uint8 views at byte offsets 0-15) and at 2^n int32;
   the 2^n case is timed with CUDA events in turns with one PyTorch
   library call, and beside the plain version; the copy also at 2^n - 1
   int32 and on a view at a 4-byte offset, each in turns with
   ``x.clone()``, and through its bulk-copy ring (on request; ragged and
   at 2^n, bit for bit); every copy prints the path its launch counted
   (words or bulk);
4. main path: ``repro_torch.kernels.ops.bmmc_permute`` on 2^n int32 for
   one BMMC of each dispatch case (bit-reverse, random BPC, random BMMC,
   block class, lane class, mixed complement), each bit-equal to the
   device-side plain gather, with host planning seconds, the median
   CUDA-event time, effective GB/s, the ratio to the copy kernel, the
   byte bound and ``torch.index_select`` on a precomputed index;
5. tile-size sweep: the tiled cases at t = 5, 6 and 7, each beside the
   copy kernel (the record behind ``ops.choose_tile``'s t = 6 for int32);
6. K4b vs plain: the fused tiled pass (``tile_fused``) bit for bit
   against its plain version on sort clusters of 1, 2 and 3
   compare-exchange epilogues (int32, float32 and bfloat16 with NaNs and
   signed zeros, a d = 3 tail, a batch of 3) and on an FFT cluster of
   butterflies (planar float32) at a small size and at the FFT's 2^22
   points; hand-built clusters with map epilogues (a map between two
   compares, at a phase boundary, one that makes NaNs mid-phase, a
   bfloat16 chain of three ops, bfloat16 tanh, exp, sigmoid and a division
   by a number, an int32 wrap, B = 3 with d = 3, float32 tanh and log, on
   continuous inputs: bit for bit), each timed (one call, device);
   then the largest cluster of the 2^24 sort, bit for bit, timed
   beside its plain version, the same pass without epilogues, the copy
   kernel and the torch composite of the cluster;
7. combinator path: ``repro_torch.combinators.sort`` of 2^24 int32 keys
   (bit-equal to ``torch.sort``) and ``fft_planar`` of 2^22 points
   (within ``FFT_REL_TOL`` of ``torch.fft.fft`` in float64), each with
   its cold host planning seconds, ``program_cost`` round trips equal to
   the cold call's counted ``model.round_trips``, no fused fallback, and
   the CUDA-graph call, the eager per-stage call and the library call
   timed; the descending sort ``emap(not) >> sort >> emap(not)`` of the
   same keys (its maps inside K4b; bit-equal to ``torch.sort(...,
   descending=True)``, round trips equal to ``program_cost``, no fused
   fallback), timed beside the Map-free sort and the library;
   ``fft`` of the same points as complex64, bit-equal to the
   planar FFT through the same kernels;
8. launch counts: every permutation kernel launched on the main path
   (phase 4) and ``tile_fused`` on the combinator path (phase 7);
9. K5 vs plain: the gradient kernel (``tile_bwd``) bit for bit against
   its plain version on sort clusters of 1, 2 and 3 compare epilogues
   (float32 with ties, NaNs and signed zeros, bfloat16 with canonical
   NaNs, a d = 3 tail, a batch of 3), on the FFT's butterfly cluster at
   2^n_fft points and on the largest cluster of the 2^n_sort float32 sort
   with keys drawn from 2^16 values (ties); phase 6's map clusters
   (gradients bit for bit); the last
   timed beside its byte bound, its plain version and the torch composite
   (autograd's backward through the cluster's stages as torch ops);
10. gradients on the main path, ``loss = (w * f(x)).sum()``: the sort of
   2^n_sort distinct float32 keys (equal to scattering ``w`` to the
   sorting permutation, bit for bit), the gradient kernel route against
   the collapsed route at 2^n_ties keys with ties (bit for bit), the FFT
   of 2^n_fft planar points (within ``FFT_REL_TOL`` of float64
   ``torch.fft.fft`` under autograd) and a permutation chain at 2^n_perm
   float32 (equal to the inverse program applied to ``w``, bit for bit);
   ``emap(tanh) >> sort`` of 2^n_sort float32 keys (its map inside K4b
   and K5; within MAP_GRAD_TOL of ``torch.sort(torch.tanh(x))`` under
   autograd, tied keys by their sums); each cold backward counts
   ``model.vjp_round_trips`` equal to
   ``vjp_round_trips(n, t)``, K5 launches equal to the compute clusters
   and no fused fallback; forward and forward + backward timed beside the
   library call under autograd, and the peak device memory; then
   ``tile_bwd``'s launches on this path, and one JSON line describing
   every kernel (``ms`` the median time of one call, CUDA events around
   the Python call; ``device_ms`` for K4b and K5 the device time of one
   call, 10 calls captured in one CUDA graph and replayed, null for the
   others);
11. guarded main path: phase 4's six BMMCs and the 2^n_sort int32 sort
   with ``guard.enable()``, each bit-equal to its unguarded call, with no
   trap, no fallback and the breaker board closed, counting the launches
   of the guarded variants (``block_guarded``, ``lane_guarded``,
   ``tile_guarded``, ``tile_fused_guarded``; no unguarded kernel runs
   under the guard); ring 1's host seconds (validation with
   fingerprints) per 2^n plan; each call guarded and unguarded in turns;
   each guarded variant bit for bit against its unguarded kernel and its
   guarded plain version, timed in turns with the unguarded kernel (one
   call and device time);
12. traps on the card at 2^24: each table of each guarded variant
   poisoned on the card (2^30 and -1) sets bit 1 as the guarded plain
   version does, and the next unguarded launch succeeds; guarded
   ``bmmc_permute`` with a poisoned plan (host table, then the card's
   copy only) and a guarded sort with a poisoned K4b table fall back to
   ``ref`` and equal the oracle; a poisoned ref table raises
   ``GuardTrap`` and the process keeps launching;
13. store warm start: a fresh process (this script with
   ``--store-child``) populates a plan store in a temporary root with the
   six 2^n BMMCs, the 2^n_sort sort and its float32 gradient; a second
   replays them with zero plans built, only hits, and outputs equal to
   the first's (64-bit checksums on the card); first-call latency cold,
   disk-warm and warm, and the store's bytes; then the disk-fault
   matrix (every case caught);
14. ring 3 and the soak: ``guard.inject.run_fault_matrix("cuda")`` at
   2^14 (every kind caught, none silently wrong) and
   ``resilience.chaos.run_matrix()`` on the card (every SLO met);
15. last line: ``{"ok": true, "device": {...}}``.

It imports only torch, numpy and ``repro_torch``; the kernels build into
``build/kernels`` of this checkout.
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

KERNEL_INFO = {   # name -> (source, the TPU kernel it replaces)
    "copy": ("src/repro_torch/kernels/csrc/copy.cu",
             "src/repro/kernels/bmmc_permute.py:859"),
    "block": ("src/repro_torch/kernels/csrc/block_permute.cu",
              "src/repro/kernels/bmmc_permute.py:724"),
    "lane": ("src/repro_torch/kernels/csrc/lane_permute.cu",
             "src/repro/kernels/bmmc_permute.py:811"),
    "tile": ("src/repro_torch/kernels/csrc/tile_permute.cu",
             "src/repro/kernels/bmmc_permute.py:72"),
    "tile_fused": ("src/repro_torch/kernels/csrc/tile_fused.cu",
                   "src/repro/kernels/bmmc_permute.py:181"),
    "tile_bwd": ("src/repro_torch/kernels/csrc/tile_bwd.cu",
                 "src/repro/kernels/bmmc_permute.py:265"),
    # the guarded variants (ring 2): instantiations of K2, K3, K4a, K4b
    "block_guarded": ("src/repro_torch/kernels/csrc/block_permute.cu",
                      "src/repro/kernels/bmmc_permute.py:724"),
    "lane_guarded": ("src/repro_torch/kernels/csrc/lane_permute.cu",
                     "src/repro/kernels/bmmc_permute.py:811"),
    "tile_guarded": ("src/repro_torch/kernels/csrc/tile_permute.cu",
                     "src/repro/kernels/bmmc_permute.py:72"),
    "tile_fused_guarded": ("src/repro_torch/kernels/csrc/tile_fused.cu",
                           "src/repro/kernels/bmmc_permute.py:181"),
}
PERM_KERNELS = ("copy", "block", "lane", "tile")   # the bmmc_permute path

N_SMALL = 14              # log2 elements of the small kernel-vs-plain cases
REPS = 10                 # timed runs per measurement (the median is kept)
TILE_SWEEP = (5, 6, 7)    # tile sizes of the sweep phase
N_SORT = 24               # log2 keys of the combinator path's sort (64 MiB)
N_FFT = 22                # log2 points of its FFT (32 MiB planar float32)
N_TIES = 20               # log2 keys of the K5-route vs collapsed-route check
N_PERM = 26               # log2 elements of the gradient's permutation chain
# Norm-wise relative error of the float32 FFT against float64: radix-2
# float32 rounding grows like eps * log2(N) (eps = 6e-8, 22 stages), so
# 1e-5 leaves about an order of magnitude of room.
FFT_REL_TOL = 1e-5

# Peak HBM bandwidth by card (NVIDIA data sheets); the byte bound of a
# kernel is the bytes it must move over this rate.
PEAK_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H100", 3.35e12), ("H200", 4.8e12))


def say(*a):
    print(*a, flush=True)


def check(ok, what="") -> None:
    """Fail the run when a phase does not hold (exit code 1, no result)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def peak_bw(name: str) -> float:
    for key, bw in PEAK_BYTES_PER_S:
        if key in name:
            return bw
    raise SystemExit(f"no peak bandwidth known for {name!r}")


def run_cmd(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def in_turns(fns: dict, timer, rounds: int = 2) -> dict:
    """Each function's readings of ``timer(fn)`` (milliseconds), taken in
    turns: the labels in order, then reversed (A, B, B, A, ...), ``rounds``
    times each way, so that a kernel and its library call see the same
    clocks."""
    got = {k: [] for k in fns}
    order = list(fns)
    for r in range(2 * rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(timer(fns[k]))
    return got


def bits(torch, t):
    """An integer view of ``t`` for bitwise comparison (NaN payloads and
    -0.0 compare by their bits)."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.element_size()])


def max_abs_err(torch, got, want) -> float:
    """Largest absolute difference of the two tensors' bit patterns as
    integers: 0 exactly when they are bitwise equal."""
    check(got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype))
    a, b = bits(torch, got), bits(torch, want)
    if torch.equal(a, b):
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def make_cases(n: int, t: int):
    """One BMMC of each dispatch case at size 2^n and tile t."""
    from repro_torch.core.bmmc import Bmmc
    rng = random.Random(2306)
    ident = tuple(1 << i for i in range(n))
    k = min(11, n - 2)                      # block class: low k bits fixed
    while True:
        sub = Bmmc.random(n - k, rng)
        blk = Bmmc(ident[:k] + tuple(r << k for r in sub.rows), sub.c << k)
        if blk.bmmc_class(t) == "block":
            break
    while True:
        sub = Bmmc.random(t, rng)
        lane = Bmmc(tuple(sub.rows) + ident[t:], sub.c)
        if lane.bmmc_class(t) == "lane":
            break
    mixed = Bmmc.xor_shift(n, (rng.randrange(1, 1 << t))
                           | (rng.randrange(1, 1 << (n - t)) << t))
    return [("bit-reverse", Bmmc.bit_reverse(n), "tiled"),
            ("random-bpc", Bmmc.random_bpc(n, rng), "tiled"),
            ("random-bmmc", Bmmc.random(n, rng), "general"),
            ("block-class", blk, "block"),
            ("lane-class", lane, "lane"),
            ("mixed-complement", mixed, "tiled")]


def clocks() -> str:
    """SM clock, power draw and temperature, to read beside a timing."""
    return run_cmd(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                    "temperature.gpu", "--format=csv,noheader"])


def phase_env(torch):
    say("== phase 1: environment ==")
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    say(run_cmd([build.nvcc(), "--version"]).splitlines()[-1])
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()
    say(f"devices: {torch.cuda.device_count()}  "
        f"torch name: {torch.cuda.get_device_name(0)}")
    return smi[0]


def ptxas_usage(log: str) -> list:
    """(kernel, "N registers, S bytes spill stores, L bytes spill loads")
    of each kernel in an ``nvcc -Xptxas -v`` log, names shortened to the
    template's arguments."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
            spill = ""
        elif "spill stores" in ln:
            parts = [p.strip() for p in ln.split(",")]
            spill = ", ".join(p for p in parts if "spill" in p)
        elif "Used" in ln and name is not None:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append((name[:60], f"{regs}, {spill or 'no spill'}"))
    return out


def phase_build():
    say("== phase 2: build ==")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build_all()
    say(f"built {sorted(log)} in {time.perf_counter() - t0:.2f} s "
        f"(build dir {build.build_dir()})")
    for name, rec in sorted(log.items()):
        say(f"  {name}: {rec['seconds']:.2f} s")
        for kern, used in ptxas_usage(rec["ptxas"]):
            say(f"    {kern}: {used}")
    for name in build.KERNELS:
        build.load(name)


def phase_kernels(torch, n_small: int, n: int, reps: int, bw: float):
    """Each kernel against its plain version; returns per-kernel records
    of the 2^n int32 case."""
    say("== phase 3: kernel vs plain ==")
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def payload(shape, dtype):
        raw = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                            device=dev, dtype=torch.int64)
        if dtype == torch.int32:
            return raw.to(torch.int32)
        if dtype == torch.bfloat16:
            return raw.to(torch.int16).view(torch.bfloat16)
        return raw.to(torch.int32).view(torch.float32)

    def plans(nn: int, t: int):
        cases = {name: b for name, b, _ in make_cases(nn, t)}
        got = {"block": ops.class_plan(cases["block-class"], t),
               "lane": ops.class_plan(cases["lane-class"], t),
               "tile": ops.class_plan(cases["bit-reverse"], t)}
        check([got[k][0] for k in ("block", "lane", "tile")] == [
            "block", "lane", "tiled"], {k: v[0] for k, v in got.items()})
        return {"block": got["block"][1], "lane": got["lane"][1],
                "tile": got["tile"][1][0]}

    pairs = {  # kernel -> (wrapper, plain version)
        "copy": (lambda x, plan, batched=False: K.copy_blocks(x),
                 lambda x, plan, batched=False: K.copy_plain(x)),
        "block": (K.block_permute, K.block_permute_plain),
        "lane": (K.lane_permute, K.lane_permute_plain),
        "tile": (K.tiled_permute, K.tiled_permute_plain)}

    def run(name, x, plan, batched=False):
        fn, plain = pairs[name]
        return fn(x, plan, batched=batched), plain(x, plan, batched=batched)

    worst = {k: 0.0 for k in PERM_KERNELS}
    configs = [("int32", torch.int32, (1 << n_small,), False),
               ("bfloat16", torch.bfloat16, (1 << n_small,), False),
               ("float32 d=8", torch.float32, (1 << n_small, 8), False),
               ("int32 B=3", torch.int32, (3, 1 << n_small), True)]
    for label, dtype, shape, batched in configs:
        d = shape[-1] if len(shape) == 2 and not batched else 1
        t = ops.choose_tile(n_small, torch.tensor([], dtype=dtype)
                            .element_size(), d)
        pl = plans(n_small, t)
        x = payload(shape, dtype)
        for name in PERM_KERNELS:
            got, want = run(name, x, pl.get(name), batched)
            err = max_abs_err(torch, got, want)
            check(err == 0.0, (name, label, err))
            worst[name] = max(worst[name], err)
        say(f"  n={n_small} {label} t={t}: copy, block, lane, tile bit-equal")

    def copy_path(v, path=None):
        """K1 on ``v`` (on ``path`` if one is asked for) held bit for bit
        against its plain version; the path it took, read from the path
        counts of its one launch."""
        before = K.launch_counts()
        got = K._copy_cuda(v, path) if path else K.copy_blocks(v)
        want = K.copy_plain(v)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, ("copy", tuple(v.shape), v.dtype, err))
        worst["copy"] = max(worst["copy"], err)
        after = K.launch_counts()
        took = [p for p in ("bulk", "words")
                if after[f"copy_{p}"] > before[f"copy_{p}"]]
        check(len(took) == 1 and after["copy"] == before["copy"] + 1, took)
        return took[0]

    ragged = payload((3 * 2048 + 37,), torch.int32)
    path = copy_path(ragged)
    say(f"  copy of {ragged.numel()} elements (ragged edge of "
        f"{K.copy_pad_elems(ragged.numel())} padding elements) bit-equal, "
        f"{path} path")
    check(copy_path(ragged, path="bulk") == "bulk", "bulk ring")
    base = ragged.view(torch.uint8)
    paths = {copy_path(base[off:off + 4 * 6000]) for off in range(16)}
    check(paths == {"words"}, paths)
    say(f"  copy of uint8 views at byte offsets 0-15 bit-equal, words "
        f"path; the bulk ring on the ragged copy bit-equal")

    t = ops.choose_tile(n, 4)
    pl = plans(n, t)
    x = payload((1 << n,), torch.int32)
    nbytes = x.numel() * 4
    records = {}
    timed = (lambda fn: cuda_ms(torch, fn, reps))
    case_of = {"block": "block-class", "lane": "lane-class",
               "tile": "bit-reverse", "copy": "identity"}
    for name in PERM_KERNELS:
        plan = pl.get(name)
        if name == "copy":
            path = copy_path(x)
        else:
            got, want = run(name, x, plan)
            err = max_abs_err(torch, got, want)
            check(err == 0.0, (name, n, err))
            worst[name] = max(worst[name], err)
            del got, want
        fn, pfn = pairs[name]
        kern, plain = (lambda: fn(x, plan)), (lambda: pfn(x, plan))
        if name == "copy":
            tab_bytes = 0
            lib = lambda: x.clone()
        else:
            tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plan, dev))
            idx = ref.bmmc_src_index(plan.bmmc, dev)
            lib = lambda: torch.index_select(x, 0, idx)
        turns = in_turns({"kernel": kern, "library": lib}, timed)
        ms, lib_ms = (statistics.median(turns[k]) for k in ("kernel",
                                                            "library"))
        plain_ms = cuda_ms(torch, plain, max(3, reps // 3), warmup=1)
        idx = None
        bound_ms = (2 * nbytes + tab_bytes) / bw * 1e3
        records[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "max_abs_err": worst[name]}
        say(f"  n={n} int32 {name} ({case_of[name]}, t={t}"
            f"{f', {path} path' if name == 'copy' else ''}): bit-equal; "
            f"kernel {ms:.3f} ms ({2 * nbytes / ms / 1e6:.1f} GB/s), "
            f"library {lib_ms:.3f} ms (in turns), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms")
        torch.cuda.empty_cache()
    for label, v in ((f"2^{n} - 1 int32", x[:-1]),
                     (f"2^{n} - 1 int32 at a 4-byte offset", x[1:])):
        path = copy_path(v)
        turns = in_turns({"kernel": lambda: K.copy_blocks(v),
                          "library": lambda: v.clone()}, timed)
        say(f"  {label} copy ({path} path): bit-equal; kernel "
            f"{statistics.median(turns['kernel']):.3f} ms, x.clone() "
            f"{statistics.median(turns['library']):.3f} ms (in turns), "
            f"bound {2 * v.numel() * 4 / bw * 1e3:.3f} ms")
        torch.cuda.empty_cache()
    # K1's alternative, the bulk-copy ring (bulk_copy.cuh), run on request
    check(copy_path(x, path="bulk") == "bulk", "bulk ring")
    say(f"  n={n} int32 copy through the bulk ring: bit-equal")
    torch.cuda.empty_cache()
    return records


def phase_main(torch, n: int, reps: int, bw: float):
    """The main path at 2^n int32; returns the launch counts of the run.
    Each case is timed right after the copy kernel, whose time its copy
    ratio divides."""
    say("== phase 4: main path, bmmc_permute on 2^%d int32 ==" % n)
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    nbytes = x.numel() * 4
    t = ops.choose_tile(n, 4)
    ops._class_plan_cached.cache_clear()
    ops._plans_cached.cache_clear()
    K.clear_device_tables()
    cases = make_cases(n, t)
    plan_s = {}
    for name, b, want_kernel in cases:
        t0 = time.perf_counter()
        kernel, _ = ops.class_plan(b, t)
        plan_s[name] = time.perf_counter() - t0
        check(kernel == want_kernel, (name, kernel, want_kernel))

    say(f"  clocks, power, temperature: {clocks()}")
    # the counted run: the copy yardstick once, then every case once,
    # each output checked against the plain gather (which launches no
    # kernel of the port) before the next
    K.reset_launch_counts()
    got = K.copy_blocks(x)
    check(max_abs_err(torch, got, x) == 0.0, "copy")
    for name, b, _ in cases:
        got = ops.bmmc_permute(x, b)
        want = ref.bmmc_ref_device(x, b)
        check(got.shape == x.shape and got.dtype == x.dtype, name)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, (name, err))
        del got, want
    torch.cuda.synchronize()
    counts = K.launch_counts()
    say(f"  launch counts of the main-path run: {counts}")

    for name, b, kernel in cases:
        payload = ops.class_plan(b, t)[1]
        pls = payload if isinstance(payload, tuple) else (payload,)
        tab_bytes = sum(a.numel() * 4 for p in pls
                        for a in K.device_tables(p, dev))
        copy_ms = cuda_ms(torch, lambda: K.copy_blocks(x), reps)
        ms = cuda_ms(torch, lambda: ops.bmmc_permute(x, b), reps)
        idx = ref.bmmc_src_index(b, dev)
        lib_ms = cuda_ms(torch, lambda: torch.index_select(x, 0, idx), reps)
        idx = None
        bound_ms = (2 * nbytes * len(pls) + tab_bytes) / bw * 1e3
        say(f"  {name:17s} kernel={kernel:8s} plan {plan_s[name]:.3f} s  "
            f"{ms:.3f} ms  {2 * nbytes / ms / 1e6:.1f} GB/s  copy "
            f"{copy_ms:.3f} ms  copy/this {copy_ms / ms:.3f}  "
            f"bound {bound_ms:.3f} ms  "
            f"index_select {lib_ms:.3f} ms  bit-equal")
        say(f"  clocks, power, temperature: {clocks()}")
    torch.cuda.empty_cache()
    return counts


def phase_sweep(torch, n: int, reps: int):
    """The tiled cases of the main path at the tile sizes around the one
    ``ops.choose_tile`` picks, each beside the copy kernel: the record
    behind that choice."""
    say(f"== phase 5: tile-size sweep on 2^{n} int32 ==")
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), device=dev,
                      dtype=torch.int32)
    for t in TILE_SWEEP:
        copy_ms = cuda_ms(torch, lambda: K.copy_blocks(x), reps)
        say(f"  copy {copy_ms:.3f} ms")
        for name, b, _ in make_cases(n, ops.choose_tile(n, 4)):
            t0 = time.perf_counter()
            kernel, payload = ops.class_plan(b, t)
            plan_s = time.perf_counter() - t0
            if kernel not in ("tiled", "general"):
                continue
            (plan,) = payload
            ms = cuda_ms(torch, lambda: ops.bmmc_permute(x, b, t=t), reps)
            say(f"  t={t} {name:17s} rows/tile {plan.rows_per_tile:3d} "
                f"plan {plan_s:.3f} s  {ms:.3f} ms  "
                f"{2 * x.numel() * 4 / ms / 1e6:.1f} GB/s  "
                f"copy/this {copy_ms / ms:.3f}")
        ops._class_plan_cached.cache_clear()
        ops._plans_cached.cache_clear()
        K.clear_device_tables()


def fused_cases(n: int, t: int, expr_name: str):
    """The fused clusters (FusedStages with computes) of the sort or FFT
    program at 2^n and tile t, as the port's planner clusters them."""
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators.fft import fft_expr
    from repro_torch.combinators.sort import sort_expr
    expr = {"sort": sort_expr, "fft": fft_expr}[expr_name](n)
    prog = compile_expr(expr).clustered_program(n, t)
    return [s for s in prog if isinstance(s, FusedStage) and s.computes]


def fused_call(K, ex, fs, t, x, batched=False, plain=False):
    """One cluster through K4b as the executor runs it (its tables kept on
    the card), or through the plain version of the same passes."""
    if not plain:
        return ex._fused_cuda(x, fs, t, batched=batched)
    plans, entries = ex._fused_plan_cached(fs, t)
    plan = plans[0]
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    y = K.tiled_permute_tables_plain(
        x, plan.in_rows, plan.out_rows, plan.xor_low, plan.src0,
        geometry=K.plan_geometry(plan), epilogue=sig, epi_scalar=scal,
        epi_vmem=vmem, map_fns=fns, batched=batched)
    for plan in plans[1:]:
        y = K.tiled_permute_plain(y, plan, batched=batched)
    return y


def hand_cluster(n: int, t: int, n_epi: int, seed: int, bfly_every: int = 0):
    """A hand-built cluster on the bit reversal's tile plan at 2^n, tile t:
    (plan, epilogue signature, per-tile tables, per-row/lane tables). Its
    partner XORs are the tile's single position bits, in order (so later
    ones fall on the warp bits of an earlier layout), then random XORs of
    several bits, every fourth the XOR of the two before it; the tables
    are random linear ones; every ``bfly_every``-th epilogue is a
    butterfly (planar float32) when non-zero."""
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.core.tiling import _affine_table, plan_bmmc
    rng = np.random.default_rng(seed)
    plan = plan_bmmc(Bmmc.bit_reverse(n), t)[0]
    rpt, n_tiles = plan.rows_per_tile, plan.n_tiles
    rb, gb = rpt.bit_length() - 1, n_tiles.bit_length() - 1

    def table(bits, hi, const=False):
        imgs = [int(v) for v in rng.integers(0, hi, bits)]
        c = int(rng.integers(0, hi)) if const else 0
        return _affine_table(imgs, c).astype(np.int32)

    w = rng.normal(size=(1 << (n - 1), 2)).astype(np.float32)
    vs = [1 << b for b in range(t + rb)]
    while len(vs) < n_epi:
        vs.append(vs[-1] ^ vs[-2] if len(vs) % 4 == 3 and vs[-1] != vs[-2]
                  else int(rng.integers(3, rpt << t)))
    sig, scal, vmem = [], [], []
    for k, v in enumerate(vs[:n_epi]):
        hi = (table(rb, 2), table(t, 2), table(gb, 2, True))
        if bfly_every and k % bfly_every == bfly_every - 1:
            tw = (table(rb, 1 << (n - 1)), table(t, 1 << (n - 1)),
                  table(gb, 1 << (n - 1), True))
            sig.append(("bfly", v >> t, v & ((1 << t) - 1), 1 << (n - 1)))
            scal.append((hi[2], tw[2]))
            vmem.append((hi[0], hi[1], tw[0], tw[1], w))
        else:
            sig.append(("cmp", v >> t, v & ((1 << t) - 1)))
            scal.append((hi[2],))
            vmem.append((hi[0], hi[1]))
    return plan, tuple(sig), tuple(scal), tuple(vmem)


HAND_CASES = (  # label, log2 n, t, epilogues, butterfly every, dtype, tail,
                # batch, NaNs
    ("int32", 14, 6, 20, 0, "int32", 1, 1, False),
    ("float32 NaN/-0", 14, 6, 20, 0, "float32", 1, 1, True),
    ("bfloat16 NaN/-0", 14, 6, 20, 0, "bfloat16", 1, 1, True),
    ("float32 -0, no NaN (keys)", 14, 6, 20, 0, "float32", 1, 1, False),
    ("bfloat16 -0, no NaN (keys)", 14, 6, 20, 0, "bfloat16", 1, 1, False),
    ("float32 d=3 NaN/-0", 14, 5, 20, 0, "float32", 3, 1, True),
    ("float32 B=3", 14, 6, 20, 0, "float32", 1, 3, False),
    ("planar float32, butterflies and compares", 14, 5, 12, 3, "float32",
     2, 1, False),
    ("float32 tile of 2^14 positions (chunks)", 16, 7, 14, 0, "float32", 1,
     1, False),
)


def phase_hand(torch, backward: bool) -> float:
    """K4b (or K5, ``backward``) bit for bit against its plain version on
    hand-built clusters whose partner XORs fall in registers, on lanes and
    on the warp bits of an earlier layout, with XORs of several bits and
    more than 16 compares; returns the worst error."""
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import epilogue_plan as EP
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(71 + backward)
    worst = 0.0
    for (label, n, t, n_epi, bfly, dname, d, batch,
         nan) in HAND_CASES:
        dtype = getattr(torch, dname)
        if backward and dtype == torch.int32:
            continue
        plan, sig, scal, vmem = hand_cluster(n, t, n_epi, seed=n_epi + t,
                                             bfly_every=bfly)
        shape = (batch, 1 << n, d)
        v = torch.randint(-4, 5, shape, generator=gen, device=dev).float()
        u = torch.rand(shape, generator=gen, device=dev)
        if nan:
            v = torch.where(u < 0.05, torch.full_like(v, float("nan")), v)
        v = torch.where((u > 0.5) & (v == 0), torch.full_like(v, -0.0), v)
        x = v.to(dtype) if not bfly else torch.randn(shape, generator=gen,
                                                     device=dev)
        kw = dict(geometry=K.plan_geometry(plan), epilogue=sig,
                  epi_scalar=scal, epi_vmem=vmem, batched=True)
        tabs = (plan.in_rows, plan.out_rows, plan.xor_low)
        entries = K._epi_entries(sig, scal, vmem)
        _, _, pl, _ = K._epi_launch_args(x, kw["geometry"], entries,
                                         n_buf=2 if backward else 1)
        words = pl.cpu().numpy()
        vl = [int(EP.epi_slice(words, e)[EP.EP_VLANE])
              for e in range(len(sig))]
        vr = [int(EP.epi_slice(words, e)[EP.EP_VREG])
              for e in range(len(sig))]
        classes = (f"{pl.info['n_phases']} phases, {vl.count(0)} in-thread "
                   f"and {len(vl) - vl.count(0)} shuffled epilogues, "
                   f"{sum(bin(a | b << 4).count('1') > 1 for a, b in zip(vr, vl))}"
                   f" with several coordinates, {2 ** pl.info['reg_bits']} "
                   f"registers a thread, {2 ** pl.info['outer_bits']} "
                   f"chunk(s)")
        if backward:
            s0 = plan.src0.reshape(-1)
            inv = np.empty_like(s0)
            inv[s0] = np.arange(s0.size, dtype=s0.dtype)
            inv = inv.reshape(plan.src0.shape)
            ct = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  if not nan else x.flip(1).contiguous())
            got = K.tiled_permute_bwd_tables(x, ct, *tabs, inv, **kw)
            want = K.tiled_permute_bwd_tables_plain(x, ct, *tabs, inv, **kw)
        else:
            got = K.tiled_permute_tables(x, *tabs, plan.src0, **kw)
            want = K.tiled_permute_tables_plain(x, *tabs, plan.src0, **kw)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, ("hand-built", backward, label, err))
        worst = max(worst, err)
        say(f"  hand-built, {n_epi} epilogues ({classes}), {label}: "
            f"bit-equal")
    return worst


# Map epilogues on hand-built clusters: each map is (position in the
# epilogue list, name, torch function or the name of one). Float inputs
# are continuous (uniform in [-4, 4), zeros planted for v / v; the tanh
# and log case in [0.5, 1.5)). Every case is held bit for bit in both
# directions: K4b's tape runs the math functions PyTorch's CUDA kernels
# call (tanhf, expf, logf), rounding as they do, and K5 takes each op's
# derivative as PyTorch's CUDA backward kernels round it (float32 tanh's
# 1 - y * y an FMA; bfloat16 tanh and sigmoid rounded after each op).


def _sq(v):
    return v * v


def _silu(v):
    return v * v.sigmoid()


def _self_ratio(v):
    return v / v          # 1, or NaN where v is zero: NaNs mid-phase


def _chain3(v):
    return (v * 3 + 1) / 7   # bfloat16: each of the three ops rounds


def _chain3_once(v):
    return ((v.float() * 3 + 1) / 7).to(v.dtype)   # rounded once


def _div3(v):
    return v / 3


def _wrap(v):
    return v * 1000003 + 7


MAP_CASES = (  # label, log2 n, t, compares, maps, dtype, tail, batch
    ("float32, maps between compares and at a phase boundary", 14, 6, 20,
     ((3, "sq", _sq), (9, "silu", _silu), (11, "sq", _sq), (23, "silu",
                                                            _silu)),
     "float32", 1, 1),
    ("float32, a map that makes NaNs mid-phase (keys, then floats)", 14, 6,
     12, ((4, "v/v", _self_ratio),), "float32", 1, 1),
    ("bfloat16, a chain of three ops rounded after each", 14, 6, 12,
     ((2, "chain3", _chain3), (9, "chain3", _chain3)), "bfloat16", 1, 1),
    ("bfloat16, tanh, exp, sigmoid and a division by a number", 14, 6, 12,
     ((1, "tanh", "tanh"), (4, "exp", "exp"), (7, "sigmoid", "sigmoid"),
      (10, "div3", _div3)), "bfloat16", 1, 1),
    ("int32, a wrapping map", 14, 6, 12, ((1, "wrap", _wrap),
                                          (7, "not", "bitwise_not")),
     "int32", 1, 1),
    ("float32 B=3, d=3", 14, 5, 12, ((2, "sq", _sq), (8, "silu", _silu)),
     "float32", 3, 3),
    ("float32, tanh and log", 14, 6, 12,
     ((0, "tanh", "tanh"), (6, "log", "log")), "float32", 1, 1),
)
# relative error of phase 10's tanh >> sort gradient against the library
# composite (torch.sort after torch.tanh under autograd)
MAP_GRAD_TOL = 1e-5


def phase_hand_maps(torch, backward: bool) -> float:
    """K4b (or K5, ``backward``) against its plain version on hand-built
    clusters with map epilogues, bit for bit; returns the worst bit
    difference. A compare bit that K5's replay got wrong would send a
    cotangent to the wrong position."""
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import epilogue_plan as EP
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(81 + backward)
    worst = 0.0
    for (label, n, t, n_cmp, maps, dname, d, batch) in MAP_CASES:
        dtype = getattr(torch, dname)
        if backward and dtype == torch.int32:
            continue
        plan, sig, scal, vmem = hand_cluster(n, t, n_cmp, seed=n_cmp + t)
        sig, scal, vmem, fns = list(sig), list(scal), list(vmem), []
        for pos, name, fn in maps:
            sig.insert(pos, ("map", name))
            scal.insert(pos, ())
            vmem.insert(pos, ())
        for sg in sig:
            if sg[0] == "map":
                fn = next(f for _, nm, f in maps if nm == sg[1])
                fns.append(getattr(torch, fn) if isinstance(fn, str) else fn)
        shape = (batch, 1 << n, d)
        if dtype == torch.int32:
            v = torch.randint(-4, 5, shape, generator=gen, device=dev)
            x = (v * 65537 + 11).to(torch.int32) * 32771
        elif "log" in {nm for _, nm, _ in maps}:
            x = (torch.rand(shape, generator=gen, device=dev) + 0.5).to(
                dtype)
        else:
            u = torch.rand(shape, generator=gen, device=dev)
            x = (torch.rand(shape, generator=gen, device=dev) - 0.5) * 8
            x = torch.where(u < 0.05, torch.zeros_like(x), x).to(dtype)
        if any(f is _chain3 for _, _, f in maps):
            # the inputs tell per-op rounding from rounding once: a kernel
            # that rounded once would differ from the plain version
            once = int((bits(torch, _chain3(x)) != bits(
                torch, _chain3_once(x))).sum())
            check(once > 0, ("chain3 inputs do not discriminate", label))
        kw = dict(geometry=K.plan_geometry(plan), epilogue=tuple(sig),
                  epi_scalar=tuple(scal), epi_vmem=tuple(vmem),
                  map_fns=tuple(fns), batched=True)
        tabs = (plan.in_rows, plan.out_rows, plan.xor_low)
        entries = K._epi_entries(kw["epilogue"], kw["epi_scalar"],
                                 kw["epi_vmem"], kw["map_fns"], dtype)
        _, _, pl, _ = K._epi_launch_args(x, kw["geometry"], entries,
                                         n_buf=2 if backward else 1)
        words = pl.cpu().numpy()
        phases = [[int(EP.epi_slice(words, e)[EP.EP_KIND]) for e in range(
            int(EP.phase_slice(words, p)[EP.PH_E0]),
            int(EP.phase_slice(words, p)[EP.PH_E1]))]
            for p in range(pl.info["n_phases"])]
        at = [[i for i, k in enumerate(ph) if k == EP.KIND_MAP]
              for ph in phases]
        where = (f"{pl.info['n_phases']} phase(s), map positions by phase "
                 f"{at} of {[len(ph) for ph in phases]} epilogues")
        if backward:
            s0 = plan.src0.reshape(-1)
            inv = np.empty_like(s0)
            inv[s0] = np.arange(s0.size, dtype=s0.dtype)
            inv = inv.reshape(plan.src0.shape)
            ct = torch.randn(shape, generator=gen, device=dev).to(dtype)
            got = K.tiled_permute_bwd_tables(x, ct, *tabs, inv, **kw)
            want = K.tiled_permute_bwd_tables_plain(x, ct, *tabs, inv, **kw)
            on_card = [torch.from_numpy(a).to(dev) for a in tabs + (inv,)]

            def call():
                return K.tiled_permute_bwd_tables(x, ct, *on_card, **kw)
        else:
            got = K.tiled_permute_tables(x, *tabs, plan.src0, **kw)
            want = K.tiled_permute_tables_plain(x, *tabs, plan.src0, **kw)
            on_card = [torch.from_numpy(a).to(dev)
                       for a in tabs + (plan.src0,)]

            def call():
                return K.tiled_permute_tables(x, *on_card, **kw)
        ms, dev_ms = cuda_ms(torch, call, REPS), device_ms(torch, call)
        timed = (f"; {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
                 f"({x.numel()} elements)")
        err = max_abs_err(torch, got, want)
        check(err == 0.0, ("map hand-built", backward, label, err))
        worst = max(worst, err)
        extra = (f"; {once} of {x.numel()} inputs round differently once"
                 if any(f is _chain3 for _, _, f in maps) else "")
        say(f"  maps, hand-built ({where}), {label}: bit-equal{timed}"
            f"{extra}")
    return worst


def device_ms(torch, fn, inner: int = 10) -> float:
    """Device milliseconds of one call of ``fn``: ``inner`` calls captured
    in one CUDA graph, replayed (median of REPS), so the host's launch
    overhead is not in the time."""
    from repro_torch.kernels import bmmc_permute as K
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with K.pin_device_tables():
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
    ms = cuda_ms(torch, g.replay, REPS, warmup=1) / inner
    del g
    return ms


def phase_fused(torch, n_small: int, n_sort: int, n_fft: int, reps: int,
                bw: float):
    """K4b against its plain version, bit for bit, at small sizes and on
    every FFT cluster at 2^n_fft; then one 2^n_sort int32 sort cluster,
    also bit for bit, timed beside the plain version and the torch
    composite of the same cluster."""
    say("== phase 6: K4b (tile_fused) vs plain ==")
    from repro_torch.combinators import CmpHalves, Perm
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)

    def ties(shape, dtype):
        """Small integers as ``dtype`` (many ties), with canonical NaNs and
        signed zeros for the float types."""
        v = torch.randint(-4, 5, shape, generator=gen, device=dev)
        if dtype == torch.int32:
            return v.to(torch.int32)
        f = v.to(torch.float32)
        u = torch.rand(shape, generator=gen, device=dev)
        f = torch.where(u < 0.05, torch.full_like(f, float("nan")), f)
        f = torch.where((u > 0.5) & (f == 0), torch.full_like(f, -0.0), f)
        return f.to(dtype)

    worst = 0.0
    by_size = {}
    for fs in fused_cases(n_small, 6, "sort"):
        by_size.setdefault(len(fs.computes), fs)
    check(1 in by_size and 2 in by_size and 3 in by_size, sorted(by_size))
    configs = [("int32", torch.int32, (1 << n_small,), False),
               ("float32 NaN/-0", torch.float32, (1 << n_small,), False),
               ("bfloat16 NaN/-0", torch.bfloat16, (1 << n_small,), False),
               ("int32 B=3", torch.int32, (3, 1 << n_small), True)]
    for label, dtype, shape, batched in configs:
        x = ties(shape, dtype)
        for k in (1, 2, 3):
            got = fused_call(K, ex, by_size[k], 6, x, batched)
            want = fused_call(K, ex, by_size[k], 6, x, batched, plain=True)
            err = max_abs_err(torch, got, want)
            check(err == 0.0, ("cmp", label, k, err))
            worst = max(worst, err)
        say(f"  n={n_small} cmp {label} t=6: clusters of 1, 2 and 3 "
            f"epilogues bit-equal")
    t3 = ops.choose_tile(n_small, 4, 3)
    for fs in fused_cases(n_small, t3, "sort")[:3]:
        x = ties((1 << n_small, 3), torch.float32)
        err = max_abs_err(torch, fused_call(K, ex, fs, t3, x),
                          fused_call(K, ex, fs, t3, x, plain=True))
        check(err == 0.0, ("cmp d=3", err))
        worst = max(worst, err)
    say(f"  n={n_small} cmp float32 d=3 t={t3}: bit-equal")
    # the butterfly arm at a small size and at the combinator path's FFT
    # size, where its twiddle table is 2^(n_fft - 1) entries read through L2
    for nb in (n_small, n_fft):
        t2 = ops.choose_tile(nb, 4, 2)
        for fs in fused_cases(nb, t2, "fft"):
            x = torch.randn((1 << nb, 2), generator=gen, device=dev)
            err = max_abs_err(torch, fused_call(K, ex, fs, t2, x),
                              fused_call(K, ex, fs, t2, x, plain=True))
            check(err == 0.0, ("bfly", nb, len(fs.computes), err))
            worst = max(worst, err)
            say(f"  n={nb} bfly float32 planar t={t2}: "
                f"{len(fs.computes)} epilogues bit-equal")
        del x
    worst = max(worst, phase_hand(torch, backward=False))
    worst = max(worst, phase_hand_maps(torch, backward=False))

    t = ops.choose_tile(n_sort, 4)
    fs = max(fused_cases(n_sort, t, "sort"), key=lambda s: len(s.computes))
    x = torch.randint(-2**31, 2**31 - 1, (1 << n_sort,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    got = fused_call(K, ex, fs, t, x)
    want = fused_call(K, ex, fs, t, x, plain=True)
    err = max_abs_err(torch, got, want)
    check(err == 0.0, ("2^n cluster", err))
    worst = max(worst, err)
    # the torch composite of the same cluster: each Perm an index_select
    # on a precomputed index, each CmpHalves torch.minimum/maximum
    idx = {id(s): ref.bmmc_src_index(s.bmmc, dev) for s in fs.stages
           if isinstance(s, Perm)}

    def composite():
        v = x
        for s in fs.stages:
            if isinstance(s, Perm):
                v = torch.index_select(v, 0, idx[id(s)])
            else:
                check(isinstance(s, CmpHalves), type(s).__name__)
                lo, hi = v.chunk(2)
                v = torch.cat([torch.minimum(lo, hi), torch.maximum(lo, hi)])
        return v
    check(torch.equal(composite(), got), "torch composite of the cluster")
    del got, want
    plans, entries = ex._fused_plan_cached(fs, t)
    check(len(plans) == 1, "one pass")
    tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plans[0], dev))
    tab_bytes += sum(np.asarray(a).nbytes for e in entries
                     for a in (e[2].hi_row, e[2].hi_lane, e[2].hi_base))
    nbytes = x.numel() * 4
    ms = cuda_ms(torch, lambda: fused_call(K, ex, fs, t, x), reps)
    dev_ms = device_ms(torch, lambda: fused_call(K, ex, fs, t, x))
    plain_ms = cuda_ms(torch, lambda: fused_call(K, ex, fs, t, x, plain=True),
                       max(3, reps // 3), warmup=1)
    lib_ms = cuda_ms(torch, composite, reps)
    tile_ms = device_ms(torch, lambda: K.tiled_permute(x, plans[0]))
    copy_ms = device_ms(torch, lambda: K.copy_blocks(x))
    xf = x.float()
    f32_ms = device_ms(torch, lambda: fused_call(K, ex, fs, t, xf))
    bound_ms = (2 * nbytes + tab_bytes) / bw * 1e3
    say(f"  n={n_sort} int32 sort cluster ({len(fs.stages)} stages, "
        f"{len(fs.computes)} cmp epilogues, t={t}): bit-equal; kernel "
        f"{ms:.4f} ms a call (the host's launch path included), "
        f"{dev_ms:.4f} ms on the device ({2 * nbytes / dev_ms / 1e6:.1f} "
        f"GB/s), float32 keys {f32_ms:.4f} ms, same pass without epilogues "
        f"(K4a) {tile_ms:.4f} ms, copy {copy_ms:.4f} ms (device times: 10 "
        f"calls in one CUDA graph), plain {plain_ms:.3f} ms, torch composite "
        f"{lib_ms:.3f} ms, bound {bound_ms:.4f} ms")
    del xf
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": worst}


def bwd_call(K, ex, fs, t, x, ct, batched=False, plain=False):
    """One cluster's backward through K5 as the executor runs it (its
    tables kept on the card), or through K5's plain version."""
    if not plain:
        return ex._fused_bwd_cuda(fs, t, batched, x, ct)
    plans, entries, inv, _ = ex._fused_bwd_kernel_plan(fs, t)
    plan = plans[0]
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    return K.tiled_permute_bwd_tables_plain(
        x, ct, plan.in_rows, plan.out_rows, plan.xor_low, inv,
        geometry=K.plan_geometry(plan), epilogue=sig, epi_scalar=scal,
        epi_vmem=vmem, map_fns=fns, batched=batched)


def phase_bwd_kernel(torch, n_small: int, n_sort: int, n_fft: int,
                     reps: int, bw: float):
    """K5 against its plain version, bit for bit, at small sizes, on the
    FFT's butterfly clusters at 2^n_fft and on the largest cluster of the
    2^n_sort float32 sort (keys from 2^16 values, so with ties); the last
    timed beside its bound, its plain version and the torch composite."""
    say("== phase 9: K5 (tile_bwd) vs plain ==")
    from repro_torch.combinators import CmpHalves, Perm
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)

    def ties(shape, dtype):
        """Small integers as ``dtype`` (many ties), with canonical NaNs and
        signed zeros."""
        f = torch.randint(-4, 5, shape, generator=gen, device=dev).float()
        u = torch.rand(shape, generator=gen, device=dev)
        f = torch.where(u < 0.05, torch.full_like(f, float("nan")), f)
        f = torch.where((u > 0.5) & (f == 0), torch.full_like(f, -0.0), f)
        return f.to(dtype)

    def compare(fs, t, x, ct, batched=False):
        got = bwd_call(K, ex, fs, t, x, ct, batched)
        want = bwd_call(K, ex, fs, t, x, ct, batched, plain=True)
        return max_abs_err(torch, got, want)

    worst = 0.0
    by_size = {}
    for fs in fused_cases(n_small, 6, "sort"):
        by_size.setdefault(len(fs.computes), fs)
    configs = [("float32 NaN/-0", torch.float32, (1 << n_small,), False),
               ("bfloat16 NaN/-0", torch.bfloat16, (1 << n_small,), False),
               ("float32 B=3", torch.float32, (3, 1 << n_small), True)]
    for label, dtype, shape, batched in configs:
        x = ties(shape, dtype)
        ct = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for k in (1, 2, 3):
            err = compare(by_size[k], 6, x, ct, batched)
            check(err == 0.0, ("K5 cmp", label, k, err))
            worst = max(worst, err)
        say(f"  n={n_small} cmp {label} t=6: clusters of 1, 2 and 3 "
            f"epilogues bit-equal")
    t3 = ops.choose_tile(n_small, 4, 3)
    for fs in fused_cases(n_small, t3, "sort")[:3]:
        x = ties((1 << n_small, 3), torch.float32)
        ct = torch.randn((1 << n_small, 3), generator=gen, device=dev)
        err = compare(fs, t3, x, ct)
        check(err == 0.0, ("K5 cmp d=3", err))
        worst = max(worst, err)
    say(f"  n={n_small} cmp float32 d=3 t={t3}: bit-equal")
    t2 = ops.choose_tile(n_fft, 4, 2)
    for fs in fused_cases(n_fft, t2, "fft"):
        x = torch.randn((1 << n_fft, 2), generator=gen, device=dev)
        ct = torch.randn((1 << n_fft, 2), generator=gen, device=dev)
        err = compare(fs, t2, x, ct)
        check(err == 0.0, ("K5 bfly", n_fft, err))
        worst = max(worst, err)
        say(f"  n={n_fft} bfly float32 planar t={t2}: {len(fs.computes)} "
            f"epilogues bit-equal")
    del x, ct
    worst = max(worst, phase_hand(torch, backward=True))
    worst = max(worst, phase_hand_maps(torch, backward=True))

    t = ops.choose_tile(n_sort, 4)
    fs = max(fused_cases(n_sort, t, "sort"), key=lambda s: len(s.computes))
    x = torch.randint(0, 1 << 16, (1 << n_sort,), generator=gen,
                      device=dev).float()
    ct = torch.randn(1 << n_sort, generator=gen, device=dev)
    err = compare(fs, t, x, ct)
    check(err == 0.0, ("K5 2^n cluster", err))
    worst = max(worst, err)
    # the torch composite: autograd's backward through the cluster's
    # stages run as torch ops (index_select per Perm, minimum/maximum per
    # compare); only the backward is timed
    idx = {id(s): ref.bmmc_src_index(s.bmmc, dev) for s in fs.stages
           if isinstance(s, Perm)}
    xr = x.clone().requires_grad_(True)
    v = xr
    for s in fs.stages:
        if isinstance(s, Perm):
            v = torch.index_select(v, 0, idx[id(s)])
        else:
            check(isinstance(s, CmpHalves), type(s).__name__)
            lo, hi = v.chunk(2)
            v = torch.cat([torch.minimum(lo, hi), torch.maximum(lo, hi)])
    plans, entries = ex._fused_plan_cached(fs, t)
    tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plans[0], dev))
    tab_bytes += plans[0].src0.nbytes   # inv_src0
    tab_bytes += sum(np.asarray(a).nbytes for e in entries
                     for a in (e[2].hi_row, e[2].hi_lane, e[2].hi_base))
    nbytes = x.numel() * 4
    ms = cuda_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct), reps)
    dev_ms = device_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct))
    plain_ms = cuda_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct,
                                                plain=True),
                       max(3, reps // 3), warmup=1)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        v, xr, ct, retain_graph=True), reps)
    fwd_ms = device_ms(torch, lambda: ex._fused_cuda(x, fs, t))
    bound_ms = (3 * nbytes + tab_bytes) / bw * 1e3
    say(f"  n={n_sort} float32 sort cluster ({len(fs.stages)} stages, "
        f"{len(fs.computes)} cmp epilogues, t={t}, keys from 2^16 values): "
        f"bit-equal; K5 {ms:.4f} ms a call (the host's launch path "
        f"included), {dev_ms:.4f} ms on the device "
        f"({3 * nbytes / dev_ms / 1e6:.1f} GB/s), the forward pass (K4b) "
        f"{fwd_ms:.4f} ms on the device, plain {plain_ms:.3f} ms, torch "
        f"composite backward {lib_ms:.3f} ms, bound {bound_ms:.4f} ms")
    say(f"  clocks, power, temperature: {clocks()}")
    del v, xr
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": worst}


def phase_gradients(torch, n_sort: int, n_ties: int, n_fft: int,
                    n_perm: int, reps: int):
    """Gradients through the entry points, ``loss = (w * f(x)).sum()``.
    Returns the K5 launches of the main path's cold backwards (the sort,
    tanh >> sort and the FFT)."""
    say("== phase 10: gradients on the main path ==")
    from repro_torch import obs
    from repro_torch.combinators import FusedStage, clear_caches, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import vocab as V
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)

    def cold_grad(f, x, w):
        """One cold forward + backward with telemetry on: (gradient,
        counted backward round trips, fused fallbacks, K5 launches,
        host seconds)."""
        clear_caches()
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            xt = x.clone().requires_grad_(True)
            (w * f(xt)).sum().backward()
            torch.cuda.synchronize()
        finally:
            obs.disable()
        sec = time.perf_counter() - t0
        rt = obs.counter_total("model.vjp_round_trips")
        fb = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        return xt.grad, rt, fb, K.launch_counts()["tile_bwd"], sec

    def clusters(f, n, t):
        return sum(isinstance(s, FusedStage) and bool(s.computes)
                   for s in f.clustered_program(n, t))

    def times(name, f, x, w, lib, forward="graph"):
        """Forward alone (recording the graph) and forward + backward, the
        forward without grad (the CUDA graph; a Map program's runs
        eagerly), and the library's."""
        xt = x.clone().requires_grad_(True)

        def fwd_bwd(fn):
            xt.grad = None
            (w * fn(xt)).sum().backward()
        fwd = cuda_ms(torch, lambda: f(xt), reps)
        both = cuda_ms(torch, lambda: fwd_bwd(f), reps)
        graph = cuda_ms(torch, lambda: f(x), reps)
        lib_fwd = cuda_ms(torch, lambda: lib(xt), reps)
        lib_both = cuda_ms(torch, lambda: fwd_bwd(lib), reps)
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(f)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"  {name}: forward {fwd:.3f} ms, forward + backward "
            f"{both:.3f} ms (peak device memory {peak:.2f} GiB), forward "
            f"without grad ({forward}) {graph:.3f} ms; library under "
            f"autograd: "
            f"forward {lib_fwd:.3f} ms, forward + backward {lib_both:.3f} ms")
        say(f"  clocks, power, temperature: {clocks()}")

    def breakdown(name, f, x, n, t):
        """CUDA-event ms of each stage's backward run alone (on a random
        cotangent, at the stage's own saved input), summed by kind."""
        from repro_torch.combinators import Perm, run_program
        prog = f.clustered_program(n, t)
        res, v = [], x
        for st in prog:
            res.append(v)
            v = run_program((st,), v, "cuda")
        ct = torch.randn(v.shape, generator=gen, device=dev)
        by = {}
        for st, xs in zip(reversed(prog), reversed(res)):
            if isinstance(st, Perm):
                kind = "inverse " + ops.class_plan(st.bmmc.inverse(), t)[0]
                fn = (lambda st=st: ex.perm_apply(ct, st.bmmc.inverse(),
                                                  "cuda"))
            elif isinstance(st, FusedStage) and not st.computes:
                kind = "inverse fused (compute-free)"
                fn = (lambda st=st: ex.fused_apply(
                    ct, ex._fused_inverse_cached(st), "cuda"))
            elif isinstance(st, FusedStage):
                kind = "K5"
                fn = (lambda st=st, xs=xs: ex._fused_bwd_impl(
                    st, "cuda", False, xs, ct))
            else:
                kind = "compute VJP"
                fn = (lambda st=st, xs=xs: ex._compute_bwd(st, xs, ct,
                                                           False))
            by[kind] = by.get(kind, 0.0) + cuda_ms(torch, fn, 3, warmup=1)
        say(f"  {name}: backward ms by kind (each stage timed alone): "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items()))
            + f"; sum {sum(by.values()):.3f}")

    k5 = 0
    # the sort of distinct keys: the gradient scatters w to the sorting
    # permutation
    n = n_sort
    x = torch.randperm(1 << n, generator=gen, device=dev).float()
    w = torch.randn(1 << n, generator=gen, device=dev)
    f = S.compiled_sort(n)
    t = ops.choose_tile(n, 4)
    g, rt, fb, launched, sec = cold_grad(f, x, w)
    want = torch.zeros_like(w).scatter_(0, torch.sort(x).indices, w)
    check(max_abs_err(torch, g, want) == 0.0, "sort gradient")
    model = f.vjp_round_trips(n, t)
    fwd_rt = f.cost(n, t, clustered=True)["round_trips"]
    check(rt == model == fwd_rt, ("sort vjp round trips", rt, model, fwd_rt))
    check(fb == 0, ("sort backward fused fallbacks", fb))
    check(launched == clusters(f, n, t), ("K5 launches", launched))
    k5 += launched
    say(f"  sort of 2^{n} float32 (distinct keys): gradient equal to the "
        f"scatter of w bit for bit; cold forward + backward {sec:.2f} s "
        f"(host clock, planning included); backward round trips {int(rt)} "
        f"(counted) = {model} (vjp_round_trips) = {fwd_rt} (forward); "
        f"K5 launches {launched}; fused fallbacks 0")
    times(f"sort 2^{n} float32", f, x, w, lambda v: torch.sort(v).values)
    breakdown(f"sort 2^{n} float32", f, x, n, t)
    del g, want
    torch.cuda.empty_cache()

    # tanh >> sort: the map fused into the first cluster, K5 its gradient
    from repro_torch.combinators.sort import sort_expr
    ft = compile_expr(V.emap("tanh", torch.tanh) >> sort_expr(n))
    # distinct keys in [-1/2, 1/2), where tanh ties few of them
    x = (torch.randperm(1 << n, generator=gen, device=dev).float()
         - (1 << (n - 1))) / (1 << n)
    g, rt, fb, launched, sec = cold_grad(ft, x, w)
    model = ft.vjp_round_trips(n, t)
    fwd_rt = ft.cost(n, t, clustered=True)["round_trips"]
    check(rt == model == fwd_rt, ("tanh sort vjp round trips", rt, model,
                                   fwd_rt))
    check(fb == 0, ("tanh sort fused fallbacks", fb))
    check(launched == clusters(ft, n, t), ("K5 launches", launched))
    k5 += launched
    # the library composite under autograd; where tanh ties keys, the two
    # split the tied cotangents differently, so a tied group is held by
    # its sum
    xl = x.clone().requires_grad_(True)
    (w * torch.sort(torch.tanh(xl)).values).sum().backward()
    want = xl.grad
    keys, order = torch.sort(torch.tanh(x))
    first = torch.ones_like(keys, dtype=torch.bool)   # a group's first key
    first[1:] = keys[1:] != keys[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    group = torch.cumsum(first.long(), 0) - 1
    tied = torch.empty_like(first)
    tied[order] = ~(first & last)
    rel_one = float(((g - want).abs() / want.abs().clamp_min(1e-30))[
        ~tied & (want != 0)].max())
    sums = [torch.zeros(int(group[-1]) + 1, device=dev).index_add_(
        0, group, v[order]) for v in (g, want)]
    rel_sum = float((sums[0] - sums[1]).abs().max()
                    / sums[1].abs().max())
    check(bool(torch.isfinite(g).all()), "tanh sort gradient finite")
    check(rel_one <= MAP_GRAD_TOL and rel_sum <= MAP_GRAD_TOL,
          ("tanh sort gradient", rel_one, rel_sum))
    say(f"  tanh >> sort of 2^{n} float32: gradient within {rel_one:.3e} "
        f"(elementwise, {int((~tied).sum())} untied keys) and {rel_sum:.3e} "
        f"(sums over {int(group[-1]) + 1 - int((~tied).sum())} groups of "
        f"tied keys) of torch.sort(torch.tanh(x)) under autograd (limit "
        f"{MAP_GRAD_TOL:g}); cold forward + backward {sec:.2f} s; round "
        f"trips {int(rt)} (counted backward) = {model} (vjp_round_trips) = "
        f"{fwd_rt} (forward); K5 launches {launched}; fused fallbacks 0")
    times(f"tanh >> sort 2^{n} float32", ft, x, w,
          lambda v: torch.sort(torch.tanh(v)).values, forward="eager")
    del g, want, xl, keys, order, group, tied, sums
    torch.cuda.empty_cache()

    # the gradient kernel route against the collapsed route, with ties
    n = n_ties
    x = torch.randint(0, 1 << 12, (1 << n,), generator=gen, device=dev).float()
    w = torch.randn(1 << n, generator=gen, device=dev)
    f = S.compiled_sort(n)
    grads = []
    for mega in (True, False):
        ex.BWD_MEGAKERNEL = mega
        try:
            grads.append(cold_grad(f, x, w)[0])
        finally:
            ex.BWD_MEGAKERNEL = True
    clear_caches()
    check(max_abs_err(torch, grads[0], grads[1]) == 0.0,
          "K5 route vs collapsed route")
    say(f"  sort of 2^{n} float32 with ties (keys from 2^12 values): the "
        f"gradient kernel route equals the collapsed route bit for bit")
    del grads
    torch.cuda.empty_cache()

    # the FFT against float64 torch.fft.fft under autograd
    n = n_fft
    xr = torch.randn((1 << n, 2), generator=gen, device=dev)
    w = torch.randn((1 << n, 2), generator=gen, device=dev)
    f = F.compiled_fft(n)
    t = ops.choose_tile(n, 4, 2)
    g, rt, fb, launched, sec = cold_grad(f, xr, w)
    x64 = xr.double().requires_grad_(True)
    (w.double() * torch.view_as_real(torch.fft.fft(
        torch.view_as_complex(x64)))).sum().backward()
    rel = float(torch.linalg.vector_norm(g.double() - x64.grad)
                / torch.linalg.vector_norm(x64.grad))
    check(bool(torch.isfinite(g).all()) and g.shape == xr.shape, "fft grad")
    check(rel <= FFT_REL_TOL, ("fft gradient relative error", rel))
    model = f.vjp_round_trips(n, t)
    fwd_rt = f.cost(n, t, clustered=True)["round_trips"]
    check(rt == model == fwd_rt, ("fft vjp round trips", rt, model, fwd_rt))
    check(fb == 0, ("fft backward fused fallbacks", fb))
    check(launched == clusters(f, n, t), ("K5 launches", launched))
    k5 += launched
    say(f"  FFT of 2^{n} planar float32: gradient within {rel:.3e} "
        f"(norm-wise) of float64 torch.fft.fft under autograd (limit "
        f"{FFT_REL_TOL:g}); cold forward + backward {sec:.2f} s; backward "
        f"round trips {int(rt)} = {model} = {fwd_rt} (forward); K5 launches "
        f"{launched}; fused fallbacks 0")
    times(f"FFT 2^{n} planar float32", f, xr, w,
          lambda v: torch.view_as_real(torch.fft.fft(torch.view_as_complex(v))))
    breakdown(f"FFT 2^{n} planar float32", f, xr, n, t)
    del g, x64
    torch.cuda.empty_cache()

    # a permutation-only chain: its gradient is the inverse program
    n = n_perm
    rng = random.Random(2306)
    expr = (V.bit_reverse(n) >> V.perm(Bmmc.matrix_transpose(n // 2, n - n // 2))
            >> V.perm(Bmmc.random_bpc(n, rng)))
    f = compile_expr(expr)
    (stage,) = f.program(n)   # the optimizer fuses the chain into one BMMC
    idx = ref.bmmc_src_index(stage.bmmc, dev)
    t = ops.choose_tile(n, 4)
    x = torch.randn(1 << n, generator=gen, device=dev)
    w = torch.randn(1 << n, generator=gen, device=dev)
    g, rt, fb, _, sec = cold_grad(f, x, w)
    want = w
    for s in f.vjp_program(n):
        want = ref.bmmc_ref_device(want, s.bmmc)
    check(max_abs_err(torch, g, want) == 0.0, "perm chain gradient")
    model = f.vjp_round_trips(n, t)
    check(rt == model, ("perm chain vjp round trips", rt, model))
    say(f"  permutation chain (bit-reverse, transpose, random BPC) on 2^{n} "
        f"float32: gradient equal to the inverse program applied to w bit "
        f"for bit; backward round trips {int(rt)} = {model}; cold forward + "
        f"backward {sec:.2f} s")
    times(f"permutation chain 2^{n} float32", f, x, w,
          lambda v: torch.index_select(v, 0, idx))
    del g, want, idx
    torch.cuda.empty_cache()
    return k5


def plan_program(f, x, batched=False):
    """Resolve a compiled program and build every plan it runs (the
    host planning of a cold call): (program, t, seconds)."""
    from repro_torch.combinators import FusedStage, Perm
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    prog, t = f._resolve(x, batched)
    for s in prog:
        if isinstance(s, FusedStage):
            check(ex._fused_plan_cached(s, t) is not None, "cluster plan")
        elif isinstance(s, Perm):
            ops.class_plan(s.bmmc, t)
    return prog, t, time.perf_counter() - t0


def phase_combinators(torch, n_sort: int, n_fft: int, reps: int):
    """The combinator path through its entry points: the sort of 2^n_sort
    int32 keys and the FFT of 2^n_fft planar float32 points. Returns the
    launch counts of the two cold calls."""
    say("== phase 7: combinator path (sort, FFT) ==")
    from repro_torch import obs
    from repro_torch.combinators import program_cost
    from repro_torch.combinators import clear_caches
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.kernels import bmmc_permute as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2306)
    counts = {k: 0 for k in K.LAUNCHES}
    clear_caches()   # the planning seconds below are a cold call's

    def cold(fn, x):
        """The entry point's first call with telemetry on: (result, modeled
        round trips counted, fused fallbacks, launch counts)."""
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        try:
            y = fn(x)
            torch.cuda.synchronize()
        finally:
            obs.disable()
        c = K.launch_counts()
        for k, v in c.items():
            counts[k] += v
        rt = obs.counter_total("model.round_trips")
        fb = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        return y, rt, fb, c

    def breakdown(f, x, prog):
        """CUDA-event ms of each stage of the program run on its own, summed
        by the kind ``program_cost`` counts it as."""
        from repro_torch.combinators import FusedStage, Perm, run_program
        from repro_torch.kernels import ops
        t = f._resolve(x, False)[1]
        by = {}
        v = x
        for s in prog:
            if isinstance(s, FusedStage):
                kind = "fused"
            elif isinstance(s, Perm):
                kind = ops.class_plan(s.bmmc, t)[0]
            else:
                kind = "sweep"
            ms = cuda_ms(torch, lambda: run_program((s,), v, "cuda"), 3,
                         warmup=1)
            by[kind] = by.get(kind, 0.0) + ms
            v = run_program((s,), v, "cuda")
        return by

    def report(name, f, x, nbytes, prog, t, plan_s, rt, lib, lib_name):
        cost = program_cost(prog, t, x.element_size() * (
            x.shape[-1] if x.dim() == 2 else 1))
        check(rt == cost["round_trips"], (name, rt, cost["round_trips"]))
        ms = cuda_ms(torch, lambda: f(x), reps)
        stage_ms = cuda_ms(torch, lambda: f.call_per_stage(x),
                           max(3, reps // 3), warmup=1)
        lib_ms = cuda_ms(torch, lib, reps)
        gbs = cost["round_trips"] * 2 * nbytes / ms / 1e6
        say(f"  {name}: plan {plan_s:.3f} s (cold); round trips "
            f"{cost['round_trips']} (program_cost) = {int(rt)} (counted); "
            f"kernels {cost['kernels']}; graph {ms:.3f} ms "
            f"({gbs:.1f} GB/s effective), per stage {stage_ms:.3f} ms, "
            f"{lib_name} {lib_ms:.3f} ms")
        by = breakdown(f, x, prog)
        say(f"  {name}: stage ms by kind (each stage timed alone): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(by.items())) +
            f"; sum {sum(by.values()):.3f}")
        say(f"  clocks, power, temperature: {clocks()}")

    x = torch.randint(-2**31, 2**31 - 1, (1 << n_sort,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    f = S.compiled_sort(n_sort)
    prog, t, plan_s = plan_program(f, x)
    y, rt, fb, c = cold(S.sort, x)
    check(fb == 0, f"sort: {fb} fused clusters fell back")
    check(max_abs_err(torch, y, torch.sort(x).values) == 0.0, "sort")
    say(f"  sort of 2^{n_sort} int32: bit-equal to torch.sort; cold-call "
        f"launches {c}")
    report(f"sort 2^{n_sort} int32", f, x, x.numel() * 4, prog, t, plan_s,
           rt, lambda: torch.sort(x), "torch.sort")
    del y
    torch.cuda.empty_cache()

    # the descending sort: not >> sort >> not, the maps fused into the
    # first and last clusters (a Map program runs eagerly, stage by stage)
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.sort import sort_expr
    fd = compile_expr(V.emap("not", torch.bitwise_not) >> sort_expr(n_sort)
                      >> V.emap("not", torch.bitwise_not))
    prog_d, t, _ = plan_program(fd, x)
    y, rt, fb, c = cold(fd, x)
    cost = program_cost(prog_d, t)["round_trips"]
    check(fb == 0, f"descending sort: {fb} fused clusters fell back")
    check(rt == cost, ("descending sort round trips", rt, cost))
    check(max_abs_err(torch, y, torch.sort(x, descending=True).values)
          == 0.0, "descending sort")
    check(c["tile_fused"] > 0, ("descending sort launches", c))
    ms_d = cuda_ms(torch, lambda: fd(x), reps)
    ms_graph = cuda_ms(torch, lambda: f(x), reps)
    ms_stage = cuda_ms(torch, lambda: f.call_per_stage(x), max(3, reps // 3),
                       warmup=1)
    lib_d = cuda_ms(torch, lambda: torch.sort(x, descending=True), reps)
    say(f"  descending sort of 2^{n_sort} int32 (not >> sort >> not): "
        f"bit-equal to torch.sort(descending=True); round trips {int(rt)} "
        f"(counted) = {cost} (program_cost); fused fallbacks 0; cold-call "
        f"launches {c}; {ms_d:.3f} ms (eager, stage by stage), the Map-free "
        f"sort {ms_graph:.3f} ms (graph) and {ms_stage:.3f} ms (stage by "
        f"stage), torch.sort(descending=True) {lib_d:.3f} ms")
    say(f"  clocks, power, temperature: {clocks()}")
    del y
    torch.cuda.empty_cache()

    z = torch.complex(torch.randn(1 << n_fft, generator=gen, device=dev),
                      torch.randn(1 << n_fft, generator=gen, device=dev))
    xr = F.to_planar(z)
    g = F.compiled_fft(n_fft)
    prog, t, plan_s = plan_program(g, xr)
    y, rt, fb, c = cold(F.fft_planar, xr)
    check(fb == 0, f"fft: {fb} fused clusters fell back")
    want = torch.fft.fft(z.to(torch.complex128))
    got = F.from_planar(y).to(torch.complex128)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    check(y.shape == xr.shape and bool(torch.isfinite(y).all()), "fft shape")
    check(rel <= FFT_REL_TOL, ("fft relative error", rel))
    say(f"  FFT of 2^{n_fft} planar float32: norm-wise relative error "
        f"{rel:.3e} against torch.fft.fft in float64 (limit "
        f"{FFT_REL_TOL:g}); cold-call launches {c}")
    report(f"FFT 2^{n_fft} planar float32", g, xr, xr.numel() * 4, prog, t,
           plan_s, rt, lambda: torch.fft.fft(z), "torch.fft.fft")
    # the complex64 entry point runs the same kernels on the planar view
    y, rt_c, fb, c = cold(F.fft, z)
    check(fb == 0, f"complex fft: {fb} fused clusters fell back")
    check(rt_c == rt and c["tile_fused"] > 0, ("complex fft", rt_c, c))
    check(torch.equal(torch.view_as_real(y), F.fft_planar(xr)),
          "complex fft equals the planar one")
    say(f"  FFT of 2^{n_fft} complex64: equal to the planar FFT bit for "
        f"bit; cold-call launches {c}")
    return counts


# ---------------------------------------------------------------------------
# phases 11-14: validated, durable and resilient execution
# ---------------------------------------------------------------------------

GUARDED = {"block": "block_guarded", "lane": "lane_guarded",
           "tile": "tile_guarded", "tile_fused": "tile_fused_guarded"}
N_FAULT = 24              # log2 elements of phase 12's poisoned tables
N_MATRIX = 14             # log2 elements of phase 14's fault matrix


def dev_hash(torch, t) -> int:
    """A position-sensitive 64-bit checksum of ``t``'s bits, computed on
    its device in chunks: equal across processes exactly when the bits
    are (up to a 2^-64 chance)."""
    v = bits(torch, t).reshape(-1)
    h = 0
    for s in range(0, v.numel(), 1 << 26):
        c = v[s:s + (1 << 26)].to(torch.int64)
        idx = torch.arange(s, s + c.numel(), device=c.device,
                           dtype=torch.int64)
        h += int(((c + 0x2545F491) * (2 * idx + 1)).sum())
    return h & ((1 << 64) - 1)


class GuardedCase:
    """K2, K3 or K4a on ``x`` with one plan of phase 4's dispatch cases:
    the guarded launch (into its own flag word), the unguarded launch and
    the guarded plain version, all on the plan's device tables."""

    def __init__(self, torch, name, plan, x):
        from repro_torch.kernels import bmmc_permute as K
        self.name, self.plan, self.x, self.K = name, plan, x, K
        self.flags = torch.zeros(1, dtype=torch.int32, device=x.device)
        self.tabs = K.device_tables(plan, x.device)

    def guarded(self, flags=None):
        K, fl = self.K, self.flags if flags is None else flags
        if self.name == "block":
            return K.block_permute_tables(self.x, self.tabs[0], flags=fl,
                                          geometry=K.block_geometry(self.plan))
        if self.name == "lane":
            return K.lane_permute_tables(self.x, self.tabs[0], flags=fl,
                                         geometry=K.lane_geometry(self.plan))
        return K.tiled_permute_tables(self.x, *self.tabs, flags=fl,
                                      geometry=K.plan_geometry(self.plan))

    def unguarded(self):
        K = self.K
        return {"block": K.block_permute, "lane": K.lane_permute,
                "tile": K.tiled_permute}[self.name](self.x, self.plan)

    def plain(self, flags):
        K = self.K
        if self.name == "block":
            return K.block_permute_plain(self.x, self.plan, flags=flags,
                                         src_rows=self.tabs[0])
        if self.name == "lane":
            return K.lane_permute_plain(self.x, self.plan, flags=flags,
                                        src_lane=self.tabs[0])
        return K.tiled_permute_plain(self.x, self.plan, tables=self.tabs,
                                     flags=flags)


TABLE_NAMES = {"block": ("src_rows",), "lane": ("src_lane",),
               "tile": ("in_rows", "out_rows", "xor_low", "src0")}


def guarded_kernel_cases(torch, n: int, x) -> list:
    """A :class:`GuardedCase` of K2, K3 and K4a at 2^n (the block-class,
    lane-class and bit-reverse BMMCs of phase 4)."""
    from repro_torch.kernels import ops
    t = ops.choose_tile(n, 4)
    cases = {name: b for name, b, _ in make_cases(n, t)}
    out = []
    for name, case in (("block", "block-class"), ("lane", "lane-class"),
                       ("tile", "bit-reverse")):
        payload = ops.class_plan(cases[case], t)[1]
        out.append(GuardedCase(torch, name, payload if name != "tile"
                               else payload[0], x))
    return out


def phase_guarded(torch, n: int, n_sort: int, reps: int, bw: float,
                  records: dict):
    """Phase 11: the main path with guards on. Returns (launch counts of
    the guarded run, records of the guarded kernels, hashes of the
    unguarded outputs for phase 13)."""
    say(f"== phase 11: guarded main path (bmmc_permute on 2^{n} int32, "
        f"sort of 2^{n_sort} int32) ==")
    from repro_torch import guard, resilience
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import execute as ex
    from repro_torch.guard import validate as gv
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    t = ops.choose_tile(n, 4)
    cases = make_cases(n, t)
    # ring 1 at the paper's size: dispatch proof, table audits and the
    # fingerprint of every table, per case (plans already built)
    for name, b, _ in cases:
        kernel, payload = ops.class_plan(b, t)
        gv.validate_dispatch.cache_clear()
        t0 = time.perf_counter()
        gv.validate_dispatch(b.rows, b.c, t)
        v_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gv.plan_fingerprint(kernel, payload)
        fp_s = time.perf_counter() - t0
        say(f"  ring 1 on {name} ({kernel}): validation with fingerprints "
            f"{v_s:.3f} s host, of which the fingerprint {fp_s:.3f} s")
    # the unguarded outputs, kept on the card to hold the guarded ones
    want = {name: ops.bmmc_permute(x, b) for name, b, _ in cases}
    hashes = {name: dev_hash(torch, y) for name, y in want.items()}
    xs = torch.randint(-2**31, 2**31 - 1, (1 << n_sort,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    f = S.compiled_sort(n_sort)
    want_sort = f(xs)
    check(torch.equal(want_sort, torch.sort(xs).values), "unguarded sort")
    hashes["sort"] = dev_hash(torch, want_sort)
    torch.cuda.synchronize()

    # the counted run: every case once, then the sort twice (its first
    # call runs eagerly and captures the guarded graph, the second
    # replays it), each output held against its unguarded call
    guard.reset_stats()
    resilience.reset()
    K.reset_launch_counts()
    with guard.guarded():
        for name, b, _ in cases:
            got = ops.bmmc_permute(x, b)
            check(torch.equal(got, want[name]), ("guarded", name))
            del got
        for _ in range(2):
            check(torch.equal(f(xs), want_sort), "guarded sort")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    st = guard.stats()
    say(f"  launch counts of the guarded run: {counts}")
    check(st["traps"] == {} and st["fallbacks"] == {} and not st["raised"],
          ("guarded run trapped", st))
    check(not resilience.board().engaged("cuda")
          and resilience.stats()["breaker"]["open"] == 0, "breaker")
    check(all(counts[k] == 0 for k in GUARDED), ("unguarded launches "
          "in the guarded run", counts))
    check(all(counts[g] > 0 for g in GUARDED.values()),
          ("guarded kernels not launched", counts))
    say("  six BMMCs and the sort bit-equal to their unguarded calls; "
        "traps 0, fallbacks 0, breaker closed")

    # guarded and unguarded calls in turns: one call and device time
    timed = (lambda fn: cuda_ms(torch, fn, reps))
    for name, b, _ in cases:
        def gcall(b=b):
            with guard.guarded():
                return ops.bmmc_permute(x, b)
        turns = in_turns({"guarded": gcall,
                          "unguarded": lambda b=b: ops.bmmc_permute(x, b)},
                         timed)
        gm, um = (statistics.median(turns[k]) for k in ("guarded",
                                                        "unguarded"))
        say(f"  {name:17s} one call: guarded {gm:.3f} ms, unguarded "
            f"{um:.3f} ms (in turns; the guarded call reads its flag "
            f"word back), overhead {100 * (gm / um - 1):+.2f} %")

    def gsort():
        with guard.guarded():
            return f(xs)
    turns = in_turns({"guarded": gsort, "unguarded": lambda: f(xs)}, timed)
    gm, um = (statistics.median(turns[k]) for k in ("guarded", "unguarded"))
    say(f"  sort 2^{n_sort} int32 one call (CUDA graphs): guarded {gm:.3f} "
        f"ms, unguarded {um:.3f} ms (in turns), overhead "
        f"{100 * (gm / um - 1):+.2f} %")
    del want
    torch.cuda.empty_cache()

    # each guarded kernel against its unguarded kernel and its plain
    # version, bit for bit, timed in turns (one call, device time)
    out = {}
    nbytes = x.numel() * 4
    for c in guarded_kernel_cases(torch, n, x):
        pflags = torch.zeros_like(c.flags)
        c.flags.zero_()
        got, ung = c.guarded(), c.unguarded()
        err = max(max_abs_err(torch, got, ung),
                  max_abs_err(torch, got, c.plain(pflags)))
        check(err == 0.0 and int(c.flags.item()) == 0
              and int(pflags.item()) == 0, (c.name, err))
        del got, ung
        turns = in_turns({"guarded": c.guarded, "unguarded": c.unguarded},
                         timed)
        gm, um = (statistics.median(turns[k]) for k in ("guarded",
                                                        "unguarded"))
        dturns = in_turns({"guarded": c.guarded, "unguarded": c.unguarded},
                          lambda fn: device_ms(torch, fn), rounds=1)
        gd, ud = (statistics.median(dturns[k]) for k in ("guarded",
                                                         "unguarded"))
        plain_ms = cuda_ms(torch, lambda: c.plain(pflags),
                           max(3, reps // 3), warmup=1)
        tab_bytes = sum(a.numel() * 4 for a in c.tabs)
        g = GUARDED[c.name]
        out[g] = {"ms": gm, "device_ms": gd, "plain_ms": plain_ms,
                  "bound_ms": (2 * nbytes + tab_bytes) / bw * 1e3,
                  "library_ms": records[c.name]["library_ms"],
                  "max_abs_err": err}
        say(f"  {g}: bit-equal to {c.name} and to its guarded plain "
            f"version; one call {gm:.3f} ms vs unguarded {um:.3f} ms, "
            f"device {gd:.4f} ms vs {ud:.4f} ms (in turns), guarded plain "
            f"{plain_ms:.3f} ms")
        torch.cuda.empty_cache()

    # K4b at the largest 2^n_sort sort cluster (phase 6's)
    tf = ops.choose_tile(n_sort, 4)
    fs = max(fused_cases(n_sort, tf, "sort"), key=lambda s: len(s.computes))
    plans, entries = ex._fused_plan_cached(fs, tf)
    tabs, epi = ex._pass_tables(plans[0], entries, xs)
    geo = K.plan_geometry(plans[0])
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    g = (lambda: K.tiled_permute_tables(xs, *tabs, geometry=geo,
                                        flags=flags, **epi))
    u = (lambda: K.tiled_permute_tables(xs, *tabs, geometry=geo, **epi))
    pl = (lambda: K.tiled_permute_tables_plain(xs, *tabs, geometry=geo,
                                               flags=flags, **epi))
    got = g()
    err = max(max_abs_err(torch, got, u()), max_abs_err(torch, got, pl()))
    check(err == 0.0 and int(flags.item()) == 0, ("tile_fused_guarded", err))
    turns = in_turns({"guarded": g, "unguarded": u}, timed)
    gm, um = (statistics.median(turns[k]) for k in ("guarded", "unguarded"))
    dturns = in_turns({"guarded": g, "unguarded": u},
                      lambda fn: device_ms(torch, fn), rounds=1)
    gd, ud = (statistics.median(dturns[k]) for k in ("guarded",
                                                     "unguarded"))
    plain_ms = cuda_ms(torch, pl, max(3, reps // 3), warmup=1)
    rec = records["tile_fused"]
    out["tile_fused_guarded"] = {
        "ms": gm, "device_ms": gd, "plain_ms": plain_ms,
        "bound_ms": rec["bound_ms"], "library_ms": rec["library_ms"],
        "max_abs_err": err}
    say(f"  tile_fused_guarded (largest 2^{n_sort} int32 sort cluster, "
        f"{len(fs.computes)} cmp epilogues): bit-equal to tile_fused and to "
        f"its guarded plain version; one call {gm:.4f} ms vs unguarded "
        f"{um:.4f} ms, device {gd:.4f} ms vs {ud:.4f} ms (in turns), "
        f"guarded plain {plain_ms:.3f} ms")
    say(f"  clocks, power, temperature: {clocks()}")
    torch.cuda.empty_cache()
    return counts, out, hashes


def phase_traps(torch, n: int):
    """Phase 12: poisoned tables on the card at 2^n."""
    say(f"== phase 12: traps on the card (2^{n} int32) ==")
    from repro_torch import guard, resilience
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import sort as S
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.guard import inject
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    x = torch.randint(0, 1 << 30, (1 << n,), device=dev, dtype=torch.int32,
                      generator=torch.Generator(device=dev).manual_seed(5))
    ex.clear_caches()
    for c in guarded_kernel_cases(torch, n, x):
        clean = c.unguarded()
        for ti, tname in enumerate(TABLE_NAMES[c.name]):
            for value in (1 << 30, -1):
                pflags = torch.zeros_like(c.flags)
                with inject.poison_device_table(c.plan, dev, index=0,
                                                table=ti, value=value):
                    c.flags.zero_()
                    got = c.guarded()
                    want = c.plain(pflags)
                    bit, pbit = int(c.flags.item()), int(pflags.item())
                    check(bit == 1 and pbit == 1, (c.name, tname, value,
                                                   bit, pbit))
                    if tname != "out_rows":   # an unwritten row is undefined
                        check(torch.equal(got, want), (c.name, tname, value))
                # the next unguarded launch: no sticky error
                again = c.unguarded()
                torch.cuda.synchronize()
                check(torch.equal(again, clean), (c.name, "after the trap"))
        say(f"  {GUARDED[c.name]}: an entry of {'/'.join(TABLE_NAMES[c.name])} "
            f"set to 2^30 or -1 on the card sets bit 1, as the guarded plain "
            f"version does (outputs equal where defined); the next unguarded "
            f"launch succeeds, bit-equal")
        del clean, got, want, again
    # K4b: a poisoned src0 of a sort cluster's pass, on the card only
    t = ops.choose_tile(n, 4)
    fs = max(fused_cases(n, t, "sort"), key=lambda s: len(s.computes))
    plans, entries = ex._fused_plan_cached(fs, t)
    tabs, epi = ex._pass_tables(plans[0], entries, x)
    geo = K.plan_geometry(plans[0])
    clean = K.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    with inject.poison_device_table(plans[0], dev):
        got = K.tiled_permute_tables(x, *tabs, geometry=geo, flags=flags,
                                     **epi)
        pflags = torch.zeros_like(flags)
        pw = K.tiled_permute_tables_plain(x, *tabs, geometry=geo,
                                          flags=pflags, **epi)
        check(int(flags.item()) == 1 and int(pflags.item()) == 1
              and torch.equal(got, pw), "tile_fused_guarded trap")
    again = K.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    torch.cuda.synchronize()
    check(torch.equal(again, clean), "tile_fused after the trap")
    say("  tile_fused_guarded: a poisoned src0 entry of a sort cluster sets "
        "bit 1 (as its guarded plain version does); the next unguarded "
        "launch succeeds, bit-equal")

    # through the entry points: the cuda -> ref fallback
    b = Bmmc.bit_reverse(n)
    oracle = ref.bmmc_ref_device(x, b)
    guard.reset_stats()
    resilience.reset()
    with guard.guarded():
        ops.bmmc_permute(x, b)
        with inject.poison_plan(b, t):
            check(torch.equal(ops.bmmc_permute(x, b), oracle),
                  "host-poisoned plan: fallback")
        plan = ops.class_plan(b, t)[1][0]
        with inject.poison_device_table(plan, dev):
            check(torch.equal(ops.bmmc_permute(x, b), oracle),
                  "device-poisoned plan: fallback")
        ns = min(N_MATRIX, n)   # the ref fallback runs a sort stage by stage
        xs = x[:1 << ns]
        f = S.compiled_sort(ns)
        ts = ops.choose_tile(ns, 4)
        want_sort = torch.sort(xs).values
        check(torch.equal(f(xs), want_sort), "guarded sort")
        fs0 = next(s for s in f.clustered_program(ns, ts)
                   if getattr(s, "computes", ()))
        with inject.poison_device_table(
                ex._fused_plan_cached(fs0, ts)[0][0], dev):
            check(torch.equal(f(xs), want_sort), "poisoned sort: fallback")
    st = guard.stats()
    # a skipped access may also show in the parity sample (bit 4)
    check(st["traps"].get(("oob", "cuda")) == 3
          and {k for k, _ in st["traps"]} <= {"oob", "parity"}
          and st["fallbacks"] == {"ref": 3} and st["recovered"] == 3,
          ("fallback stats", st))
    say(f"  guarded bmmc_permute at 2^{n} with a poisoned plan (the host "
        f"table, then the card's copy only) and the guarded sort of 2^{ns} "
        f"with a poisoned K4b table on the card: each traps on the card, "
        f"falls back to ref and equals the oracle; guard stats {st}")
    with guard.guarded(), inject.poison_ref_table(b):
        try:
            ops.bmmc_permute(x, b, engine="ref")
            check(False, "a poisoned ref table did not raise")
        except (guard.GuardTrap, guard.CachePoisoned) as e:
            say(f"  guarded ref with a poisoned gather table raises "
                f"{type(e).__name__} (no crash)")
    check(torch.equal(ops.bmmc_permute(x, b), oracle), "after the ref trap")
    torch.cuda.synchronize()
    say("  the next unguarded launches succeed: no sticky error")
    ex.clear_caches()
    torch.cuda.empty_cache()


def store_child(args) -> int:
    """Phase 13's subprocess: drive the six 2^n BMMCs, the 2^n_sort sort
    and its float32 gradient against the store at ``args.store_child``;
    write first-call latencies, output hashes and store stats as JSON."""
    import torch
    from repro_torch import store
    from repro_torch.combinators import sort as S
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    store.configure(args.store_child)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-2**31, 2**31 - 1, (1 << args.n,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    xs = torch.randint(-2**31, 2**31 - 1, (1 << args.n_sort,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    rec = {"first_s": {}, "plans_s": {}, "warm_s": {}, "hash": {}}

    def timed(name, fn, plans=None):
        """The first call (its plans built or loaded by ``plans`` first,
        timed on their own, when given) and a second, warm call."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plans is not None:
            plans()
            rec["plans_s"][name] = time.perf_counter() - t0
        y = fn()
        torch.cuda.synchronize()
        rec["first_s"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        rec["warm_s"][name] = time.perf_counter() - t0
        rec["hash"][name] = dev_hash(torch, y)

    t = ops.choose_tile(args.n, 4)
    for name, b, _ in make_cases(args.n, t):
        timed(name, lambda b=b: ops.bmmc_permute(x, b),
              lambda b=b: ops.class_plan(b, t))
    f = S.compiled_sort(args.n_sort)

    def sort_plans():
        t0 = time.perf_counter()
        f._resolve(xs, False)     # lowering and clustering: not stored
        rec["resolve_s"] = time.perf_counter() - t0
        plan_program(f, xs)
    timed("sort", lambda: f(xs), sort_plans)
    g = torch.Generator(device=dev).manual_seed(13)
    xf = (torch.randperm(1 << args.n_sort, generator=g, device=dev)
          .to(torch.float32) * 0.5 - 7.0)
    w = torch.randn(1 << args.n_sort, generator=g, device=dev)

    def grad():
        v = xf.clone().requires_grad_()
        (w * S.sort(v)).sum().backward()
        return v.grad
    timed("sort_grad", grad)
    rec["stats"] = store.stats()
    st = store.active()
    rec["entries"] = st.entry_count()
    rec["bytes"] = sum(p.stat().st_size
                       for p in Path(st.objects).rglob("*.plan"))
    Path(args.child_out).write_text(json.dumps(rec))
    return 0


def phase_store(torch, n: int, n_sort: int, hashes: dict):
    """Phase 13: a store populated by one process and replayed by a fresh
    one; then the disk-fault matrix."""
    say(f"== phase 13: store warm start (six 2^{n} BMMCs, sort of "
        f"2^{n_sort}, its float32 gradient) ==")
    import tempfile
    from repro_torch.guard import inject
    root = tempfile.mkdtemp(prefix="repro-torch-store-")
    got = []
    for label in ("cold", "disk-warm"):
        out = Path(root) / f"{label}.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--store-child",
             str(Path(root) / "store"), "--child-out", str(out), "--n",
             str(n), "--n-sort", str(n_sort)], capture_output=True, text=True)
        check(proc.returncode == 0, (label, proc.stdout[-3000:],
                                     proc.stderr[-3000:]))
        rec = json.loads(out.read_text())
        got.append(rec)
        say(f"  {label} process: {time.perf_counter() - t0:.1f} s in all; "
            f"store stats {rec['stats']}; {rec['entries']} entries, "
            f"{rec['bytes'] / 2**20:.1f} MiB on disk")
    cold, warm = got
    check(cold["stats"]["plan_built"] > 0 and cold["stats"]["write"] > 0,
          ("cold process", cold["stats"]))
    check(warm["stats"]["plan_built"] == 0 and warm["stats"]["miss"] == 0
          and warm["stats"]["hit"] > 0, ("disk-warm process built plans",
                                         warm["stats"]))
    check(cold["hash"] == warm["hash"], "outputs differ between processes")
    for name, h in hashes.items():
        check(cold["hash"][name] == h, (name, "differs from this process"))
    for name in cold["first_s"]:
        plans = ("" if name not in cold["plans_s"] else
                 f" (of which resolving and planning or loading plans "
                 f"{cold['plans_s'][name]:.3f} s, {warm['plans_s'][name]:.3f}"
                 f" s)")
        say(f"  {name:17s} first call: cold {cold['first_s'][name]:.3f} s, "
            f"disk-warm {warm['first_s'][name]:.3f} s{plans}; warm (second "
            f"call) {warm['warm_s'][name]:.4f} s")
    say(f"  sort: lowering and clustering {cold['resolve_s']:.3f} s cold, "
        f"{warm['resolve_s']:.3f} s disk-warm (the store keeps plans, not "
        f"programs)")
    say("  the disk-warm process built 0 plans, only hits; every output "
        "bit-equal to the cold process's (64-bit checksums) and to this "
        "process's")
    rep = inject.run_disk_fault_matrix(n=N_MATRIX, device="cuda")
    for c in rep["cases"]:
        say(f"  {c['kind']:22s} caught={c['caught']}  {c['how']}")
    check(rep["caught"] == rep["injected"] == 5, rep)
    import shutil
    shutil.rmtree(root, ignore_errors=True)


def phase_chaos(torch):
    """Phase 14: ring 3's fault matrix and the chaos soak on the card."""
    say("== phase 14: ring 3 and the chaos soak ==")
    from repro_torch.guard import inject
    from repro_torch.resilience import chaos
    rep = inject.run_fault_matrix("cuda", n=N_MATRIX, device="cuda")
    for c in rep["cases"]:
        say(f"  {c['kind']:22s} caught={c['caught']}  {c['how']}")
    check(rep["caught"] == rep["injected"] == len(inject.FAULT_KINDS)
          and not any("SILENT" in c["how"] for c in rep["cases"]), rep)
    say(f"  fault matrix at 2^{N_MATRIX}: {rep['caught']}/{rep['injected']} "
        f"caught, none silently wrong")
    for r in chaos.run_matrix(device="cuda"):
        say("  " + r.summary())
        check(r.passed and r.silent_wrong == 0
              and r.traps_while_open == 0, r.summary())
    say("  every soak SLO met")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30,
                    help="log2 elements of the main path (paper: 30)")
    ap.add_argument("--n-sort", type=int, default=N_SORT,
                    help="log2 keys of the combinator path's sort")
    ap.add_argument("--n-fft", type=int, default=N_FFT,
                    help="log2 points of the combinator path's FFT")
    ap.add_argument("--n-ties", type=int, default=N_TIES,
                    help="log2 keys of the gradient-route comparison")
    ap.add_argument("--n-perm", type=int, default=N_PERM,
                    help="log2 elements of the gradient's permutation chain")
    # phase 13 runs this script in fresh processes against one store
    ap.add_argument("--store-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.store_child:
        return store_child(args)

    smi = phase_env(torch)
    bw = peak_bw(torch.cuda.get_device_name(0))
    phase_build()
    records = phase_kernels(torch, N_SMALL, args.n, REPS, bw)
    counts = phase_main(torch, args.n, REPS, bw)

    phase_sweep(torch, args.n, REPS)
    records["tile_fused"] = phase_fused(torch, N_SMALL - 2, args.n_sort,
                                        args.n_fft, REPS, bw)
    comb = phase_combinators(torch, args.n_sort, args.n_fft, REPS)

    say("== phase 8: launch counts ==")
    missing = [k for k in PERM_KERNELS if counts.get(k, 0) <= 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    check(comb["tile_fused"] > 0, "tile_fused never launched on the "
          "combinator path")
    say(f"  main path (phase 4): {counts}")
    say(f"  combinator path (cold calls of the sort, the descending sort "
        f"and the FFT): {comb}")
    counts["tile_fused"] = comb["tile_fused"]

    records["tile_bwd"] = phase_bwd_kernel(torch, N_SMALL - 2, args.n_sort,
                                           args.n_fft, REPS, bw)
    counts["tile_bwd"] = phase_gradients(torch, args.n_sort, args.n_ties,
                                         args.n_fft, args.n_perm, REPS)
    check(counts["tile_bwd"] > 0, "tile_bwd never launched on the "
          "gradient path")
    say(f"  tile_bwd launches on the gradient path (the cold backwards of "
        f"the sort, tanh >> sort and the FFT): {counts['tile_bwd']}")

    g_counts, g_records, hashes = phase_guarded(torch, args.n, args.n_sort,
                                                REPS, bw, records)
    records.update(g_records)
    for name in GUARDED.values():
        counts[name] = g_counts[name]
    phase_traps(torch, min(N_FAULT, args.n))
    phase_store(torch, args.n, args.n_sort, hashes)
    phase_chaos(torch)
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r.get("device_ms"),
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
