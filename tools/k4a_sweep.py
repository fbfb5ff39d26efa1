#!/usr/bin/env python3
"""Time K4a's schedules against the K4a they replaced, K1 and
``index_select`` on one GPU.

    python3 tools/k4a_sweep.py                  # 2^30 int32, serving shapes
    python3 tools/k4a_sweep.py --n 24 --rounds 1 --skip-serving

The A/B behind K4a's design (``src/repro_torch/kernels/csrc/
tile_permute.cu``; PERF.md, section 6). It builds ``tools/k4a_sweep.cu``
(the unguarded K4a as it was before its two schedules, ``k4a_old``; ``nvcc``
for ``sm_90a`` with the port's ``tile_common.cuh``) into ``build/sweep/``
and prints, after the card's name and power limit:

* **2^n int32** (default 2^30) for the four tiled classes of
  ``chip_smoke.py``'s main path (bit-reverse, random BPC, random BMMC,
  mixed complement, at ``ops.choose_tile``'s t): K1 (``copy_blocks``),
  the old K4a, K4a as the port runs it (``tiled_permute``) and the narrow
  schedule in each tile layout of the paper's §4.2 study (unpadded,
  padded, swizzled) with 1, 2, 3, 4 and 8 work items a block, each checked
  bit for bit against the old K4a and the plain gather, then timed in
  turns (one call, the median of ``--reps`` CUDA-event readings a turn);
  each line gives the copy ratio (K1's time / its time) and the time
  over the old K4a's;
* **the serving shapes** (the kv-head shuffle of Mistral-NeMo-12B's
  prefill: ``(2048, 8, 128)`` bfloat16 for k and v, ``(2048, 8, 512)``
  bfloat16 and float32; t = 1): ``index_select``, K4a through
  ``tiled_permute`` and through ``models.permute.permute_axis`` (what the
  prefill calls, on ``(4, 512, 8, d)``), and the old K4a behind the host
  path it had (tables checked and moved to the card, the launch arguments
  rebuilt and 17 passed to ``ctypes`` on every call), each bit for bit,
  timed in turns as one call and as device time (10 calls captured in one
  CUDA graph); and the host time a call of each layer of that path takes
  (``torch.empty_like``, the table lookup, the record path,
  ``tiled_permute``, ``bmmc_permute``, ``permute_axis``), beside
  ``index_select``'s;
* **the wide/narrow threshold**: device time of the narrow and the wide
  schedule forced on elements of 16 to 256 bytes, at the serving
  geometry (2048 batch rows of 8 elements, in L2) and at 2^20 float32
  elements with a tail (256 MiB a call, batch rows to match), in turns.

The timers are ``chip_smoke.py``'s own (``cuda_ms``, ``device_ms``,
``in_turns``). Imports torch and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_name("k4a_sweep.cu")
CLASSES = ("bit-reverse", "random-bpc", "random-bmmc", "mixed-complement")
GROUPS = (1, 2, 3, 4, 8)


def start_build(out_dir: Path):
    """Start ``nvcc`` on ``k4a_sweep.cu`` (returns what :func:`finish_build`
    waits for), so a caller can build it beside the port's kernels."""
    from repro_torch.kernels import build as B
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "k4a_sweep.so"
    cmd = [B.nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(lib),
           str(SRC)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_build(started) -> ctypes.CDLL:
    lib, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k4a_sweep: nvcc failed\n{log}")
    so = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.k4a_old.argtypes = [P] * 6 + [I] * 9 + [L, I, P]
    so.k4a_old.restype = I
    return so


def old_k4a(so, K):
    """The old K4a behind the host path it had: every call checks the four
    tables and moves them to the card (``_device_table``), rebuilds the
    launch arguments (``_tile_args``) and passes them to ``ctypes``."""
    def call(x, plan, batched=False):
        K._trap_tables(K._plan_traps(plan))
        xc = K._canonical(x, batched)
        n, t, rpt = plan.n, plan.t, plan.rows_per_tile
        n_tiles = plan.n_tiles
        tabs = K.device_tables(plan, x.device)
        tabs = tuple(K._device_table(a, x.device, k) for a, k in (
            (tabs[0], n_tiles * rpt), (tabs[1], n_tiles * rpt),
            (tabs[2], n_tiles), (tabs[3], rpt << t)))
        out, args = K._tile_args(xc, K.plan_geometry(plan))
        rc = so.k4a_old(K._ptr(xc), K._ptr(out), *(K._ptr(a) for a in tabs),
                        *args, K._stream(x))
        if rc:
            raise SystemExit(f"k4a_old: CUDA error {rc}")
        return out.reshape(x.shape)
    return call


def forced(torch, K, x, plan, *, batched=False, **over):
    """K4a on the schedule ``k4a_schedule`` gives with ``over`` (schedule,
    layout, groups), its descriptor built once."""
    from repro_torch.kernels import build as B
    xc = K._canonical(x, batched)
    tabs = K.device_tables(plan, x.device)
    geometry = K.plan_geometry(plan)
    s = K.k4a_schedule(geometry, xc.shape[0], xc.shape[2], x.element_size(),
                       x.data_ptr() | tabs[3].data_ptr(), **over)
    args = K._k4a_args(s, tabs, geometry, xc.shape[0])
    fn = B.load("tile")

    def call():
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), ctypes.addressof(args),
                K._stream(x))
        if rc:
            raise SystemExit(f"k4a {over}: CUDA error {rc}")
        return out
    return call, s


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``, ``calls`` calls queued without
    a wait (a synchronize before and after, outside the clock)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30, help="2^n int32 elements")
    ap.add_argument("--rounds", type=int, default=2,
                    help="turns each way (A, B, ..., B, A)")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls a turn (the median is the turn's reading)")
    ap.add_argument("--skip-serving", action="store_true")
    ap.add_argument("--skip-main", action="store_true")
    ap.add_argument("--build-dir", default=str(ROOT / "build" / "sweep"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import cuda_ms, device_ms, in_turns, make_cases
    import torch
    if not torch.cuda.is_available():
        print("k4a_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    so = finish_build(start_build(Path(args.build_dir)))
    old = old_k4a(so, K)
    dev = torch.device("cuda")

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))

    def report(title, one, base, ratio_of=None):
        med = {k: statistics.median(v) for k, v in one.items()}
        print(title, flush=True)
        for k in sorted(med, key=med.get):
            extra = (f"  copy ratio {med[ratio_of] / med[k]:.3f}"
                     if ratio_of else "")
            print(f"  {k:<34} {med[k]:.4f} ms ({min(one[k]):.4f}-"
                  f"{max(one[k]):.4f})  / {base}: {med[k] / med[base]:.3f}"
                  f"{extra}", flush=True)

    if not args.skip_main:
        n = args.n
        t = ops.choose_tile(n, 4)
        x = torch.randint(-2**31, 2**31 - 1, (1 << n,), device=dev,
                          dtype=torch.int32)
        for name, b, _ in make_cases(n, t):
            if name not in CLASSES:
                continue
            kernel, plans = ops.class_plan(b, t)
            (plan,) = plans
            want = old(x, plan)
            check = ref.bmmc_ref_device(x, b)
            if not same(want, check):
                print(f"{name}: the old K4a disagrees with the gather")
                return 1
            del check
            fns = {"K1 copy": lambda: K.copy_blocks(x),
                   "K4a old": lambda: old(x, plan),
                   "K4a (tiled_permute)": lambda: K.tiled_permute(x, plan)}
            for layout in K.K4A_LAYOUTS:
                for g in GROUPS:
                    fn, s = forced(torch, K, x, plan, schedule="narrow",
                                   layout=layout, groups=g)
                    fns[f"narrow {s.layout} x{g}"] = fn
            for k, fn in fns.items():
                if k != "K1 copy":
                    got = fn()
                    if not same(got, want):
                        print(f"2^{n} {name} {k}: WRONG", flush=True)
                        return 1
                    del got
            torch.cuda.synchronize()
            s = K.k4a_record(x, plan).schedule
            one = in_turns(fns, lambda fn: cuda_ms(torch, fn, args.reps),
                           args.rounds)
            report(f"2^{n} int32 {name} (t={t}, rows/tile "
                   f"{plan.rows_per_tile}, port: {s.schedule} {s.layout} "
                   f"x{s.groups}, vec {s.vec}), one call:", one, "K4a old",
                   "K1 copy")
            del want
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()

    if not args.skip_serving:
        from repro_torch.models.attention import default_head_perm
        from repro_torch.models.permute import permute_axis
        hp = default_head_perm(8)
        idx = ref.bmmc_src_index(hp, dev)
        gen = torch.Generator(device=dev).manual_seed(15)
        for d, dtype in ((128, torch.bfloat16), (512, torch.bfloat16),
                         (512, torch.float32)):
            x4 = torch.randn((4, 512, 8, d), generator=gen,
                             device=dev).to(dtype)
            x = x4.reshape(2048, 8, d)
            t = ops.choose_tile(hp.n, x.element_size(), d)
            (plan,) = ops.class_plan(hp, t)[1]
            want = torch.index_select(x, 1, idx)
            fns = {"index_select": lambda: torch.index_select(x, 1, idx),
                   "K4a (tiled_permute)": lambda: K.tiled_permute(
                       x, plan, batched=True),
                   "K4a (permute_axis)": lambda: permute_axis(
                       x4, hp, axis=2, engine="cuda"),
                   "K4a old": lambda: old(x, plan, batched=True)}
            for k, fn in fns.items():
                if not same(fn().reshape(want.shape), want):
                    print(f"serving {tuple(x.shape)} {dtype} {k}: WRONG")
                    return 1
            s = K.k4a_record(x, plan, batched=True).schedule
            one = in_turns(fns, lambda fn: cuda_ms(torch, fn, args.reps),
                           args.rounds)
            report(f"serving {tuple(x.shape)} {str(dtype)[6:]} (t={t}, "
                   f"{s.schedule}, {s.per_cta} elements x {s.groups} batch "
                   f"rows a block), one call:", one, "index_select")
            devt = in_turns(fns, lambda fn: device_ms(torch, fn), 1)
            report("  device (10 calls in one CUDA graph):", devt,
                   "index_select")
            # where a call's host time goes: host clock per call, 200
            # calls queued without a wait
            parts = {"torch.empty_like": lambda: torch.empty_like(x),
                     "device-table lookup": lambda: K._launch_tables(
                         plan, x.device),
                     "record path (_k4a_call)": lambda: K._k4a_call(
                         x, plan, True),
                     "tiled_permute": lambda: K.tiled_permute(
                         x, plan, batched=True),
                     "ops.bmmc_permute": lambda: ops.bmmc_permute(
                         x, hp, batched=True),
                     "permute_axis": lambda: permute_axis(x4, hp, axis=2,
                                                          engine="cuda"),
                     "index_select": lambda: torch.index_select(x, 1, idx)}
            host = in_turns(parts, lambda fn: host_us(torch, fn), 1)
            print("  host us a call (200 queued): " + ", ".join(
                f"{k} {statistics.median(v):.1f}" for k, v in host.items()),
                flush=True)
        # where the wide schedule starts to win
        for label, n, dtype, ds, total in (
                ("serving geometry, 2048 x 8", 3, torch.bfloat16,
                 (8, 16, 32, 64, 128), None),
                ("2^20 float32 with a tail, 256 MiB", 20, torch.float32,
                 (4, 8, 16, 32, 64), 1 << 28)):
            b = hp if n == 3 else make_cases(n, 3)[0][1]
            for d in ds:
                size = torch.tensor([], dtype=dtype).element_size()
                batch = 2048 if total is None else total // (
                    (size * d) << n)
                x = torch.randn((batch, 1 << n, d), device=dev).to(dtype)
                t = ops.choose_tile(n, size, d)
                plan = ops.class_plan(b, t)[1][0]
                fns = {}
                for sched in ("narrow", "wide"):
                    fns[sched], _ = forced(torch, K, x, plan, batched=True,
                                           schedule=sched)
                if not same(fns["narrow"](), fns["wide"]()):
                    print(f"threshold {label} d={d}: WRONG")
                    return 1
                devt = in_turns(fns, lambda fn: device_ms(torch, fn),
                                args.rounds)
                med = {k: statistics.median(v) for k, v in devt.items()}
                print(f"threshold, {label}, {d * size}-byte elements x "
                      f"{batch} batch rows (t={t}): device narrow "
                      f"{med['narrow']:.4f} ms, wide {med['wide']:.4f} ms",
                      flush=True)
                del x, fns
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
