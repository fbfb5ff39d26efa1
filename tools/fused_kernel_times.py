#!/usr/bin/env python3
"""Time the tiled kernels K4a, K4b and K5 of a checkout on one GPU.

    python3 tools/fused_kernel_times.py                  # this checkout
    python3 tools/fused_kernel_times.py --src OTHER/src --tag parent

For the checkout whose ``src/`` is given (its ``repro_torch`` is imported
from there, and its kernels build into ``--build-dir``), prints:

* each kernel instantiation's registers (ptxas);
* the cold 2^24 float32 sort gradient (host seconds of one forward +
  backward after ``clear_caches()``, telemetry on, as ``chip_smoke.py``
  phase 10 takes it), and the host seconds of it spent building K4b's
  and K5's epilogue descriptors or plans;
* on the largest cluster of the 2^24 sort (t = 6, 12 compare
  epilogues): K4a (the same pass without epilogues, int32), K4b on int32
  and on float32 keys, and K5 on float32 keys from 2^16 values (ties),
  each as the time of one call (CUDA events around the Python call, so
  the host's launch path included), as device time (10 calls captured
  in one CUDA graph, replayed) and as the host's launch path alone (host
  clock per call over 50 calls queued without a wait);
* the device time of K4b and K5 summed over all 39 sort clusters;
* the device time of K4b and K5 on the 2^22 FFT's butterfly cluster;
* in a checkout with map epilogues, the device time of the map
  clusters of ``not >> sort >> not`` (K4b, int32) and of ``tanh >>
  sort`` (K4b and K5, float32) at 2^24, each beside the same pass
  without the map (K4a on its plan, or the sort's own cluster), and the
  sums over all clusters of the two programs;
* forward + backward of the 2^24 float32 sort and of the 2^22 planar
  FFT through the entry points (``(w * f(x)).sum().backward()``);
* in a checkout with K4b's and K5's work-item schedules, their A/B
  against the kernels before those schedules (``tools/fused_ab.py``,
  built from this checkout's ``tools/fused_ab.cu``), in turns (old, new,
  new, old): the largest sort cluster (K4b int32 and float32, K5 float32
  and bfloat16; one call and device time) and the device time summed
  over all 39 sort clusters (K4b int32 and float32, K5 float32 and
  bfloat16), over the FFT's butterfly cluster and over the map clusters
  of ``not >> sort >> not`` (K4b) and ``tanh >> sort`` (K5), each side
  held bit for bit against the other.

The timers are ``chip_smoke.py``'s own (``cuda_ms``, ``device_ms``). Two
checkouts compare only within one run on one card: run them in turns
(parent, change, change, parent). Imports torch, numpy and the checkout's
``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="this", help="label of each line")
    ap.add_argument("--build-dir", default=None,
                    help="where its kernels build (REPRO_TORCH_BUILD_DIR)")
    args = ap.parse_args(argv)
    if args.build_dir:
        os.environ["REPRO_TORCH_BUILD_DIR"] = args.build_dir
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_ms
    sys.path.insert(0, args.src)       # ahead of the path chip_smoke adds
    import torch
    if not torch.cuda.is_available():
        print("fused_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.combinators import FusedStage, clear_caches, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.combinators.fft import fft_expr
    from repro_torch.combinators.sort import sort_expr
    from repro_torch.kernels import bmmc_permute as pk
    from repro_torch.kernels import build

    tag = args.tag
    say = (lambda *a: print(tag, *a, flush=True))
    t0 = time.perf_counter()
    log = build.build_all()
    say(f"build {time.perf_counter() - t0:.1f} s")
    for k in ("tile", "tile_fused", "tile_bwd"):
        if k in log:         # absent when built by an earlier run
            regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                           for ln in log[k]["ptxas"].splitlines()
                           if "Used" in ln})
            say(f"{k} registers: {regs}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)

    # host seconds spent in the epilogue descriptors (before the register
    # epilogues) or plans (since): the function each launch calls
    spent = {"s": 0.0, "calls": 0}
    name = ("_epi_plan_tensor" if hasattr(pk, "_epi_plan_tensor")
            else "_epi_desc_tensor")
    inner = getattr(pk, name)

    def timed(*a, **kw):
        t1 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            spent["s"] += time.perf_counter() - t1
            spent["calls"] += 1
    setattr(pk, name, timed)

    def launch_path_ms(fn, reps=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t1) / reps * 1e3
        torch.cuda.synchronize()
        return host

    def grad_once(f, x, w):
        xt = x.clone().requires_grad_(True)
        (w * f(xt)).sum().backward()
        torch.cuda.synchronize()

    # every kernel module loaded first, at a small size
    n = 12
    grad_once(S.compiled_sort(n), torch.randperm(1 << n, device=dev).float(),
              torch.randn(1 << n, device=dev))
    n = 24
    xs = torch.randperm(1 << n, generator=gen, device=dev).float()
    ws = torch.randn(1 << n, generator=gen, device=dev)
    fsort = S.compiled_sort(n)
    clear_caches()
    spent.update(s=0.0, calls=0)
    obs.enable(sync=True)
    t0 = time.perf_counter()
    try:
        grad_once(fsort, xs, ws)
    finally:
        obs.disable()
    cold = time.perf_counter() - t0
    obs.reset()
    say(f"cold 2^24 sort gradient {cold:.3f} s, of which {name} "
        f"{spent['s']:.3f} s over {spent['calls']} calls")
    setattr(pk, name, inner)

    t = 6
    fss = [s for s in compile_expr(sort_expr(n)).clustered_program(n, t)
           if isinstance(s, FusedStage) and s.computes]
    fs = max(fss, key=lambda s: len(s.computes))
    xi = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    xf = torch.randint(0, 1 << 16, (1 << n,), generator=gen,
                       device=dev).float()
    ct = torch.randn(1 << n, generator=gen, device=dev)
    plan0 = ex._fused_plan_cached(fs, t)[0][0]
    cases = {"K4a int32": lambda: pk.tiled_permute(xi, plan0),
             "K4b int32": lambda: ex._fused_cuda(xi, fs, t),
             "K4b float32": lambda: ex._fused_cuda(xf, fs, t),
             "K5 float32": lambda: ex._fused_bwd_cuda(fs, t, False, xf, ct)}
    for label, fn in cases.items():
        say(f"2^24 largest sort cluster {label}: one call "
            f"{cuda_ms(torch, fn, 20, warmup=3):.4f} ms, device "
            f"{device_ms(torch, fn):.4f} ms, host launch path "
            f"{launch_path_ms(fn):.4f} ms")
    k4 = sum(device_ms(torch, lambda s=s: ex._fused_cuda(xi, s, t), 5)
             for s in fss)
    k5 = sum(device_ms(torch, lambda s=s: ex._fused_bwd_cuda(
        s, t, False, xf, ct), 5) for s in fss)
    say(f"all {len(fss)} sort clusters, device: K4b int32 {k4:.3f} ms, "
        f"K5 float32 {k5:.3f} ms")
    nf, tf = 22, 5
    (ff,) = [s for s in compile_expr(fft_expr(nf)).clustered_program(nf, tf)
             if isinstance(s, FusedStage) and s.computes]
    xp = torch.randn(1 << nf, 2, generator=gen, device=dev)
    cp = torch.randn(1 << nf, 2, generator=gen, device=dev)
    f4 = device_ms(torch, lambda: ex._fused_cuda(xp, ff, tf))
    f5 = device_ms(torch, lambda: ex._fused_bwd_cuda(ff, tf, False, xp, cp))
    say(f"2^22 FFT cluster, device: K4b {f4:.4f} ms, K5 {f5:.4f} ms")

    if hasattr(ex, "_maps_lowered"):   # a checkout with map epilogues
        from repro_torch.combinators import vocab as V

        def clusters_of(expr):
            return [s for s in compile_expr(expr).clustered_program(n, t)
                    if isinstance(s, FusedStage) and s.computes]
        nots = clusters_of(V.emap("not", torch.bitwise_not) >> sort_expr(n)
                           >> V.emap("not", torch.bitwise_not))
        tanhs = clusters_of(V.emap("tanh", torch.tanh) >> sort_expr(n))
        first, last = nots[0], nots[-1]
        p_first = ex._fused_plan_cached(first, t)[0][0]
        say(f"2^24 map cluster of not (alone, before the first perm), "
            f"device: K4b int32 "
            f"{device_ms(torch, lambda: ex._fused_cuda(xi, first, t)):.4f}"
            f" ms, the same pass without the map (K4a) "
            f"{device_ms(torch, lambda: pk.tiled_permute(xi, p_first)):.4f}"
            f" ms")
        say(f"2^24 last sort cluster with not appended ({len(last.computes)}"
            f" epilogues), device: K4b int32 "
            f"{device_ms(torch, lambda: ex._fused_cuda(xi, last, t)):.4f} ms"
            f", the sort's own last cluster "
            f"{device_ms(torch, lambda: ex._fused_cuda(xi, fss[-1], t)):.4f}"
            f" ms")
        tf = tanhs[0]
        xs_t = (xs - (1 << (n - 1))) / (1 << n)
        p_tf = ex._fused_plan_cached(tf, t)[0][0]
        k5_tf = device_ms(torch, lambda: ex._fused_bwd_cuda(
            tf, t, False, xs_t, ct))
        say(f"2^24 map cluster of tanh, device: K4b float32 "
            f"{device_ms(torch, lambda: ex._fused_cuda(xs_t, tf, t)):.4f} "
            f"ms, K5 float32 {k5_tf:.4f} ms, the same pass without the map "
            f"(K4a) "
            f"{device_ms(torch, lambda: pk.tiled_permute(xs_t, p_tf)):.4f} "
            f"ms")
        k4m = sum(device_ms(torch, lambda s=s: ex._fused_cuda(xi, s, t), 5)
                  for s in nots)
        k5m = sum(device_ms(torch, lambda s=s: ex._fused_bwd_cuda(
            s, t, False, xs_t, ct), 5) for s in tanhs)
        say(f"all {len(nots)} clusters of not >> sort >> not, device: K4b "
            f"int32 {k4m:.3f} ms; all {len(tanhs)} clusters of tanh >> "
            f"sort: K5 float32 {k5m:.3f} ms")

    wp = torch.randn(1 << nf, 2, generator=gen, device=dev)
    fft = F.compiled_fft(nf)
    for label, f, x, w in (("2^24 sort", fsort, xs, ws),
                           ("2^22 FFT", fft, xp, wp)):
        xt = x.clone().requires_grad_(True)

        def fwd_bwd():
            xt.grad = None
            (w * f(xt)).sum().backward()
        say(f"{label} forward + backward: "
            f"{cuda_ms(torch, fwd_bwd, 20, warmup=3):.3f} ms")

    if hasattr(pk, "k4b_schedule"):    # a checkout with the schedules
        ab_turns(torch, say, fss, t, n, xi, xf, ct, ff, 5, xp, cp)
    return 0


def ab_turns(torch, say, fss, t, n, xi, xf, ct, ff, tf, xp, cp):
    """The A/B of the work-item schedules (see the module docstring)."""
    import statistics
    sys.path.insert(0, str(ROOT / "tools"))
    import fused_ab
    from chip_smoke import cuda_ms, device_ms, in_turns
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.sort import sort_expr
    from repro_torch.kernels import build
    so, ab_log = fused_ab.finish_build(fused_ab.start_build(
        build.build_dir().parent / "sweep"))
    for name, u in fused_ab.usage(ab_log, "old_kernel"):
        say(f"old {name}: {u}")

    def turns(pairs, timer):
        """{side: [readings]} of the summed ``timer`` over ``pairs`` of
        (old, new) calls, old, new, new, old."""
        return in_turns({"old": lambda: sum(timer(o) for o, _ in pairs),
                         "new": lambda: sum(timer(w) for _, w in pairs)},
                        lambda f: f())

    def calls(clusters, x, c=None, tt=None):
        got = []
        for fs in clusters:
            old, new, _, s = fused_ab.cluster_calls(so, fs, tt or t, x, c)
            a, b = old(), new()
            if not torch.equal(a.view(torch.int16 if a.element_size() == 2
                                      else torch.int32),
                               b.view(torch.int16 if b.element_size() == 2
                                      else torch.int32)):
                raise SystemExit("fused_kernel_times: old and new differ")
            got.append((old, new))
        return got, s

    fs = max(fss, key=lambda s: len(s.computes))
    xb, cb = xf.bfloat16(), ct.bfloat16()
    cases = (("K4b int32", xi, None), ("K4b float32", xf, None),
             ("K5 float32", xf, ct), ("K5 bfloat16", xb, cb))
    for label, x, c in cases:
        pairs, s = calls([fs], x, c)
        one = turns(pairs, lambda f: cuda_ms(torch, f, 20, warmup=3))
        devt = turns(pairs, lambda f: device_ms(torch, f))
        say(f"A/B 2^{n} largest sort cluster {label} "
            f"({fused_ab.schedule_text(s)}): one call old {one['old']} new "
            f"{one['new']} ms; device old {devt['old']} new {devt['new']} "
            f"ms (medians {statistics.median(devt['old']):.4f} / "
            f"{statistics.median(devt['new']):.4f})")
    for label, x, c in cases:
        pairs, _ = calls(fss, x, c)
        devt = turns(pairs, lambda f: device_ms(torch, f, 5))
        say(f"A/B all {len(fss)} sort clusters {label}, device summed: old "
            f"{devt['old']} new {devt['new']} ms")
    for label, c in (("K4b", None), ("K5", cp)):
        pairs, s = calls([ff], xp, c, tf)
        devt = turns(pairs, lambda f: device_ms(torch, f))
        say(f"A/B 2^22 FFT cluster {label} ({fused_ab.schedule_text(s)}): "
            f"device old {devt['old']} new {devt['new']} ms")

    def clusters_of(expr):
        return [s for s in compile_expr(expr).clustered_program(n, t)
                if isinstance(s, FusedStage) and s.computes]
    nots = clusters_of(V.emap("not", torch.bitwise_not) >> sort_expr(n)
                       >> V.emap("not", torch.bitwise_not))
    tanhs = clusters_of(V.emap("tanh", torch.tanh) >> sort_expr(n))
    xs_t = (xf - (1 << (n - 1))) / (1 << n)
    for label, clusters, x, c in (
            ("not >> sort >> not, K4b int32", nots, xi, None),
            ("tanh >> sort, K5 float32", tanhs, xs_t, ct)):
        pairs, _ = calls(clusters, x, c)
        devt = turns(pairs, lambda f: device_ms(torch, f, 5))
        say(f"A/B all {len(clusters)} clusters of {label}, device summed: "
            f"old {devt['old']} new {devt['new']} ms")


if __name__ == "__main__":
    sys.exit(main())
