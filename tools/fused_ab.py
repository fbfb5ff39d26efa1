#!/usr/bin/env python3
"""The A/B reference of K4b, K5 and the guarded K4b: the kernels as they
were before their work-item schedules, built from ``tools/fused_ab.cu``,
and their callers.

    python3 tools/fused_ab.py [--n 24] [--guarded-only] [--wide]

Run as a script on a card, it builds the reference beside the port's
kernels, holds old and new K4b (int32, float32) and K5 (float32,
bfloat16) bit for bit against each other and their plain versions on the
largest cluster of the 2^n sort, and times them in turns (one call and
device time), with each side's registers (ptxas) and the new side's
schedule; then the new K4b and K5 at 1, 2, 3 and 4 work items a block.
Then the guarded K4b (int32, float32, bfloat16): old guarded, new guarded
and the unguarded K4b bit for bit against each other and the guarded
plain version with no flag set, timed in turns on the largest cluster
(one call and device time) and summed over all the sort's clusters
(device time), and the new guarded K4b at 2, 3 and 4 blocks an SM.
With ``--wide``, only the 64-bit classes: K4b on int64, uint64 and
float64 keys on the largest cluster of the 2^n sort and on planar float64
on the largest cluster of the 2^(n-2) FFT, K5 on float64 on both, each
held bit for bit against its plain version and timed (device time) as the
port launches it and at each blocks-an-SM value of the sweep.
``chip_smoke.py`` (phases 2, 6, 9 and 11) and
``tools/fused_kernel_times.py`` import the helpers below. Imports torch
and ``repro_torch`` only; the timers are ``chip_smoke.py``'s
(``cuda_ms``, ``device_ms``, ``in_turns``).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_name("fused_ab.cu")


def start_build(out_dir: Path, wide: bool = False):
    """Start ``nvcc`` on ``fused_ab.cu`` (returns what :func:`finish_build`
    waits for), so a caller can build it beside the port's kernels;
    ``wide`` adds the 64-bit classes' sweep (``REPRO_WIDE_SWEEP``)."""
    from repro_torch.kernels import build as B
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / ("fused_ab_wide.so" if wide else "fused_ab.so")
    cmd = [B.nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(lib),
           *(("-DREPRO_WIDE_SWEEP",) if wide else ()), str(SRC)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_build(started):
    """(the loaded library, nvcc's log with ptxas's usage lines)."""
    lib, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"fused_ab: nvcc failed\n{log}")
    so = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.k4b_old.argtypes = [P] * 7 + [I] * 10 + [L] + [I] * 6 + [P]
    so.k5_old.argtypes = [P] * 8 + [I] * 10 + [L] + [I] * 7 + [P]
    so.k4b_mb.argtypes = [P, P, P, I, P]
    so.k5_mb.argtypes = [P, P, P, P, I, P]
    so.k5_kr16.argtypes = [P, P, P, P, I, P]
    so.k4b_guarded_old.argtypes = [P] * 7 + [I] * 10 + [L] + [I] * 6 + [P, P]
    so.k4b_guarded_mb.argtypes = [P, P, P, P, I, P]
    if hasattr(so, "k4b_wide_mb"):   # built with REPRO_WIDE_SWEEP
        so.k4b_wide_mb.argtypes = [P, P, P, I, P]
        so.k5_wide_mb.argtypes = [P, P, P, P, I, P]
        so.k4b_wide_mb.restype = so.k5_wide_mb.restype = I
    so.k5_kr16.restype = I
    so.k4b_old.restype = so.k5_old.restype = I
    so.k4b_mb.restype = so.k5_mb.restype = I
    so.k4b_guarded_old.restype = so.k4b_guarded_mb.restype = I
    return so, log


def usage(log: str, marker: str) -> list:
    """Registers and spills of the kernels whose names hold ``marker``, from
    an ``nvcc -Xptxas -v`` log (chip_smoke.ptxas_usage)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_usage
    return [(k, u) for k, u in ptxas_usage(log) if marker in k]


def _old_args(K, EP, xc, geometry, entries, n_buf):
    """(out, arguments after the tables, plan tensor, dv) of the old K4b
    (``n_buf`` 1; the old guarded K4b's too) or K5 (2): a work item a
    block, words of the element type's width in rows padded by one 4-byte
    bank, compare-bit sets in shared memory from two on."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    size, d = xc.element_size(), xc.shape[2]
    pad = max(1, 4 // size)
    plan, dv = K._epi_plan(xc, geometry, entries, n_buf,
                           ((1 << t) * d + pad) * size)
    info = plan.info
    sets = info["groups"] << info["outer_bits"]
    spill = sets if sets > 1 else 0
    extra = (plan.numel() * 4 + 15) & ~15
    if n_buf > 1:
        extra += spill * dv * EP.THREADS * 4 << info["reg_bits"]
        extra += (info["map_slots"] * size * EP.THREADS
                  << (info["reg_bits"] + info["outer_bits"]))
    per_cta = K._epi_item(geometry, d * size)[0]
    rows = per_cta * rpt
    tile = rows * ((1 << t) * d + pad) * size
    if n_buf > 1:   # K5's second tile (the ct tile), 16-aligned
        extra += (tile + 15) & ~15
    smem = (((2 * rows + per_cta) * 4 + 15) & ~15) + tile + extra
    if smem > K._SMEM_MAX:
        raise ValueError(f"old kernel: {smem} bytes of shared memory")
    args = (n_tiles, 1 << (n - t), K._shift(rpt), per_cta, t, d,
            K._shift(d), K._shift((1 << t) * d), pad, xc.shape[0], size)
    return xc.new_empty(xc.shape), args, plan, dv, spill


def old_fused(so, K, EP, xc, tabs, geometry, entries):
    """One launch of the old K4b on ``xc`` (``(B, 2^n, d)``)."""
    out, args, plan, dv, _ = _old_args(K, EP, xc, geometry, entries, 1)
    info = plan.info
    rc = so.k4b_old(K._ptr(xc), K._ptr(out), *(K._ptr(a) for a in tabs),
                    K._ptr(plan), plan.numel(), *args,
                    K._ELEM_TYPE[xc.dtype], xc.shape[2], dv,
                    1 << info["reg_bits"], int(info["maps"] > 0),
                    K._stream(xc))
    if rc:
        raise SystemExit(f"k4b_old: CUDA error {rc}")
    return out


def old_guarded_fused(so, K, EP, xc, tabs, geometry, entries, flags):
    """One launch of the old guarded K4b on ``xc`` into ``flags``."""
    out, args, plan, dv, _ = _old_args(K, EP, xc, geometry, entries, 1)
    rc = so.k4b_guarded_old(K._ptr(xc), K._ptr(out),
                            *(K._ptr(a) for a in tabs), K._ptr(plan),
                            plan.numel(), *args, K._ELEM_TYPE[xc.dtype],
                            xc.shape[2], dv, 1 << plan.info["reg_bits"], 0,
                            K._ptr(flags), K._stream(xc))
    if rc:
        raise SystemExit(f"k4b_guarded_old: CUDA error {rc}")
    return out


def old_bwd(so, K, EP, xc, cc, tabs, geometry, entries):
    """One launch of the old K5 on saved input ``xc`` and cotangent ``cc``."""
    out, args, plan, dv, spill = _old_args(K, EP, xc, geometry, entries, 2)
    info = plan.info
    rc = so.k5_old(K._ptr(xc), K._ptr(out), K._ptr(cc),
                   *(K._ptr(a) for a in tabs), K._ptr(plan), plan.numel(),
                   *args, K._ELEM_TYPE[xc.dtype], xc.shape[2], dv,
                   int(info["groups"] > 0), spill,
                   info["map_slots"] << info["outer_bits"], K._stream(xc))
    if rc:
        raise SystemExit(f"k5_old: CUDA error {rc}")
    return out


def cluster_calls(so, fs, t, x, ct=None, groups=None, mb=None,
                  n_buf=None, flags=None):
    """(old, new, plain, schedule) calls of one combinator cluster's first
    pass (K4b; with ``ct``, its transpose K5; with ``flags``, the guarded
    K4b into that flag word) on the 1-D tensor ``x``: the old kernel, the
    port's kernel (its schedule with ``groups`` work items a block and
    ``n_buf`` of them in flight, when given; launched directly, so they
    count in no launch count; at ``mb`` blocks an SM when given, from
    this library), and the plain version (guarded: ``plain(pflags)``)."""
    import torch
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import build as B
    from repro_torch.kernels import epilogue_plan as EP
    if ct is None:
        plans, entries = ex._fused_plan_cached(fs, t)
        last = plans[0].src0
    else:
        plans, entries, last, _ = ex._fused_bwd_kernel_plan(fs, t)
    plan = plans[0]
    geometry = K.plan_geometry(plan)
    _, tt, rpt, _, _, n_tiles, _ = geometry
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    ents = K._epi_entries(sig, scal, vmem, fns, x.dtype)
    tabs = tuple(K._device_table(a, x.device, k) for a, k in (
        (plan.in_rows, n_tiles * rpt), (plan.out_rows, n_tiles * rpt),
        (plan.xor_low, n_tiles), (last, rpt << tt)))
    xc = x.reshape(1, -1, 1) if x.dim() == 1 else x.reshape(1, *x.shape)
    cc = None if ct is None else ct.reshape(xc.shape)
    bwd = ct is not None
    _, s, pl, dv = K._epi_launch_args(
        xc, geometry, ents, n_buf=2 if bwd else 1,
        align=tabs[3].data_ptr() | (cc.data_ptr() if bwd else 0))
    info = pl.info
    if groups is not None:
        kw = dict(n_words=pl.numel(), n_epi=len(ents), dv=dv, groups=groups,
                  n_buf=n_buf)
        s = (K.k5_schedule(geometry, 1, xc.shape[2], x.element_size(),
                           xc.data_ptr() | tabs[3].data_ptr()
                           | cc.data_ptr(), n_spill=EP.spill_sids(info),
                           n_map_sets=info["map_slots"] << info["outer_bits"],
                           **kw) if bwd else
             K.k4b_schedule(geometry, 1, xc.shape[2], x.element_size(),
                            xc.data_ptr() | tabs[3].data_ptr(), **kw))
    k5 = dict(has_cmp=int(info["groups"] > 0), n_spill=EP.spill_sids(info),
              n_map_sets=info["map_slots"] << info["outer_bits"]) if bwd else {}
    args = K._epi_args(s, tabs, pl, geometry, 1, x.dtype, xc.shape[2], dv,
                       **k5)
    guard = () if flags is None else (flags.data_ptr(),)
    fn = B.load("tile_bwd" if bwd else "tile_fused" if flags is None
                else "tile_fused_guarded")

    def new(_keep=(tabs, pl, args)):   # the descriptor points into these
        out = torch.empty_like(xc)
        ptrs = (xc.data_ptr(), out.data_ptr()) + (
            (cc.data_ptr(),) if bwd else ())
        wide = x.element_size() == 8
        if mb is None:
            rc = fn(*ptrs, ctypes.addressof(args), *guard, K._stream(x))
        elif wide:
            rc = (so.k5_wide_mb if bwd else so.k4b_wide_mb)(
                *ptrs, ctypes.addressof(args), mb, K._stream(x))
        elif bwd:
            rc = so.k5_mb(*ptrs, ctypes.addressof(args), mb, K._stream(x))
        elif guard:
            rc = so.k4b_guarded_mb(*ptrs, ctypes.addressof(args), *guard, mb,
                                   K._stream(x))
        else:
            rc = so.k4b_mb(*ptrs, ctypes.addressof(args), mb, K._stream(x))
        if rc:
            raise SystemExit(f"new {'K5' if bwd else 'K4b'}: CUDA error {rc}")
        return out.reshape(x.shape)

    def old():
        if bwd:
            return old_bwd(so, K, EP, xc, cc, tabs, geometry,
                           ents).reshape(x.shape)
        if guard:
            return old_guarded_fused(so, K, EP, xc, tabs, geometry, ents,
                                     flags).reshape(x.shape)
        return old_fused(so, K, EP, xc, tabs, geometry, ents).reshape(
            x.shape)

    def plain(pflags=None):
        if bwd:
            return K._tile_bwd_plain(xc, cc, plan.in_rows, plan.out_rows,
                                     plan.xor_low, last, geometry,
                                     ents).reshape(x.shape)
        return K._tile_fused_plain(xc, plan.in_rows, plan.out_rows,
                                   plan.xor_low, plan.src0, geometry, ents,
                                   pflags).reshape(x.shape)
    return old, new, plain, s


def k5_kr16_call(so, fs, t, x, ct, mb):
    """K5 on one cluster at 16 positions a thread (its plan built with 4
    register bits, the kernel instantiated for 16 in fused_ab.cu)."""
    import torch
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import epilogue_plan as EP
    plans, entries, last, _ = ex._fused_bwd_kernel_plan(fs, t)
    plan = plans[0]
    geometry = K.plan_geometry(plan)
    _, tt, rpt, _, _, n_tiles, _ = geometry
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    ents = K._epi_entries(sig, scal, vmem, fns, x.dtype)
    tabs = tuple(K._device_table(a, x.device, k) for a, k in (
        (plan.in_rows, n_tiles * rpt), (plan.out_rows, n_tiles * rpt),
        (plan.xor_low, n_tiles), (last, rpt << tt)))
    xc, cc = x.reshape(1, -1, 1), ct.reshape(1, -1, 1)
    per_cta, stride_bytes = K._epi_item(geometry, x.element_size())
    pl = K._epi_plan_tensor(ents, geometry, x.device, per_cta,
                            elem_bytes=x.element_size(),
                            stride_bytes=stride_bytes,
                            access=x.element_size(), dv=1, reg_bits=4)
    info = pl.info
    s = K.k5_schedule(geometry, 1, 1, x.element_size(), 0,
                      n_words=pl.numel(), n_epi=len(ents),
                      n_spill=EP.spill_sids(info), n_buf=1)
    args = K._epi_args(s, tabs, pl, geometry, 1, x.dtype, 1, 1,
                       has_cmp=1, n_spill=EP.spill_sids(info))

    def call(_keep=(tabs, pl, args)):
        out = torch.empty_like(xc)
        rc = so.k5_kr16(xc.data_ptr(), out.data_ptr(), cc.data_ptr(),
                        ctypes.addressof(args), mb, K._stream(x))
        if rc:
            raise SystemExit(f"k5_kr16: CUDA error {rc}")
        return out.reshape(x.shape)
    return call, info


def schedule_text(s) -> str:
    return (f"{'16-byte' if s.vec else f'{s.word_bytes}-byte word'} path, "
            f"{s.groups} work item(s) a block of {s.per_cta} tile(s), "
            f"{s.n_buf} in flight, rows of {s.stride} words, {s.grid} "
            f"blocks of {s.smem} bytes")


def guarded_ab(torch, so, n, t, xi, xf, rounds, sweep):
    """The guarded K4b's A/B on the 2^n sort (int32, float32, bfloat16):
    old guarded, guarded and unguarded bit for bit against each other and
    the guarded plain version, no flag set; in turns on the largest
    cluster (one call, device time), and summed over every cluster
    (device time, int32); with ``sweep``, the guarded K4b at 2, 3 and 4
    blocks an SM."""
    from chip_smoke import cuda_ms, device_ms, fused_cases, in_turns
    dev = xi.device
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    fss = fused_cases(n, t, "sort")
    fs = max(fss, key=lambda s: len(s.computes))
    iv = {2: torch.int16, 4: torch.int32}
    for label, x in (("int32", xi), ("float32", xf),
                     ("bfloat16", xf.bfloat16())):
        old, new, plain, s = cluster_calls(so, fs, t, x, flags=flags)
        ung = cluster_calls(so, fs, t, x)[1]
        pflags = torch.zeros_like(flags)
        want = plain(pflags).view(iv[x.element_size()])
        for side, fn in (("old guarded", old), ("guarded", new),
                         ("unguarded", ung)):
            if not torch.equal(fn().view(want.dtype), want):
                raise SystemExit(f"fused_ab: guarded K4b {label}: {side} "
                                 f"differs from the guarded plain version")
        if int(flags.item()) or int(pflags.item()):
            raise SystemExit(f"fused_ab: guarded K4b {label}: a flag set "
                             f"on clean tables")
        fns = {"old guarded": old, "guarded": new, "unguarded": ung}
        one = in_turns(fns, lambda f: cuda_ms(torch, f, 20, warmup=3),
                       rounds)
        devt = in_turns(fns, lambda f: device_ms(torch, f), rounds)
        med = {k: statistics.median(v) for k, v in devt.items()}
        print(f"2^{n} largest sort cluster, guarded K4b {label} "
              f"({schedule_text(s)}): one call {one} ms; device {devt} ms; "
              f"medians device old guarded {med['old guarded']:.4f}, "
              f"guarded {med['guarded']:.4f}, unguarded "
              f"{med['unguarded']:.4f} ms", flush=True)
        if sweep:
            for mb in (2, 3, 4):
                newm = cluster_calls(so, fs, t, x, mb=mb, flags=flags)[1]
                if not torch.equal(newm().view(want.dtype), want):
                    raise SystemExit(f"fused_ab: guarded K4b {label} at {mb} "
                                     f"blocks an SM differs")
                print(f"  guarded K4b {label} at {mb} blocks an SM (16 "
                      f"registers): device {device_ms(torch, newm):.4f} ms",
                      flush=True)
    calls = [cluster_calls(so, f, t, xi, flags=flags)[:2]
             + cluster_calls(so, f, t, xi)[1:2] for f in fss]
    sums = in_turns({k: (lambda i=i: sum(device_ms(torch, c[i])
                                         for c in calls))
                     for i, k in ((0, "old guarded"), (1, "guarded"),
                                  (2, "unguarded"))},
                    lambda f: f(), rounds=1)
    if int(flags.item()):
        raise SystemExit("fused_ab: a flag set on clean tables")
    print(f"2^{n} sort, guarded K4b int32 summed over its {len(fss)} "
          f"clusters, device ms in turns: {sums}", flush=True)


def wide_sweep(torch, so, n: int) -> None:
    """``--wide``: the 64-bit classes as the port launches them and at
    each blocks-an-SM value (device time), each bit for bit against its
    plain version first."""
    from chip_smoke import device_ms, fused_cases
    from repro_torch.combinators import fft as F
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    t = ops.choose_tile(n, 8)
    sort_fs = max(fused_cases(n, t, "sort"), key=lambda s: len(s.computes))
    nf = n - 2
    tf = ops.choose_tile(nf, 8, 2)
    fft_fs = max(fused_cases(nf, tf, "fft"), key=lambda s: len(s.computes))
    bits = torch.randint(-2**62, 2**62, (1 << n,), generator=gen,
                         device=dev, dtype=torch.int64)
    xd = torch.randn(1 << n, generator=gen, device=dev, dtype=torch.float64)
    z = torch.complex(torch.randn(1 << nf, generator=gen, device=dev),
                      torch.randn(1 << nf, generator=gen, device=dev))
    xp = F.to_planar(z).double()
    cases = (("K4b int64", sort_fs, t, bits, None, (2, 3, 4, 5)),
             ("K4b uint64", sort_fs, t, bits.view(torch.uint64), None,
              (2, 3, 4, 5)),
             ("K4b float64", sort_fs, t, xd, None, (2, 3, 4, 5)),
             ("K4b planar float64", fft_fs, tf, xp, None, (2, 3, 4)),
             ("K5 float64", sort_fs, t, xd, torch.randn_like(xd), (2, 3, 4)),
             ("K5 planar float64", fft_fs, tf, xp, torch.randn_like(xp),
              (1, 2, 3)))
    for label, fs, tt, x, c, mbs in cases:
        _, new, plain, s = cluster_calls(so, fs, tt, x, c)
        want = plain().view(torch.int64)
        if not torch.equal(new().view(torch.int64), want):
            raise SystemExit(f"fused_ab: {label} differs from its plain "
                             f"version")
        print(f"2^{n if fs is sort_fs else nf} largest "
              f"{'sort' if fs is sort_fs else 'FFT'} cluster {label} "
              f"({schedule_text(s)}): device {device_ms(torch, new):.4f} ms "
              f"as the port launches it", flush=True)
        for mb in mbs:
            _, newm, _, _ = cluster_calls(so, fs, tt, x, c, mb=mb)
            if not torch.equal(newm().view(torch.int64), want):
                raise SystemExit(f"fused_ab: {label} at {mb} blocks an SM "
                                 f"differs")
            print(f"  {label} at {mb} blocks an SM: device "
                  f"{device_ms(torch, newm):.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-sweep", action="store_true",
                    help="time old and new only (no work-item or "
                         "blocks-an-SM sweep)")
    ap.add_argument("--guarded-only", action="store_true",
                    help="the guarded K4b's A/B only")
    ap.add_argument("--wide", action="store_true",
                    help="the 64-bit classes' blocks-an-SM sweep only")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("fused_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, device_ms, fused_cases, in_turns
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ops
    started = start_build(B.build_dir().parent / "sweep", wide=args.wide)
    log = B.build_all()
    so, ab_log = finish_build(started)
    for k in ("tile_fused", "tile_bwd"):
        if k in log:
            for name, u in usage(log[k]["ptxas"], "items_kernel") + usage(
                    log[k]["ptxas"], "tile_bwd_kernel"):
                print(f"new {name}: {u}", flush=True)
    if args.wide:
        for name, u in usage(ab_log, "kernelId") + usage(
                ab_log, "I64") + usage(ab_log, "U64"):
            print(f"sweep {name}: {u}", flush=True)
        wide_sweep(torch, so, args.n)
        return 0
    for name, u in usage(ab_log, "old_kernel"):
        print(f"old {name}: {u}", flush=True)
    for name, u in usage(ab_log, "Li3EE") + usage(ab_log, "Li5EE") + usage(
            ab_log, "ELi2EE") + usage(ab_log, "ELi4EE"):
        if "old" not in name:
            print(f"sweep {name}: {u}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    n = args.n
    t = ops.choose_tile(n, 4)
    fs = max(fused_cases(n, t, "sort"), key=lambda s: len(s.computes))
    xi = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    xf = torch.randint(0, 1 << 16, (1 << n,), generator=gen,
                       device=dev).float()
    ct = torch.randn(1 << n, generator=gen, device=dev)
    cases = (("K4b int32", xi, None), ("K4b float32", xf, None),
             ("K4b bfloat16", xf.bfloat16(), None), ("K5 float32", xf, ct),
             ("K5 bfloat16", xf.bfloat16(), ct.bfloat16()))
    for label, x, c in () if args.guarded_only else cases:
        old, new, plain, s = cluster_calls(so, fs, t, x, c)
        want = plain()
        for side, fn in (("old", old), ("new", new)):
            if not torch.equal(fn().view(torch.int16 if x.element_size() == 2
                                         else torch.int32),
                               want.view(torch.int16 if x.element_size()
                                         == 2 else torch.int32)):
                raise SystemExit(f"fused_ab: {label} {side} differs from "
                                 f"the plain version")
        one = in_turns({"old": old, "new": new},
                       lambda f: cuda_ms(torch, f, 20, warmup=3),
                       args.rounds)
        devt = in_turns({"old": old, "new": new},
                        lambda f: device_ms(torch, f), args.rounds)
        print(f"2^{n} largest sort cluster {label} ({schedule_text(s)}): "
              f"one call old {one['old']} new {one['new']} ms; device old "
              f"{devt['old']} new {devt['new']} ms; medians device old "
              f"{statistics.median(devt['old']):.4f} new "
              f"{statistics.median(devt['new']):.4f}", flush=True)
        if args.no_sweep:
            continue
        for g, nb in ((1, 1), (2, 1), (2, 2), (3, 2), (4, 1), (4, 2),
                      (8, 2)):
            _, newg, _, sg = cluster_calls(so, fs, t, x, c, groups=g,
                                           n_buf=nb)
            print(f"  {label} at {g} work item(s) a block, {nb} in flight "
                  f"({schedule_text(sg)}): device "
                  f"{device_ms(torch, newg):.4f} ms", flush=True)
        if label == "K5 float32":
            for mb in (2, 3):
                call, info = k5_kr16_call(so, fs, t, x, c, mb)
                got = call()
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise SystemExit("fused_ab: K5 at 16 registers differs")
                print(f"  {label} at 16 positions a thread "
                      f"({info['n_phases']} phases, {1 << info['outer_bits']}"
                      f" chunk(s)), {mb} blocks an SM: device "
                      f"{device_ms(torch, call):.4f} ms", flush=True)
        for mb in {"K4b int32": (3, 5), "K4b float32": (3, 5),
                   "K4b bfloat16": (3,), "K5 float32": (2, 3),
                   "K5 bfloat16": (2,)}.get(label, ()):
            _, newm, _, _ = cluster_calls(so, fs, t, x, c, mb=mb)
            got = newm()
            iv = torch.int16 if got.element_size() == 2 else torch.int32
            if not torch.equal(got.view(iv), want.view(iv)):
                raise SystemExit(f"fused_ab: {label} at {mb} blocks an SM "
                                 f"differs")
            print(f"  {label} at {mb} blocks an SM (launch bound): device "
                  f"{device_ms(torch, newm):.4f} ms", flush=True)
    guarded_ab(torch, so, n, t, xi, xf, args.rounds, not args.no_sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
