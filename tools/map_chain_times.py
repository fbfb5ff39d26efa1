#!/usr/bin/env python3
"""Time the map kernels of a checkout on chain maps (tapes of at most 8
ops) and DAG maps, on one GPU: K4b and K5 on ``chip_smoke.py``'s
hand-built map clusters of phases 6 and 9 (``MAP_CASES``), on the map
cluster of ``tanh >> sort`` at 2^24 (float32 and bfloat16), of
``dag >> sort`` for three DAG maps (``dag_maps``, float32) and of the
bfloat16 ``cast_tanh >> sort`` (where the checkout lowers it); then the
whole ``emap(torch.tanh(v.float()).to(v.dtype)) >> sort`` on 2^24
bfloat16 and its gradient, one call each, with the fused fallbacks the
checkout counts (a checkout whose tapes take no cast runs that map
stage by stage).

    python3 tools/map_chain_times.py --src OTHER/src --tag parent
    python3 tools/map_chain_times.py --src src --tag change

The checkout's ``repro_torch`` is imported from ``--src`` (its kernels
build into that checkout's ``build/kernels``, or ``--build-dir``); the
clusters and timers are this checkout's ``chip_smoke.py``'s. Each kernel
is held bit for bit against its plain version, then timed as device time
(10 calls in one CUDA graph, three readings) and one call (CUDA events
around the Python call). One JSON line a case. Two checkouts compare only
within one run on one card: run parent, change, change, parent. Imports
torch, numpy and the checkout's ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def dag_maps(torch) -> list:
    """(name, function) of the DAG maps timed: a where, a gelu written
    out (a value read by several ops), a band of comparisons."""
    return [
        ("leaky_where", lambda v: torch.where(v > 0, v, 0.01 * v)),
        ("gelu_dag", lambda v: 0.5 * v * (1 + torch.tanh(
            0.7978845608028654 * (v + 0.044715 * v * v * v)))),
        ("band", lambda v: torch.where(torch.logical_and(v > -1, v < 1),
                                       torch.maximum(v * 2, -v), v)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="this", help="label of each line")
    ap.add_argument("--build-dir", default=None,
                    help="where its kernels build (REPRO_TORCH_BUILD_DIR)")
    ap.add_argument("--n", type=int, default=24,
                    help="log2 keys of tanh >> sort")
    args = ap.parse_args(argv)
    if args.build_dir:
        os.environ["REPRO_TORCH_BUILD_DIR"] = args.build_dir
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    sys.path.insert(0, args.src)       # ahead of the path chip_smoke adds
    import torch
    if not torch.cuda.is_available():
        print("map_chain_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import vocab as V
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ops
    B.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)

    def timed(call, plain):
        err = CS.max_abs_err(torch, call(), plain())
        return {"max_abs_err": err,
                "device_ms": [CS.device_ms(torch, call) for _ in range(3)],
                "ms": CS.cuda_ms(torch, call, 10)}

    for (label, n, t, n_cmp, maps, dname, d, batch) in CS.MAP_CASES:
        dtype = getattr(torch, dname)
        plan, sig, scal, vmem = CS.hand_cluster(n, t, n_cmp, seed=n_cmp + t)
        sig, scal, vmem, fns = list(sig), list(scal), list(vmem), []
        for pos, name, _ in maps:
            sig.insert(pos, ("map", name))
            scal.insert(pos, ())
            vmem.insert(pos, ())
        for sg in sig:
            if sg[0] == "map":
                fn = next(f for _, nm, f in maps if nm == sg[1])
                fns.append(getattr(torch, fn) if isinstance(fn, str) else fn)
        shape = (batch, 1 << n, d)
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            x = (torch.rand(shape, generator=gen, device=dev) + 0.5).to(dtype)
        kw = dict(geometry=K.plan_geometry(plan), epilogue=tuple(sig),
                  epi_scalar=tuple(scal), epi_vmem=tuple(vmem),
                  map_fns=tuple(fns), batched=True)
        tabs = [torch.from_numpy(a).to(dev) for a in (
            plan.in_rows, plan.out_rows, plan.xor_low, plan.src0)]
        rec = {"tag": args.tag, "case": f"phase 6/9: {label}", "card": smi,
               "k4b": timed(lambda: K.tiled_permute_tables(x, *tabs, **kw),
                            lambda: K.tiled_permute_tables_plain(
                                x, *tabs, **kw))}
        if dtype != torch.int32:
            s0 = plan.src0.reshape(-1)
            inv = np.empty_like(s0)
            inv[s0] = np.arange(s0.size, dtype=s0.dtype)
            bt = tabs[:3] + [torch.from_numpy(inv.reshape(
                plan.src0.shape)).to(dev)]
            ct = torch.randn(shape, generator=gen, device=dev).to(dtype)
            rec["k5"] = timed(
                lambda: K.tiled_permute_bwd_tables(x, ct, *bt, **kw),
                lambda: K.tiled_permute_bwd_tables_plain(x, ct, *bt, **kw))
        print(json.dumps(rec), flush=True)

    def map_cluster(fn, name):
        fm = compile_expr(V.emap(name, fn) >> S.sort_expr(args.n))
        t = ops.choose_tile(args.n, 4)
        return t, next(s for s in fm.clustered_program(args.n, t)
                       if isinstance(s, FusedStage) and any(
                           type(c).__name__ == "Map" for c, _ in s.computes))

    from repro_torch.kernels.map_lower import lower_map
    cases = [("tanh", torch.tanh, dt) for dt in (torch.float32,
                                                 torch.bfloat16)]
    cases += [(name, fn, torch.float32) for name, fn in dag_maps(torch)]
    cases += [("cast_tanh", lambda v: torch.tanh(v.float()).to(v.dtype),
               torch.bfloat16)]
    for name, fn, dtype in cases:
        if not lower_map(name, fn, dtype).lowered:   # runs stage by stage
            print(json.dumps({"tag": args.tag, "case": f"{name} >> sort "
                              f"map cluster {str(dtype)[6:]}",
                              "card": smi, "lowered": False}), flush=True)
            continue
        t, fs = map_cluster(fn, name)
        x = torch.randn(1 << args.n, generator=gen, device=dev).to(dtype)
        ct = torch.randn(1 << args.n, generator=gen, device=dev).to(dtype)
        rec = {"tag": args.tag, "case": f"{name} >> sort 2^{args.n} map "
               f"cluster {str(dtype)[6:]}", "card": smi,
               "k4b": timed(lambda: ex._fused_cuda(x, fs, t),
                            lambda: CS.fused_call(K, ex, fs, t, x,
                                                  plain=True)),
               "k5": timed(lambda: ex._fused_bwd_cuda(fs, t, False, x, ct),
                           lambda: CS.bwd_call(K, ex, fs, t, x, ct,
                                               plain=True))}
        print(json.dumps(rec), flush=True)
        del x, ct
        torch.cuda.empty_cache()

    # the whole cast-tanh sort on bfloat16 and its gradient: fused where
    # the checkout's tapes take casts, stage by stage where they do not
    from repro_torch import obs
    f = compile_expr(V.emap("cast_tanh", lambda v: torch.tanh(v.float()).to(
        v.dtype)) >> S.sort_expr(args.n))
    x = torch.randn(1 << args.n, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(1 << args.n, generator=gen, device=dev).to(torch.bfloat16)

    def grad():
        v = x.clone().requires_grad_(True)
        (w * f(v)).sum().backward()
        return v.grad
    obs.reset()
    obs.enable(sync=True)
    try:
        f(x)
        fb_fwd = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        grad()
        fb_grad = obs.counter_total("dispatch.fused_fallback")
    finally:
        obs.disable()
        obs.reset()
    rec = {"tag": args.tag, "case": f"cast tanh >> sort 2^{args.n} "
           "bfloat16", "card": smi, "fallbacks": [fb_fwd, fb_grad],
           "forward_ms": [CS.cuda_ms(torch, lambda: f(x), 10)
                          for _ in range(3)],
           "gradient_ms": [CS.cuda_ms(torch, grad, 3) for _ in range(3)]}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
