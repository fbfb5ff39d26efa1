#!/usr/bin/env python3
"""Time the 2^24 sort of each element type the fused kernels took last
(int64, uint64, float64; ``--types`` also takes float16, int8, uint8,
int16, uint16, uint32 and bool) and a sort gradient (float64, or
``--grad-dtype``), in a checkout, on one GPU.

    python3 tools/dtype_sort_times.py --src OTHER/src --tag parent
    python3 tools/dtype_sort_times.py --src src --tag change

The checkout's ``repro_torch`` is imported from ``--src`` (its kernels
build into that checkout's ``build/kernels``). For each type: one call of
``compiled_sort(24)`` (its CUDA graph), one call stage by stage
(``call_per_stage``), each the median of 20 calls timed with CUDA events,
in turns, with the K4b launches and fused fallbacks of a cold call (a
tree whose K4b does not take the type runs its clusters stage by stage);
then the device time of K4b and K5 on the map cluster of ``tanh >>
sort`` (float32 and bfloat16: the map kernels, whose code the added map
ops changed; 10 calls in one CUDA graph); then forward + backward of
``(w * sort(x)).sum()`` on float64 keys (``--grad-dtype``; ``--grad-n``:
its log2 keys; a tree whose K4b does not take the type runs the
clusters' backward stage by stage, minutes at 2^24). ``--types`` picks
the sorts. A type
the tree cannot sort prints its error. Two checkouts compare only
within one run on one card: run parent, change, change, parent. Imports
torch and the checkout's ``repro_torch`` only.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TYPES = ("int64", "uint64", "float64")


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="this", help="label of each line")
    ap.add_argument("--n", type=int, default=24, help="log2 keys")
    ap.add_argument("--types", default=",".join(TYPES),
                    help="comma-separated types to sort (empty: none)")
    ap.add_argument("--grad-n", type=int, default=None,
                    help="log2 keys of the gradient (default --n)")
    ap.add_argument("--grad-dtype", default="float64",
                    help="the gradient's key type (a float type)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("dtype_sort_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.combinators import sort as S
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import build as B
    B.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2616)
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    f = S.compiled_sort(args.n)
    for name in filter(None, args.types.split(",")):
        dtype = getattr(torch, name)
        if dtype == torch.bool:
            x = torch.randint(0, 2, (1 << args.n,), generator=gen,
                              device=dev) > 0
        elif dtype.is_floating_point:
            x = torch.randn(1 << args.n, generator=gen, device=dev,
                            dtype=torch.float64).to(dtype)
        else:
            x = torch.randint(-2**31, 2**31 - 1, (1 << args.n,),
                              generator=gen, device=dev, dtype=torch.int64)
            size = torch.empty((), dtype=dtype).element_size()
            if size == 8:   # all 64 bits random
                x = (x << 32) | torch.randint(
                    0, 2**32, (1 << args.n,), generator=gen, device=dev,
                    dtype=torch.int64)
            x = x.to(signed[size]).view(dtype)
        rec = {"tag": args.tag, "type": name, "card": smi}
        try:
            obs.reset()
            obs.enable(sync=True)
            K.reset_launch_counts()
            f(x)
            torch.cuda.synchronize()
            obs.disable()
            rec["fused_fallbacks"] = obs.counter_total(
                "dispatch.fused_fallback")
            rec["tile_fused_launches"] = K.launch_counts()["tile_fused"]
            obs.reset()
            graph, stage = [], []
            for r in range(4):        # in turns: graph, stage, stage, graph
                for k in (("graph", "stage") if r % 2 == 0
                          else ("stage", "graph")):
                    fn = (lambda: f(x)) if k == "graph" else (
                        lambda: f.call_per_stage(x))
                    (graph if k == "graph" else stage).append(
                        cuda_ms(torch, fn))
            rec["graph_ms"] = graph
            rec["stage_ms"] = stage
        except Exception as e:        # a type the tree cannot sort
            obs.disable()
            rec["error"] = f"{type(e).__name__}: {e}"[:200]
        print(json.dumps(rec), flush=True)
        del x
        torch.cuda.empty_cache()
    # the map kernels (whose code the new map ops changed): K4b and K5 on
    # the map cluster of tanh >> sort, float32 and bfloat16, device time
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import vocab as V
    from repro_torch.kernels import ops
    fm = compile_expr(V.emap("tanh", torch.tanh) >> S.sort_expr(args.n))
    t = ops.choose_tile(args.n, 4)
    fs = next(s for s in fm.clustered_program(args.n, t)
              if isinstance(s, FusedStage)
              and any(type(c).__name__ == "Map" for c, _ in s.computes))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1 << args.n, generator=gen, device=dev).to(dtype)
        ct = torch.randn(1 << args.n, generator=gen, device=dev).to(dtype)
        times = {}
        for name, fn in (("k4b", lambda: ex._fused_cuda(x, fs, t)),
                         ("k5", lambda: ex._fused_bwd_cuda(fs, t, False, x,
                                                           ct))):
            fn()
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with K.pin_device_tables():
                with torch.cuda.graph(g):
                    for _ in range(10):
                        fn()
            times[name] = [cuda_ms(torch, g.replay, 10, 1) / 10
                           for _ in range(3)]
            del g
        print(json.dumps({"tag": args.tag, "type": f"tanh map cluster "
                          f"{str(dtype)[6:]}", "card": smi,
                          "device_ms": times}), flush=True)
    gn = args.grad_n or args.n
    gd = getattr(torch, args.grad_dtype)
    fg = S.compiled_sort(gn)
    x = torch.randn(1 << gn, generator=gen, device=dev,
                    dtype=torch.float64).to(gd)
    w = torch.randn(1 << gn, generator=gen, device=dev,
                    dtype=torch.float64).to(gd)

    def grad():
        v = x.clone().requires_grad_(True)
        (w * fg(v)).sum().backward()
        return v.grad
    K.reset_launch_counts()
    grad()
    torch.cuda.synchronize()
    rec = {"tag": args.tag, "type": f"{args.grad_dtype} gradient 2^{gn}",
           "card": smi,
           "tile_bwd_launches": K.launch_counts()["tile_bwd"],
           "ms": [cuda_ms(torch, grad, 3, 1) for _ in range(2)]}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
