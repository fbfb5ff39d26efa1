#!/usr/bin/env python3
"""How PyTorch's CUDA backward kernels round a map's derivatives.

    python3 tools/map_vjp_rounding.py            # one GPU

K5 takes a ``Map``'s gradient by reverse mode over its tape and is held
bit for bit against its plain version, which calls ``torch.autograd.grad``
on the card. Most derivative formulas are single aten ops, rounded once.
``tanh_backward`` and ``sigmoid_backward`` are fused kernels of several
ops, and how they round is the kernels' own. For each, in float32 and
bfloat16, on 2^20 inputs (half of tanh's outputs within 1e-2 of 1, where
``1 - y * y`` cancels), this prints how many results of each candidate
formula differ from the CUDA kernel's, and by how many units in the last
place at most:

* ``once``: the formula in float32 without FMAs, rounded to the dtype
  once at the end;
* ``fma``: as ``once``, with tanh's ``1 - y * y`` one fused multiply-add;
* ``per_op``: each op rounded to the dtype (bfloat16 arithmetic).

K5's ``map_op_back`` (``csrc/tile_bwd.cu``) computes the candidate that
matches. Then, for each listed map op, the count of results of
``map_lower.tape_vjp`` (autograd's own aten ops, op by op) on the card
that differ from autograd's.
Imports torch and ``repro_torch`` only.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N = 1 << 20
F32, BF = torch.float32, torch.bfloat16


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF else torch.int32)


def _diff(got, want) -> str:
    d = (_bits(got).long() - _bits(want).long()).abs()
    return f"{int((d != 0).sum())} differ, max {int(d.max())} ulp"


def main() -> int:
    if not torch.cuda.is_available():
        print("map_vjp_rounding: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import map_lower as ML
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand():
        return torch.rand(N, generator=gen, device=dev)

    for dt in (F32, BF):
        def r(v):
            return v.to(dt).float()
        g = torch.randn(N, generator=gen, device=dev).to(dt).float()
        y = torch.where(rand() < 0.5, 1 - rand() * 1e-2, rand() * 2 - 1)
        y = y.to(dt)
        want = torch.ops.aten.tanh_backward(g.to(dt), y)
        y = y.float()
        cands = {"once": g * (1 - y * y),
                 "fma": g * (1 - y.double() ** 2).float(),
                 "per_op": g * r(1 - r(y * y))}
        for k, v in cands.items():
            print(f"tanh_backward {dt}, {k}: {_diff(v.to(dt), want)}")
        s = rand().to(dt)
        want = torch.ops.aten.sigmoid_backward(g.to(dt), s)
        s = s.float()
        cands = {"once": (g * (1 - s)) * s,
                 "per_op": r(g * r(1 - s)) * s}
        for k, v in cands.items():
            print(f"sigmoid_backward {dt}, {k}: {_diff(v.to(dt), want)}")

    fns = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "exp": torch.exp,
           "expm1": torch.expm1, "log": torch.log, "log1p": torch.log1p,
           "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
           "div7": lambda v: v / 7, "ratio": lambda v: (v + 1) / v,
           "abs": torch.abs, "silu": lambda v: v * torch.sigmoid(v),
           "chain3": lambda v: (v * 3 + 1) / 7,
           "tanh_x": lambda v: torch.tanh(v) * v}
    for dt in (F32, BF):
        row = []
        for name, fn in fns.items():
            tape = ML.lower_map(f"rounding_{name}", fn, dt)
            if not tape.lowered:
                raise SystemExit(f"map_vjp_rounding: {name} did not lower")
            pos = name in ("log", "log1p", "sqrt", "rsqrt")
            u = (rand() * 4 if pos else rand() * 8 - 4).to(dt)
            ct = torch.randn(N, generator=gen, device=dev).to(dt)
            uu = u.clone().requires_grad_(True)
            want = torch.autograd.grad(fn(uu), uu, ct)[0]
            got = ML.tape_vjp(tape, u, ct)
            row.append(f"{name} {int((_bits(got) != _bits(want)).sum())}")
        print(f"tape_vjp on the card against autograd, {dt}, results that "
              f"differ of {N}: " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
