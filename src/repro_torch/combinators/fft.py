"""Radix-2 DIT FFT as a combinator expression (bit-reversal + butterflies).

The counterpart of :mod:`repro.combinators.fft`. The classic iterative
FFT on 2^n points is::

    bit_reverse  >>  stage 0  >>  stage 1  >>  ...  >>  stage n-1

where stage ``s`` applies, within each contiguous block of 2^(s+1)
elements, the butterfly pairing ``j <-> j + 2^s`` with twiddle
``exp(-2πi j / 2^(s+1))``. In the IR that is ``two``-lifted ``n-s-1``
times over a full-width :func:`~repro_torch.combinators.vocab.bfly`
core — every reordering is a BMMC permutation, so the optimizer fuses
them across stages.

Complex data is carried either natively (``complex64`` tensors) or as
``(2^n, 2)`` float32 tensors of (re, im) channels — the layout the fused
CUDA kernel (K4b) takes. Both run the same kernels: the permutation
kernels move a complex64 element as one 8-byte word, and a butterfly
cluster runs on a complex64 array's planar view.
"""
from __future__ import annotations

import functools
import math

import torch

from .execute import CompiledExpr, compile_expr
from .ir import Expr
from .sort import as_tensor
from .vocab import bfly, bit_reverse, seq, two


def _stage_core(s: int) -> Expr:
    """Butterfly core on 2^(s+1) elements: pairs (j, j + 2^s). The
    twiddles are the reference's, computed the same way, so the float32
    twiddle tables of the two packages are bitwise equal."""
    m = 1 << (s + 1)
    ws = [complex(math.cos(-2 * math.pi * j / m),
                  math.sin(-2 * math.pi * j / m)) for j in range(m // 2)]
    return bfly(ws)


@functools.lru_cache(maxsize=None)
def fft_expr(n: int) -> Expr:
    """The full 2^n-point DIT FFT expression."""
    stages = [bit_reverse(n)]
    for s in range(n):
        e = _stage_core(s)
        for _ in range(n - s - 1):
            e = two(e)
        stages.append(e)
    return seq(*stages)


def compiled_fft(n: int, *, engine="cuda",
                 optimize: bool = True) -> CompiledExpr:
    return compile_expr(fft_expr(n), engine=engine, optimize=optimize)


def fft(x, *, engine="cuda", device=None) -> torch.Tensor:
    """FFT of 2^n complex points via the combinator program (complex64;
    see :func:`repro_torch.combinators.sort.as_tensor` for where it
    runs)."""
    x = as_tensor(x, device).to(torch.complex64)
    n = int(x.shape[0]).bit_length() - 1
    return compiled_fft(n, engine=engine)(x)


def fft_planar(x_ri, *, engine="cuda", device=None) -> torch.Tensor:
    """FFT on the planar (2^n, 2) float (re, im) layout — the layout the
    fused kernel takes."""
    x = as_tensor(x_ri, device)
    n = int(x.shape[0]).bit_length() - 1
    return compiled_fft(n, engine=engine)(x)


def to_planar(x) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.complex64)
    return torch.stack([x.real, x.imag], dim=-1).to(torch.float32)


def from_planar(x_ri: torch.Tensor) -> torch.Tensor:
    return torch.complex(x_ri[..., 0], x_ri[..., 1])
