"""The ``parm`` combinator (paper §7) and its BMMC compilation.

The counterpart of :mod:`repro.core.parm`. ``parm mask f xs`` partitions
``xs`` (size 2^n) into two sub-arrays by the F2 dot product ``i * mask``,
applies ``f`` to each, and stitches back.

Compilation (paper §7.2): ``parm m f = bmmc(A^-1, 0) ∘ parm 2^(n-1) f ∘
bmmc(A, 0)`` where ``A`` maps x to y with::

    y_i = x_i            (i < lsb(mask))
    y_i = x_{i+1}        (lsb(mask) <= i < n-1)
    y_{n-1} = x * mask   (the sub-array bit)

so the two sub-arrays become the two contiguous halves, preserving any
coalescing behaviour of ``f``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .bmmc import Bmmc


def lsb(mask: int) -> int:
    assert mask > 0
    return (mask & -mask).bit_length() - 1


def parm_matrix(n: int, mask: int) -> Bmmc:
    """The matrix A of paper §7.2 (Fig. 13)."""
    assert 0 < mask < (1 << n)
    l = lsb(mask)
    rows = []
    for i in range(n - 1):
        rows.append(1 << (i if i < l else i + 1))
    rows.append(mask)
    return Bmmc(tuple(rows), 0)


# ---------------------------------------------------------------------------
# Reference (direct) semantics — no BMMC, used as the oracle in tests.
# ---------------------------------------------------------------------------

def _subarray_bits(n: int, mask: int) -> np.ndarray:
    idx = np.arange(1 << n)
    return np.bitwise_count(idx & mask).astype(np.int64) & 1


def parm_ref(mask: int, f: Callable, xs: np.ndarray) -> np.ndarray:
    """Direct index-partition semantics of ``parm`` (paper Fig. 3/13)."""
    n = int(np.log2(xs.shape[0]))
    assert (1 << n) == xs.shape[0]
    bit = _subarray_bits(n, mask)
    out = np.empty_like(xs)
    for b in (0, 1):
        sel = bit == b
        out[sel] = np.asarray(f(xs[sel]))
    return out


# ---------------------------------------------------------------------------
# BMMC-compiled semantics on torch tensors.
# ---------------------------------------------------------------------------

def parm(mask: int, f: Callable, xs: torch.Tensor, *,
         engine: Callable = None) -> torch.Tensor:
    """``parm`` compiled via BMMC permutations (paper §7.2).

    ``engine(xs, bmmc)`` applies a BMMC permutation to a tensor; defaults
    to the plain gather (:func:`repro_torch.kernels.ref.bmmc_ref`). ``f``
    maps tensors of size 2^(n-1) to tensors of size 2^(n-1).
    """
    if engine is None:
        from ..kernels import ref as _ref
        engine = _ref.bmmc_ref
    n = int(np.log2(xs.shape[0]))
    a = parm_matrix(n, mask)
    ys = engine(xs, a)
    half = xs.shape[0] // 2
    lo, hi = ys[:half], ys[half:]
    out = torch.cat([f(lo), f(hi)], dim=0)
    return engine(out, a.inverse())
