"""The balanced-periodic merge sort (paper §7.1) as a combinator expression.

The counterpart of :mod:`repro.combinators.sort`. The paper's recursion,
transliterated into the IR::

    sort 0      = id
    sort n      = parm 1 (sort (n-1))  >>  merge n

    merge 0     = id
    merge n     = vcolumn n  >>  parm 2^(n-1) (merge (n-1))

    vcolumn 1   = cmp_halves
    vcolumn n   = parm 3 (vcolumn (n-1))

Lowering expands every ``parm`` into its §7.2 BMMC conjugation and the
optimizer fuses the resulting permutation chains, leaving exactly one
BMMC permutation between consecutive compare-exchange sweeps; on the
``"cuda"`` engine the clustering then runs most sweeps inside the fused
tiled passes (K4b).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .execute import CompiledExpr, compile_expr
from .ir import Expr
from .vocab import cmp_halves, identity, parm, seq


@functools.lru_cache(maxsize=None)
def vcolumn_expr(n: int) -> Expr:
    if n <= 0:
        return identity()
    if n == 1:
        return cmp_halves()
    return parm(3, vcolumn_expr(n - 1))


@functools.lru_cache(maxsize=None)
def merge_expr(n: int) -> Expr:
    if n <= 0:
        return identity()
    return seq(vcolumn_expr(n), parm(1 << (n - 1), merge_expr(n - 1)))


@functools.lru_cache(maxsize=None)
def sort_expr(n: int) -> Expr:
    if n <= 0:
        return identity()
    return seq(parm(1, sort_expr(n - 1)), merge_expr(n))


def compiled_sort(n: int, *, engine="cuda",
                  optimize: bool = True) -> CompiledExpr:
    """The compiled sorting network for arrays of 2^n elements."""
    return compile_expr(sort_expr(n), engine=engine, optimize=optimize)


def as_tensor(xs, device=None) -> torch.Tensor:
    """``xs`` as a tensor: a tensor stays on its own device (or moves to
    ``device`` when one is given); anything else goes to ``device``,
    which defaults to ``"cuda"``."""
    if isinstance(xs, torch.Tensor):
        return xs if device is None else xs.to(device)
    return torch.as_tensor(np.asarray(xs),
                           device="cuda" if device is None else device)


def sort(xs, *, engine="cuda", device=None) -> torch.Tensor:
    """Sort 2^n elements via the compiled network (see :func:`as_tensor`
    for where it runs)."""
    x = as_tensor(xs, device)
    n = int(x.shape[0]).bit_length() - 1
    return compiled_sort(n, engine=engine)(x)
