"""Sorting networks via ``parm`` (paper §7.1) — combinator-IR backed.

The counterpart of :mod:`repro.core.sort`.

The paper's example: a merge sort whose merger is the balanced periodic
merger [Dowd et al.]::

    sort 0 xs = xs
    sort n xs = merge n (parm 1 (sort (n-1)) xs)

    merge 0 xs = xs
    merge n xs = parm 2^(n-1) (merge (n-1)) (vcolumn n xs)

    vcolumn 1 = compare-exchange
    vcolumn n = parm 3 (vcolumn (n-1))

Two implementations are provided:

* ``sort_rec`` — direct recursion with ``parm`` (reference semantics).
* ``compile_sort`` — the network as a :mod:`repro_torch.combinators` stage
  program: ``fuse`` applies the §7.2 rewrite (``bmmc B ∘ bmmc A =
  bmmc (BA)``), leaving exactly one fused BMMC permutation between
  consecutive compare-exchange sweeps.

This module is a thin compatibility facade: the expression language,
optimizer, and executor live in :mod:`repro_torch.combinators` (which
see).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Union

import numpy as np

from ..combinators.execute import run_program
from ..combinators.ir import CmpHalves, Expr, Perm
from ..combinators.optimize import fuse as _fuse_program
from ..combinators.optimize import lower, num_perm_stages as _num_perm
from ..combinators.sort import merge_expr, sort_expr, vcolumn_expr
from .parm import parm_ref

Stage = Expr  # a lowered program is a sequence of primitive Expr stages

__all__ = ["Perm", "CmpHalves", "Stage", "sort_rec", "merge_rec",
           "vcolumn_rec", "compile_sort", "compile_merge", "compile_vcolumn",
           "fuse", "run_stages", "sort_compiled", "num_perm_stages"]


# ---------------------------------------------------------------------------
# Reference recursion (numpy oracle, paper pseudocode transliterated)
# ---------------------------------------------------------------------------

def _cmpex(xs):
    """Compare-exchange on a 2-element array: min first."""
    a, b = xs[0], xs[1]
    return np.stack([np.minimum(a, b), np.maximum(a, b)])


def vcolumn_rec(n: int, xs):
    if n == 0:
        return xs
    if n == 1:
        return _cmpex(xs)
    return parm_ref(3, lambda h: vcolumn_rec(n - 1, h), xs)


def merge_rec(n: int, xs):
    if n == 0:
        return xs
    ys = vcolumn_rec(n, xs)
    return parm_ref(1 << (n - 1), lambda h: merge_rec(n - 1, h), ys)


def sort_rec(n: int, xs):
    if n == 0:
        return xs
    ys = parm_ref(1, lambda h: sort_rec(n - 1, h), xs)
    return merge_rec(n, ys)


# ---------------------------------------------------------------------------
# Stage-program compilation (combinator IR lowering)
# ---------------------------------------------------------------------------

def compile_vcolumn(n: int) -> List[Stage]:
    return list(lower(vcolumn_expr(n), n))


def compile_merge(n: int) -> List[Stage]:
    return list(lower(merge_expr(n), n))


def compile_sort(n: int) -> List[Stage]:
    return list(lower(sort_expr(n), n))


def fuse(stages: Sequence[Stage]) -> List[Stage]:
    """Fuse adjacent Perm stages and drop identities (the §7.2 rewrite)."""
    return list(_fuse_program(tuple(stages)))


def run_stages(stages: Sequence[Stage], xs, *,
               engine: Union[str, Callable, None] = None):
    """Execute a stage program on a tensor of size 2^n.

    ``engine``: an engine name from :mod:`repro_torch.combinators.execute`
    ("ref"/"cuda"), a callable ``(x, bmmc) -> x``, or None for "ref".
    """
    return run_program(tuple(stages), xs, engine)


def sort_compiled(xs, *, engine: Union[str, Callable, None] = None):
    n = int(np.log2(xs.shape[0]))
    return run_stages(fuse(compile_sort(n)), xs, engine=engine)


def num_perm_stages(stages: Sequence[Stage]) -> int:
    return _num_perm(stages)
