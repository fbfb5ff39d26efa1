"""PermuteLayer: BMMC permutations as a differentiable model component.

The counterpart of :mod:`repro.models.permute`. The combinator executor
works on ``(2^n,)`` / ``(B, 2^n[, d])`` tensors; model activations are
arbitrary-rank. ``PermuteLayer`` bridges the two: it applies a compiled
BMMC program along *one* axis of any tensor by collapsing the leading axes
into the kernel batch dim and the trailing axes into the feature dim — so
a ``(B, S, H, D)`` head shuffle and a ``(P, C, E)`` MoE slot shuffle both
ride the same batched tiled kernels, sharing one ``TilePlan`` geometry
across every surrounding shape.

Layers are parameter-free and differentiable: gradients flow through the
executor's offline-inverted autograd rule, so a ``PermuteLayer`` inside a
training step costs one extra permutation pass per direction and never
materializes a gather transpose.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..combinators.execute import compile_expr, perm_apply
from ..combinators.ir import Expr, Perm, seq
from ..core.bmmc import Bmmc


def _collapse_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Reshape so ``axis`` becomes axis 1 of a batched kernel view:
    leading axes collapse into the batch dim, trailing into the feature
    dim — ``(lead, size)`` or ``(lead, size, d)``. The permuted axis
    length must be a power of two."""
    ax = axis % x.dim()
    size = x.shape[ax]
    if size & (size - 1):
        raise ValueError(f"axis {axis} length {size} is not a power of 2")
    lead = math.prod(x.shape[:ax])
    d = math.prod(x.shape[ax + 1:])
    return x.reshape((lead, size) if d == 1 else (lead, size, d))


def permute_axis(x: torch.Tensor, bmmc: Bmmc, *, axis: int = -1,
                 engine: Union[str, None] = "ref") -> torch.Tensor:
    """Apply one BMMC permutation along ``axis`` of an arbitrary tensor.

    ``x.shape[axis]`` must equal ``2^bmmc.n``. Differentiable (the VJP is
    the offline-inverse permutation through the same engine). On the
    ``"cuda"`` engine a CUDA tensor runs the class-dispatched kernels, a
    CPU tensor their plain versions.
    """
    ax = axis % x.dim()
    if x.shape[ax] != bmmc.size:
        raise ValueError(f"axis {axis} has length {x.shape[ax]}, "
                         f"BMMC needs {bmmc.size}")
    y = perm_apply(_collapse_axis(x, ax), bmmc, engine, True)
    return y.reshape(x.shape)


class PermuteLayer(nn.Module):
    """Applies a compiled BMMC combinator program along one tensor axis.

    ``perm`` is a :class:`Bmmc` or any combinator :class:`Expr`; ``axis``
    selects the permuted axis (its length must be the program's ``2^n``).
    The layer holds no parameters — construct it once so the
    compiled-plan caches stay warm.
    """

    def __init__(self, perm: Union[Bmmc, Expr], *, axis: int = -1,
                 engine="cuda", optimize: bool = True):
        super().__init__()
        self.expr = Perm(perm) if isinstance(perm, Bmmc) else perm
        self.axis = axis
        self.engine = engine
        self.optimized = optimize
        self.compiled = compile_expr(self.expr, engine=engine,
                                     optimize=optimize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x3 = _collapse_axis(x, self.axis)
        return self.compiled(x3, batched=True).reshape(x.shape)

    def inverse(self, n: Optional[int] = None) -> "PermuteLayer":
        """The inverse layer (permutation-only programs).

        ``n`` may be omitted when the expression pins its own size.
        """
        if n is None:
            n = self.expr.size_bits()
            if n is None:
                raise ValueError("size-polymorphic expression: pass n")
        inv = seq(*self.compiled.vjp_program(n))
        return PermuteLayer(inv, axis=self.axis, engine=self.engine,
                            optimize=self.optimized)
