"""Lazy BMMC expression IR (the "first step towards array combinators").

The counterpart of :mod:`repro.combinators.ir`, with the same nodes and
the same semantics.

An ``Expr`` is a *description* of a size-preserving transformation on an
array of 2^n elements (optionally with a trailing feature dim). Nothing
executes at construction time: expressions are lowered to a flat *stage
program* by :mod:`repro.combinators.optimize` and compiled/executed by
:mod:`repro.combinators.execute`.

Node kinds
----------

Primitive stages (survive lowering; a lowered program is a tuple of these):

* ``Perm(bmmc)``   — the affine index permutation ``out[A i ^ c] = x[i]``.
* ``CmpHalves()``  — ``out[:h] = min(x[:h], x[h:]); out[h:] = max`` — the
  full-width compare-exchange sweep of sorting networks (paper §7.1).
* ``Bfly(w)``      — radix-2 butterfly between halves with per-pair complex
  twiddles: ``out[:h] = lo + w*hi; out[h:] = lo - w*hi``.
* ``Map(name, fn)``— an elementwise (position-independent) function on
  torch tensors.

Structured nodes (eliminated by lowering):

* ``Id()``             — the identity.
* ``Seq(fs)``          — sequential pipeline; ``fs[0]`` is applied first.
* ``Two(f)``           — apply ``f`` independently to the two *contiguous*
  halves (the paper's ``two`` combinator; split on the top index bit).
* ``Ilv(f)``           — apply ``f`` to the even- and odd-indexed
  interleaved sub-arrays (the paper's ``ilv``; split on the bottom bit).
* ``ParmE(mask, f)``   — the general ``parm`` (paper §7): split by the F2
  inner product ``i·mask``; generalizes ``Two`` (mask = 2^(n-1)) and
  ``Ilv`` (mask = 1).

All nodes are frozen, hashable dataclasses, so expressions can key the
compiled-plan cache. ``Map`` hashes by its ``name`` only — the name must
uniquely identify the function. Each node computes its hash once and
keeps it: a 2^22-point FFT expression holds millions of twiddles, and
every plan-cache lookup hashes the expression.

Composition reads left to right: ``a >> b`` means "apply ``a``, then
``b``" (pipeline order, matching how stage programs execute).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

from ..core.bmmc import Bmmc


def _node(cls):
    """A frozen dataclass whose hash is computed once and kept."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    field_hash = cls.__hash__

    def __hash__(self):
        h = self.__dict__.get("_hash")
        if h is None:
            h = field_hash(self)
            object.__setattr__(self, "_hash", h)
        return h

    cls.__hash__ = __hash__
    return cls


class Expr:
    """Base class for all IR nodes."""

    def __rshift__(self, other: "Expr") -> "Expr":
        return seq(self, other)

    def size_bits(self) -> int | None:
        """The array size 2^n this node requires, or None if polymorphic."""
        return None


@_node
class Perm(Expr):
    """Primitive: BMMC index permutation ``out[A i ^ c] = x[i]``.

    ``bmmc_class(t)`` exposes the kernel-class hierarchy of the
    underlying BMMC (identity < complement < block < lane < tiled <
    general; DESIGN.md §11) — the optimizer folds the free classes
    (complement / block) into a neighbouring stage's DMA maps, and the
    executor dispatches the rest to class-specialized kernels.
    """

    bmmc: Bmmc

    def size_bits(self):
        return self.bmmc.n

    def bmmc_class(self, t: int) -> str:
        return self.bmmc.bmmc_class(t)


@_node
class CmpHalves(Expr):
    """Primitive: one full-width min/max sweep between the two halves."""


@_node
class Bfly(Expr):
    """Primitive: butterfly between halves, ``(lo + w·hi, lo - w·hi)``.

    ``twiddles`` is a tuple of 2^(n-1) python complex numbers (hashable,
    offline). Arrays may be complex, or float with a trailing dim of 2
    holding (re, im) — the layout the tiled kernels prefer.
    """

    twiddles: Tuple[complex, ...]

    def size_bits(self):
        return len(self.twiddles).bit_length()  # 2^(n-1) pairs -> n


@_node
class Map(Expr):
    """Primitive: elementwise function on torch tensors. Hashes/compares
    by ``name``."""

    name: str
    fn: Callable = dataclasses.field(compare=False, hash=False, repr=False)


@_node
class Id(Expr):
    """Structured: the identity transformation."""


@_node
class Seq(Expr):
    """Structured: pipeline; ``fs[0]`` applied first."""

    fs: Tuple[Expr, ...]

    def size_bits(self):
        for f in self.fs:
            n = f.size_bits()
            if n is not None:
                return n
        return None


@_node
class Two(Expr):
    """Structured: apply ``f`` to each contiguous half (top-bit split)."""

    f: Expr

    def size_bits(self):
        n = self.f.size_bits()
        return None if n is None else n + 1


@_node
class Ilv(Expr):
    """Structured: apply ``f`` to evens and odds (bottom-bit split)."""

    f: Expr

    def size_bits(self):
        n = self.f.size_bits()
        return None if n is None else n + 1


@_node
class ParmE(Expr):
    """Structured: the general ``parm mask f`` (paper §7.2)."""

    mask: int
    f: Expr

    def __post_init__(self):
        if self.mask <= 0:
            raise ValueError("parm mask must be positive")

    def size_bits(self):
        n = self.f.size_bits()
        return None if n is None else n + 1


Compose = Seq  # paper-facing alias for the sequential-composition node

PRIMITIVES = (Perm, CmpHalves, Bfly, Map)


def seq(*fs: Expr) -> Expr:
    """Sequential composition, flattening nested ``Seq`` and dropping ``Id``."""
    flat: list = []
    for f in fs:
        if isinstance(f, Seq):
            flat.extend(f.fs)
        elif not isinstance(f, Id):
            flat.append(f)
    if not flat:
        return Id()
    if len(flat) == 1:
        return flat[0]
    return Seq(tuple(flat))
