"""Combinator vocabulary: named BMMC permutations and lifts as IR constructors.

The counterpart of :mod:`repro.combinators.vocab`, name for name.

Every function returns an :class:`~repro_torch.combinators.ir.Expr`; nothing
executes until :func:`~repro_torch.combinators.execute.compile_expr`. The pure
permutations are all BPCs, so each costs exactly one tiled kernel pass —
and adjacent ones fuse into a single BMMC by the optimizer.

Index conventions (array size 2^n, bit 0 = least significant):

* ``riffle``  — the perfect out-shuffle: ``[a..., b...] -> [a0, b0, a1,
  b1, ...]``; destination index = source index bits rotated left by 1.
* ``unriffle``/``evens_odds`` — its inverse: evens to the low half, odds
  to the high half.
* ``stride_permute(n, k)`` — gather with stride 2^k (destination bits =
  source bits rotated *right* by ``k``); ``stride_permute(n, 1) ==
  unriffle(n)`` and ``stride_permute(n, n-1) == riffle(n)``.
"""
from __future__ import annotations

from typing import Callable

from ..core.bmmc import Bmmc
from .ir import (Bfly, CmpHalves, Expr, Id, Ilv, Map, ParmE, Perm, Two,
                 seq)

__all__ = [
    "perm", "identity", "rev", "bit_reverse", "transpose", "riffle",
    "unriffle", "interleave", "evens_odds", "stride_permute", "rotate_bits",
    "xor_shift", "parm", "two", "ilv", "cmp_halves", "emap", "bfly", "seq",
]


def perm(bmmc: Bmmc) -> Expr:
    """An arbitrary BMMC permutation as an expression leaf."""
    return Perm(bmmc)


def identity() -> Expr:
    return Id()


def rev(n: int) -> Expr:
    """Array reversal: ``out[i] = x[2^n - 1 - i]`` (complement-only BPC)."""
    return Perm(Bmmc.reverse_array(n))


def bit_reverse(n: int) -> Expr:
    """Bit-reversal permutation (FFT input reordering)."""
    return Perm(Bmmc.bit_reverse(n))


def transpose(row_bits: int, col_bits: int) -> Expr:
    """Transpose of a (2^row_bits, 2^col_bits) row-major matrix."""
    return Perm(Bmmc.matrix_transpose(row_bits, col_bits))


def rotate_bits(n: int, k: int) -> Expr:
    """Destination index = source index bits rotated left by ``k``."""
    return Perm(Bmmc.rotate_bits(n, k % n)) if k % n else Id()


def stride_permute(n: int, k: int) -> Expr:
    """Stride-2^k gather (the classic L^{2^n}_{2^k} stride permutation):
    ``out[c·2^(n-k) + r] = x[r·2^k + c]`` — destination index = source
    index bits rotated right by ``k``. ``stride_permute(n, 1) ==
    unriffle(n)`` (evens first); ``stride_permute(n, n-1) == riffle(n)``."""
    return rotate_bits(n, n - (k % n))


def riffle(n: int) -> Expr:
    """Perfect out-shuffle: interleave the two halves, low half first."""
    return rotate_bits(n, 1)


def unriffle(n: int) -> Expr:
    """Inverse riffle: evens to the low half, odds to the high half."""
    return rotate_bits(n, n - 1)


def interleave(n: int) -> Expr:
    """Alias of :func:`riffle` (zip the halves together)."""
    return riffle(n)


def evens_odds(n: int) -> Expr:
    """Alias of :func:`unriffle` (unzip into evens then odds)."""
    return unriffle(n)


def xor_shift(n: int, c: int) -> Expr:
    """Pure complement: ``out[i ^ c] = x[i]``."""
    return Perm(Bmmc.xor_shift(n, c))


def parm(mask: int, f: Expr) -> Expr:
    """The paper's ``parm``: split by the F2 inner product ``i·mask``,
    apply ``f`` to both sub-arrays (paper §7)."""
    return ParmE(mask, f)


def two(f: Expr) -> Expr:
    """Apply ``f`` to each contiguous half (top-bit split)."""
    return Two(f)


def ilv(f: Expr) -> Expr:
    """Apply ``f`` to the even- and odd-indexed sub-arrays (bottom bit)."""
    return Ilv(f)


def cmp_halves() -> Expr:
    """Full-width compare-exchange sweep (sorting networks)."""
    return CmpHalves()


def emap(name: str, fn: Callable) -> Expr:
    """Elementwise map; ``name`` must uniquely identify ``fn`` (cache key)."""
    return Map(name, fn)


def bfly(twiddles) -> Expr:
    """Butterfly between halves with the given per-pair complex twiddles."""
    return Bfly(tuple(complex(w) for w in twiddles))
