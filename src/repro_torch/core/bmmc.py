"""BMMC (Bit Matrix Multiply Complement) index transformations.

A BMMC is an affine permutation of index space: ``y = A x (+) c`` over F2,
with ``A`` an invertible (n, n) binary matrix and ``c`` an n-bit complement
vector (paper §3). Sub-classes:

* BP  — A is a permutation matrix, c == 0 (e.g. bit-reversal, transpose).
* BPC — A is a permutation matrix, any c (e.g. array reversal).
* tiled BMMC — admits the single-pass tiled kernel (paper §5.1).
* general BMMC — factorizes into two tiled BMMCs (paper §5.2).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional, Sequence

from . import f2


@dataclasses.dataclass(frozen=True)
class Bmmc:
    """Affine index permutation ``y = A x ^ c`` on n-bit indices."""

    rows: tuple  # tuple[int, ...], bit-packed rows of A
    c: int = 0

    # -- constructors ------------------------------------------------------
    @staticmethod
    def identity(n: int) -> "Bmmc":
        return Bmmc(f2.identity(n), 0)

    @staticmethod
    def from_perm(p: Sequence[int], c: int = 0) -> "Bmmc":
        """BPC from a bit permutation p (y_{p(j)} = x_j) and complement c."""
        return Bmmc(f2.from_perm(p), c)

    @staticmethod
    def bit_reverse(n: int) -> "Bmmc":
        return Bmmc(f2.reversal(n), 0)

    @staticmethod
    def reverse_array(n: int) -> "Bmmc":
        """Array reversal: y = x ^ (2^n - 1) (paper §3 example)."""
        return Bmmc(f2.identity(n), (1 << n) - 1)

    @staticmethod
    def matrix_transpose(row_bits: int, col_bits: int) -> "Bmmc":
        """Transpose of a (2^row_bits, 2^col_bits) row-major matrix.

        Index = (i << col_bits) | j  ->  (j << row_bits) | i: a rotation of
        the index bits (generalizes the paper's 4x4 example).
        """
        n = row_bits + col_bits
        p = [(j + row_bits) % n for j in range(n)]
        return Bmmc.from_perm(p)

    @staticmethod
    def rotate_bits(n: int, k: int) -> "Bmmc":
        """y's bits are x's bits rotated left by k: y_{(i+k)%n} = x_i."""
        return Bmmc.from_perm([(i + k) % n for i in range(n)])

    @staticmethod
    def xor_shift(n: int, c: int) -> "Bmmc":
        return Bmmc(f2.identity(n), c & ((1 << n) - 1))

    @staticmethod
    def random_bpc(n: int, rng: random.Random) -> "Bmmc":
        return Bmmc(f2.random_perm_matrix(n, rng), rng.randrange(1 << n))

    @staticmethod
    def random(n: int, rng: random.Random) -> "Bmmc":
        return Bmmc(f2.random_invertible(n, rng), rng.randrange(1 << n))

    # -- basic properties ---------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def size(self) -> int:
        return 1 << self.n

    def __post_init__(self):
        if not f2.is_invertible(self.rows):
            raise f2.SingularError("BMMC matrix must be invertible")
        object.__setattr__(self, "c", self.c & ((1 << len(self.rows)) - 1))

    def apply(self, x: int) -> int:
        """y = A x ^ c for a single integer index."""
        return f2.matvec(self.rows, x) ^ self.c

    def verify(self) -> "Bmmc":
        """Re-prove well-formedness (bit ranges + F2 rank) through the
        guard subsystem, raising the typed
        :class:`repro_torch.guard.NotInvertible` on failure. ``__post_init__``
        ran the same rank check at construction, but an instance reaching
        the planner through a cache (or ``object.__setattr__``) may never
        have been constructed — plan-time validation calls this
        (guard ring 1)."""
        from ..guard.validate import verify_bmmc  # lazy: no core->guard cycle
        return verify_bmmc(self)

    def inverse(self) -> "Bmmc":
        """The inverse transformation: x = A^-1 (y ^ c) = A^-1 y ^ A^-1 c.
        Computed once per instance and kept beside it (its inverse is this
        instance)."""
        inv = self.__dict__.get("_inverse")
        if inv is None:
            ainv = f2.inverse(self.rows)
            inv = Bmmc(ainv, f2.matvec(ainv, self.c))
            object.__setattr__(inv, "_inverse", self)
            object.__setattr__(self, "_inverse", inv)
        return inv

    def compose(self, other: "Bmmc") -> "Bmmc":
        """self ∘ other: apply ``other`` first. (BA, B(c_A) ^ c_B)."""
        return Bmmc(
            f2.matmul(self.rows, other.rows),
            f2.matvec(self.rows, other.c) ^ self.c,
        )

    def __matmul__(self, other: "Bmmc") -> "Bmmc":
        return self.compose(other)

    def is_identity_perm(self) -> bool:
        """A == I and c == 0, tested once per instance and kept."""
        got = self.__dict__.get("_is_identity")
        if got is None:
            got = self.rows == f2.identity(self.n) and self.c == 0
            object.__setattr__(self, "_is_identity", got)
        return got

    # -- classification -----------------------------------------------------
    def perm(self) -> Optional[list]:
        """Bit permutation p if A is a permutation matrix, else None."""
        return f2.to_perm(self.rows)

    def is_bp(self) -> bool:
        return self.c == 0 and self.perm() is not None

    def is_bpc(self) -> bool:
        return self.perm() is not None

    def tiled_columns(self, t: int) -> Optional[list]:
        """Columns i_1..i_t witnessing tiled-ness (paper §5.1), or None."""
        return f2.tiled_columns(self.rows, t)

    def is_tiled(self, t: int) -> bool:
        return self.tiled_columns(t) is not None

    # -- class hierarchy (fast-path kernel dispatch) ---------------------------
    def is_complement_only(self) -> bool:
        """y = x ^ c: A is the identity (c may be 0 -> identity perm)."""
        return self.rows == f2.identity(self.n)

    def block_bits(self) -> int:
        """Largest k such that the permutation moves whole aligned 2^k
        blocks: the low k bits pass through untouched (``rows[i] == e_i``
        for ``i < k``, ``c`` zero on them) and no high output reads them
        (``rows[i]`` zero on the low k columns for ``i >= k``). 0 when
        the BMMC is not block-granular at any size."""
        n = self.n
        k = 0
        while (k < n and self.rows[k] == (1 << k)
               and not (self.c >> k) & 1):
            k += 1
        while k > 0:
            mask = (1 << k) - 1
            if all((self.rows[i] & mask) == 0 for i in range(k, n)):
                break
            k -= 1
        return k

    def is_tile_index_only(self, t: int) -> bool:
        """Whole 2^t rows move wholesale: the block-permute fast path
        (a block-remapped copy, no intra-tile gather)."""
        return 0 < t <= self.block_bits()

    def is_lane_local(self, t: int) -> bool:
        """Rows stay in place; each 2^t row is permuted identically in
        place by the same t-bit BMMC: the lane-permute fast path (single
        pass, on-chip row gather, no transpose pass)."""
        n = self.n
        if not 0 < t < n:
            return False
        return (all(self.rows[i] == (1 << i) for i in range(t, n))
                and (self.c >> t) == 0
                and all((self.rows[i] >> t) == 0 for i in range(t)))

    def bmmc_class(self, t: int) -> str:
        """The kernel class (most-specialized first):

        ``identity`` < ``complement`` < ``block`` < ``lane`` < ``tiled``
        < ``general``. Every class is also a member of all later classes
        (a complement is a BPC hence tiled; a tiled BMMC is general), so
        the classes *partition* BMMC space by first match.
        """
        if self.is_identity_perm():
            return "identity"
        if self.is_complement_only():
            return "complement"
        if self.is_tile_index_only(t):
            return "block"
        if self.is_lane_local(t):
            return "lane"
        if self.is_tiled(t):
            return "tiled"
        return "general"

    # -- factorization (paper §5.2) ------------------------------------------
    def factor_tiled(self, t: int) -> list:
        """Factor into tiled BMMCs to be applied *left to right*.

        Returns ``[self]`` if already tiled for tile size ``t``; otherwise
        uses A = U L P = (U R)(R L P): apply (RLP, 0) first, then (UR, c).
        Both factors are tiled for any t (UR via its last t columns; RLP via
        the images of the top-left anti-block), per paper §5.2 / Fig. 8.
        """
        if t >= self.n or self.is_tiled(t):
            return [self]
        u, l, p = f2.ulp(self.rows)
        r = f2.reversal(self.n)
        first = Bmmc(f2.matmul(r, f2.matmul(l, p)), 0)   # (R L P, 0)
        second = Bmmc(f2.matmul(u, r), self.c)            # (U R, c)
        assert first.is_tiled(t), "RLP factor must be tiled"
        assert second.is_tiled(t), "UR factor must be tiled"
        assert second.compose(first).rows == self.rows
        assert second.compose(first).c == self.c
        return [first, second]

    # -- pretty printing ------------------------------------------------------
    def __repr__(self) -> str:
        kind = "BP" if self.is_bp() else ("BPC" if self.is_bpc() else "BMMC")
        return f"{kind}(n={self.n}, c={self.c:#x})"
