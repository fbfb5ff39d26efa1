"""F2 (GF(2)) linear algebra on bit-packed binary matrices.

An (n, n) binary matrix is represented as a tuple of ``n`` Python ints:
``rows[i]`` is the bitmask of row ``i`` (bit ``j`` set <=> A[i, j] = 1).
Row/column index 0 corresponds to the least significant index bit, matching
the paper's convention ``y_i = sum_j a_ij x_j + c_i``.

Everything here is *offline* (trace-time) machinery, mirroring the paper's
offline setting: matrices are known before kernels are generated.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence

Rows = tuple  # tuple[int, ...]


class SingularError(ValueError):
    """Raised when a matrix expected to be invertible is singular."""


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def identity(n: int) -> Rows:
    return tuple(1 << i for i in range(n))


def zero(n: int) -> Rows:
    return tuple(0 for _ in range(n))


def from_perm(p: Sequence[int]) -> Rows:
    """Permutation matrix P with P[i, j] = 1 iff i = p(j) (paper eq. in §3).

    Applying P to an index vector x gives y with y_{p(j)} = x_j.
    """
    n = len(p)
    rows = [0] * n
    for j, pj in enumerate(p):
        rows[pj] |= 1 << j
    return tuple(rows)


def reversal(n: int) -> Rows:
    """Bit-reversal matrix R (anti-diagonal identity). R @ R = I."""
    return tuple(1 << (n - 1 - i) for i in range(n))


def from_dense(mat: Sequence[Sequence[int]]) -> Rows:
    return tuple(sum((int(v) & 1) << j for j, v in enumerate(row)) for row in mat)


def to_dense(rows: Rows) -> list:
    n = len(rows)
    return [[(rows[i] >> j) & 1 for j in range(n)] for i in range(n)]


# ---------------------------------------------------------------------------
# Basic operations
# ---------------------------------------------------------------------------

def parity(x: int) -> int:
    return bin(x).count("1") & 1


def matvec(rows: Rows, x: int) -> int:
    """y = A x over F2 (x, y are bit-packed index vectors)."""
    y = 0
    for i, r in enumerate(rows):
        y |= parity(r & x) << i
    return y


def matmul(a: Rows, b: Rows) -> Rows:
    """C = A @ B over F2. Row i of C = XOR of rows j of B where A[i, j] = 1."""
    out = []
    for ra in a:
        acc = 0
        j = 0
        r = ra
        while r:
            if r & 1:
                acc ^= b[j]
            r >>= 1
            j += 1
        out.append(acc)
    return tuple(out)


def transpose(rows: Rows) -> Rows:
    n = len(rows)
    out = [0] * n
    for i, r in enumerate(rows):
        for j in range(n):
            if (r >> j) & 1:
                out[j] |= 1 << i
    return tuple(out)


def column(rows: Rows, j: int) -> int:
    """Column j as a bitmask over row indices."""
    out = 0
    for i, r in enumerate(rows):
        if (r >> j) & 1:
            out |= 1 << i
    return out


def rank(rows: Rows) -> int:
    rs = [r for r in rows if r]
    rk = 0
    while rs:
        piv = rs.pop()
        if piv == 0:
            continue
        rk += 1
        low = piv & -piv
        rs = [(r ^ piv) if (r & low) else r for r in rs]
        rs = [r for r in rs if r]
    return rk


def is_invertible(rows: Rows) -> bool:
    return rank(rows) == len(rows)


def inverse(rows: Rows) -> Rows:
    """Gauss-Jordan inverse over F2; raises SingularError if singular."""
    n = len(rows)
    a = list(rows)
    inv = list(identity(n))
    for col in range(n):
        piv = None
        for i in range(col, n):
            if (a[i] >> col) & 1:
                piv = i
                break
        if piv is None:
            raise SingularError(f"matrix is singular (column {col})")
        a[col], a[piv] = a[piv], a[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for i in range(n):
            if i != col and ((a[i] >> col) & 1):
                a[i] ^= a[col]
                inv[i] ^= inv[col]
    return tuple(inv)


def to_perm(rows: Rows) -> Optional[list]:
    """If A is a permutation matrix, return p with P[i,j]=1 iff i=p(j); else None."""
    n = len(rows)
    p = [-1] * n
    seen = 0
    for i, r in enumerate(rows):
        if r == 0 or (r & (r - 1)):  # not exactly one bit
            return None
        j = r.bit_length() - 1
        if (seen >> j) & 1:
            return None
        seen |= 1 << j
        p[j] = i
    return p


def nullspace(rows: Sequence[int], ncols: int) -> list:
    """Basis of ``{x in F2^ncols : M x = 0}`` for a (possibly rectangular)
    matrix given as row bitmasks. Each basis vector is an ``ncols``-bit int.

    This is the workhorse of the *generalized* tiled planner (§5.1
    extended): the kernel of the high rows ``A[t:, :]`` of an invertible
    BMMC always has dimension ``t``, and any basis of it serves as the
    witness *directions* where the paper demands witness *columns*.
    """
    pivots: dict = {}  # pivot column -> index into ``red``
    red: list = []
    for r in rows:
        for c, ri in pivots.items():
            if (r >> c) & 1:
                r ^= red[ri]
        if r:
            c = (r & -r).bit_length() - 1
            pivots[c] = len(red)
            red.append(r)
    for c, ri in pivots.items():  # back-substitute to reduced echelon
        for ri2 in range(len(red)):
            if ri2 != ri and (red[ri2] >> c) & 1:
                red[ri2] ^= red[ri]
    basis = []
    for fc in range(ncols):
        if fc in pivots:
            continue
        v = 1 << fc
        for c, ri in pivots.items():
            if (red[ri] >> fc) & 1:
                v |= 1 << c
        basis.append(v)
    return basis


def in_span(v: int, gens: Sequence[int]) -> bool:
    """Is ``v`` in the F2 span of ``gens`` (arbitrary generating set)?"""
    red: list = []
    for g in gens:
        for r in red:
            if g & (r & -r):
                g ^= r
        if g:
            red.append(g)
    for r in red:
        if v & (r & -r):
            v ^= r
    return v == 0


# ---------------------------------------------------------------------------
# Triangularity predicates (row i, col j; "upper" = support on j >= i)
# ---------------------------------------------------------------------------

def is_upper(rows: Rows) -> bool:
    return all((r & ((1 << i) - 1)) == 0 for i, r in enumerate(rows))


def is_lower(rows: Rows) -> bool:
    n = len(rows)
    return all((r >> (i + 1)) == 0 for i, r in enumerate(rows))


def is_unit_diag(rows: Rows) -> bool:
    return all((r >> i) & 1 for i, r in enumerate(rows))


# ---------------------------------------------------------------------------
# Decompositions
# ---------------------------------------------------------------------------

def lup(m: Rows) -> tuple[Rows, Rows, Rows]:
    """Column-pivoted LU: returns (L, U, P) with  M = L @ U @ P  over F2.

    L is unit lower triangular, U is upper triangular (unit diagonal after
    pivoting), P is a permutation matrix. Requires M invertible.
    """
    n = len(m)
    a = list(m)
    colperm = list(range(n))  # colperm[k] = original column placed at position k
    lrows = list(identity(n))
    for k in range(n):
        # find pivot column among positions k..n-1 such that a[k] has a 1 there
        piv = None
        for jpos in range(k, n):
            if (a[k] >> colperm[jpos]) & 1:
                piv = jpos
                break
        if piv is None:
            raise SingularError("matrix is singular during LUP")
        colperm[k], colperm[piv] = colperm[piv], colperm[k]
        pk = colperm[k]
        for i in range(k + 1, n):
            if (a[i] >> pk) & 1:
                a[i] ^= a[k]
                lrows[i] ^= lrows[k]  # accumulate: L_inv_ops; fix below
    # After elimination: E @ M = U' where U' is upper in the *permuted* column
    # order, and lrows tracks E (product of elementary adds) applied to I.
    # So M = E^-1 @ U'.  U' in permuted order: U'[:, pos k] = a[:, colperm[k]].
    e = tuple(lrows)
    l = inverse(e)  # unit lower triangular
    # Build U in position space: U[i, k] = a[i, colperm[k]]
    urows = []
    for i in range(n):
        r = 0
        for kpos in range(n):
            if (a[i] >> colperm[kpos]) & 1:
                r |= 1 << kpos
        urows.append(r)
    u = tuple(urows)
    # Column permutation matrix C such that (X @ C)[:, k] = X[:, colperm[k]]:
    # C[j, k] = 1 iff j = colperm[k]  i.e. C = from_perm(q) with q(k)=colperm[k].
    # Then  M @ C = L @ U  =>  M = L @ U @ C^-1 ; C^-1 = C^T.
    c = from_perm([colperm[k] for k in range(n)])
    p = transpose(c)
    return l, u, p


def ulp(m: Rows) -> tuple[Rows, Rows, Rows]:
    """Paper §5.2 decomposition: returns (U, L, P) with  M = U @ L @ P.

    Computed by conjugating the column-pivoted LUP of R @ M with the
    bit-reversal matrix R:  R M = L' U' P'  =>  M = (R L' R)(R U' R)(R P').
    """
    n = len(m)
    r = reversal(n)
    l_, u_, p_ = lup(matmul(r, m))
    u = matmul(r, matmul(l_, r))
    l = matmul(r, matmul(u_, r))
    p = matmul(r, p_)
    # p must remain a permutation matrix (reversal of a permutation is one).
    return u, l, p


# ---------------------------------------------------------------------------
# Tiled-BMMC column finding (paper §5.1)
# ---------------------------------------------------------------------------

def _greedy_independent(rows: Rows, t: int, order: list) -> Optional[list]:
    low_mask = (1 << t) - 1
    basis: list = []
    chosen: list = []
    for j in order:
        v = column(rows, j) & low_mask
        for bv in basis:
            low = bv & -bv
            if v & low:
                v ^= bv
        if v:
            basis.append(v)
            chosen.append(j)
            if len(chosen) == t:
                return sorted(chosen)
    return None


def tiled_columns(rows: Rows, t: int, prefer_contiguous: bool = True) -> Optional[list]:
    """Find columns i_1..i_t making A a *tiled* BMMC for tile size 2^t.

    Requirements (paper §5.1): the submatrix of the first ``t`` rows on those
    columns is invertible, and the submatrix of the last ``n - t`` rows on
    those columns is zero. Returns the column list or None.

    ``prefer_contiguous`` (perf: kernel hillclimb iteration 3) biases the
    greedy independent-set search toward *contiguous runs* of candidate
    positions: each contiguous group of tile-row bit positions above ``t``
    collapses into one DMA stride dimension, so fewer groups means fewer
    descriptors (any valid witness is equally correct — this only changes
    which one we pick).
    """
    n = len(rows)
    if t > n:
        return None
    low_mask = (1 << t) - 1
    # candidate columns: support contained in the first t rows
    cands = [j for j in range(n)
             if (column(rows, j) >> t) == 0 and (column(rows, j) & low_mask)]
    if prefer_contiguous and len(cands) > t:
        # longest contiguous candidate runs first (preferring high positions,
        # which are thread-block-bit friendly), then the rest
        runs: list = []
        for j in sorted(cands):
            if runs and j == runs[-1][-1] + 1:
                runs[-1].append(j)
            else:
                runs.append([j])
        order = [j for run in sorted(runs, key=lambda r: (-len(r), -r[0]))
                 for j in run]
        got = _greedy_independent(rows, t, order)
        if got is not None:
            return got
    return _greedy_independent(rows, t, cands)


# ---------------------------------------------------------------------------
# Random generation (for tests / benchmarks; mirrors the paper's "random
# BPC / random BMMC" experiments)
# ---------------------------------------------------------------------------

def random_invertible(n: int, rng: random.Random) -> Rows:
    while True:
        rows = tuple(rng.randrange(1, 1 << n) for _ in range(n))
        if is_invertible(rows):
            return rows


def random_perm_matrix(n: int, rng: random.Random) -> Rows:
    p = list(range(n))
    rng.shuffle(p)
    return from_perm(p)
