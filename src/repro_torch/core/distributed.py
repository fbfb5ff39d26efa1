"""Distributed BMMC permutations over sharded arrays (beyond-paper).

The counterpart of :mod:`repro.core.distributed`: the planners below are
its numpy code as it is (their plans are equal round for round), and the
executor runs each rank's part on ``torch.distributed``.

For an array of 2^n elements sharded along the leading axis over 2^s
devices, the global index splits as x = (shard || local). This module
factors any global BMMC into a short sequence of *rounds*:

* ``LocalRound``   — per-shard BMMC on local indices, with a shard-dependent
                     complement (``c_eff = c ^ A_ls . shard``): zero
                     communication;
* ``PermuteRound`` — an affine relabeling of shards
                     (``shard' = S . shard ^ c_s``): one collective_permute;
* ``ExchangeRound``— swap the top-k local index bits with the low-k shard
                     bits: one (sub-axis) all_to_all.

Construction (generalizing paper §5.2 to the sharded setting): with the
F2 decomposition A = U L P and L = R U' R (R = bit reversal),

    A  =  U  ∘  R  ∘  U'  ∘  (R P)

where U, U' are shard-*separable* (upper-triangular => shard-out depends
only on shard-in) and R, RP are bit permutations, each of which lowers to
[permute, local, exchange(k), local, permute]. After fusing adjacent rounds
the worst case is **2 exchange rounds + 2 permute rounds + O(1) local
rounds** — the sharded analogue of the paper's two-pass theorem.

Every plan is verified *offline* by composing the rounds back into a global
BMMC (`plan_to_bmmc(plan) == A`). The executor (`run_plan`) runs on each
rank of a binary mesh (`binary_mesh`): rank σ holds shard σ, the global
rows [σ·2^(n-s), (σ+1)·2^(n-s)), and gets back its shard of the output.
A local round is a BMMC permutation through
:func:`repro_torch.kernels.ops.bmmc_permute` (the kernels on a card
tensor, their plain versions on a CPU tensor); a permute round is paired
``isend``/``irecv``; an exchange round is an ``all_to_all`` over the
ranks that share their upper s - k shard bits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np
import torch

from . import f2
from .bmmc import Bmmc


# ---------------------------------------------------------------------------
# Round IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalRound:
    n_local: int
    rows: tuple          # (n_local) x (n_local) local matrix
    c: int               # static complement
    ls_rows: tuple       # n_local rows over s shard bits: c_eff ^= ls . shard


@dataclasses.dataclass(frozen=True)
class PermuteRound:
    s: int
    rows: tuple          # s x s shard matrix
    c: int


@dataclasses.dataclass(frozen=True)
class ExchangeRound:
    k: int               # swap local bits [n_local-k, n_local) with shard bits [0, k)


Round = Union[LocalRound, PermuteRound, ExchangeRound]


# ---------------------------------------------------------------------------
# Rounds -> global BMMC (offline verification)
# ---------------------------------------------------------------------------

def round_to_bmmc(r: Round, n: int, s: int) -> Bmmc:
    nl = n - s
    if isinstance(r, LocalRound):
        rows = [r.rows[i] | (r.ls_rows[i] << nl) for i in range(nl)]
        rows += [1 << i for i in range(nl, n)]
        return Bmmc(tuple(rows), r.c)
    if isinstance(r, PermuteRound):
        rows = [1 << i for i in range(nl)]
        rows += [r.rows[i - nl] << nl for i in range(nl, n)]
        return Bmmc(tuple(rows), r.c << nl)
    # ExchangeRound: transpositions local nl-k+m <-> shard nl+m
    p = list(range(n))
    for m in range(r.k):
        p[nl - r.k + m], p[nl + m] = p[nl + m], p[nl - r.k + m]
    return Bmmc.from_perm(p)


def plan_to_bmmc(plan: List[Round], n: int, s: int) -> Bmmc:
    out = Bmmc.identity(n)
    for r in plan:
        out = round_to_bmmc(r, n, s) @ out
    return out


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

def _split_blocks(b: Bmmc, s: int):
    """A = [[A_ll, A_ls], [A_sl, A_ss]] in the (local, shard) basis."""
    n = b.n
    nl = n - s
    lmask = (1 << nl) - 1
    a_ll = tuple(b.rows[i] & lmask for i in range(nl))
    a_ls = tuple(b.rows[i] >> nl for i in range(nl))
    a_sl = tuple(b.rows[i] & lmask for i in range(nl, n))
    a_ss = tuple(b.rows[i] >> nl for i in range(nl, n))
    return a_ll, a_ls, a_sl, a_ss


def _separable_rounds(b: Bmmc, s: int) -> List[Round]:
    """b with A_sl == 0: local round then shard permute."""
    n = b.n
    nl = n - s
    a_ll, a_ls, a_sl, a_ss = _split_blocks(b, s)
    assert all(v == 0 for v in a_sl), "factor is not shard-separable"
    return [
        LocalRound(nl, a_ll, b.c & ((1 << nl) - 1), a_ls),
        PermuteRound(s, a_ss, b.c >> nl),
    ]


def _local_perm(positions_to_top: List[int], nl: int) -> list:
    """Local bit perm sending sorted(positions) to the top |positions| bits."""
    k = len(positions_to_top)
    rest = [j for j in range(nl) if j not in set(positions_to_top)]
    p = [0] * nl
    for i, j in enumerate(rest):
        p[j] = i
    for m, j in enumerate(sorted(positions_to_top)):
        p[j] = nl - k + m
    return p


def _bp_rounds(b: Bmmc, s: int) -> List[Round]:
    """Bit-permutation factor -> [permute, local, exchange, local, permute]."""
    n = b.n
    nl = n - s
    p = b.perm()
    assert p is not None and b.c == 0, "expected a BP factor"
    a2 = [j for j in range(nl) if p[j] >= nl]          # local -> shard
    b2 = [j for j in range(nl, n) if p[j] < nl]        # shard -> local
    k = len(a2)
    assert len(b2) == k
    rounds: List[Round] = []

    # sigma1: relabel shard bits so the departing ones (b2) occupy the
    # exchange window [0, k); the rest stack above in order.
    b2_bits = set(j - nl for j in b2)
    sig1 = [0] * s
    m = 0
    for j in sorted(b2_bits):
        sig1[j] = m
        m += 1
    fill = k
    for j in range(s):
        if j not in b2_bits:
            sig1[j] = fill
            fill += 1
    rounds.append(PermuteRound(s, f2.from_perm(sig1), 0))

    # L1: move the departing local bits (a2) to the top-k local positions
    l1 = _local_perm(a2, nl)
    rounds.append(LocalRound(nl, f2.from_perm(l1), 0, tuple([0] * nl)))

    if k:
        rounds.append(ExchangeRound(k))

    # solve the remainder: rho = b ∘ (sigma1;l1;X)^-1 must be block diagonal
    partial = plan_to_bmmc(rounds, n, s)
    rho = b @ partial.inverse()
    a_ll, a_ls, a_sl, a_ss = _split_blocks(rho, s)
    assert all(v == 0 for v in a_sl), "bp residue: shard<-local leak"
    assert all(v == 0 for v in a_ls), "bp residue: local<-shard leak"
    rounds.append(LocalRound(nl, a_ll, 0, tuple([0] * nl)))
    rounds.append(PermuteRound(s, a_ss, 0))
    return rounds


def _fuse(plan: List[Round], n: int, s: int) -> List[Round]:
    """Merge adjacent same-type rounds; drop identities."""
    nl = n - s
    out: List[Round] = []
    for r in plan:
        if out and isinstance(r, LocalRound) and isinstance(out[-1], LocalRound):
            prev = out[-1]
            rows = f2.matmul(r.rows, prev.rows)
            # combine: y = R2 (R1 x ^ L1 sigma ^ c1) ^ L2 sigma ^ c2
            ls_cols = []
            for bit in range(s):
                col_prev = sum(((prev.ls_rows[i] >> bit) & 1) << i
                               for i in range(nl))
                col_new = f2.matvec(r.rows, col_prev)
                col_new ^= sum(((r.ls_rows[i] >> bit) & 1) << i
                               for i in range(nl))
                ls_cols.append(col_new)
            ls = tuple(sum(((ls_cols[bit] >> i) & 1) << bit
                           for bit in range(s)) for i in range(nl))
            c = f2.matvec(r.rows, prev.c) ^ r.c
            out[-1] = LocalRound(nl, rows, c, ls)
        elif out and isinstance(r, PermuteRound) and isinstance(out[-1], PermuteRound):
            prev = out[-1]
            out[-1] = PermuteRound(s, f2.matmul(r.rows, prev.rows),
                                   f2.matvec(r.rows, prev.c) ^ r.c)
        else:
            out.append(r)
    cleaned = []
    for r in out:
        if isinstance(r, LocalRound) and r.rows == f2.identity(nl) \
                and r.c == 0 and all(v == 0 for v in r.ls_rows):
            continue
        if isinstance(r, PermuteRound) and r.rows == f2.identity(s) and r.c == 0:
            continue
        if isinstance(r, ExchangeRound) and r.k == 0:
            continue
        cleaned.append(r)
    return cleaned


def make_plan(bmmc: Bmmc, s: int) -> List[Round]:
    """Factor a global BMMC into rounds for 2^s leading-axis shards."""
    n = bmmc.n
    assert 0 < s < n
    a_ll, a_ls, a_sl, a_ss = _split_blocks(bmmc, s)
    if all(v == 0 for v in a_sl):
        plan = _separable_rounds(bmmc, s)
    else:
        u, l, p = f2.ulp(bmmc.rows)
        r = f2.reversal(n)
        u2 = f2.matmul(r, f2.matmul(l, r))            # upper (= R L R)
        rp = Bmmc(f2.matmul(r, p), 0)                 # BP
        plan = []
        plan += _bp_rounds(rp, s)
        plan += _separable_rounds(Bmmc(u2, 0), s)
        plan += _bp_rounds(Bmmc.bit_reverse(n), s)
        plan += _separable_rounds(Bmmc(u, bmmc.c), s)
    plan = _fuse(plan, n, s)
    got = plan_to_bmmc(plan, n, s)
    assert got.rows == bmmc.rows and got.c == bmmc.c, "plan verification failed"
    return plan


def plan_cost(plan: List[Round]) -> dict:
    return {
        "local": sum(isinstance(r, LocalRound) for r in plan),
        "permute": sum(isinstance(r, PermuteRound) for r in plan),
        "exchange": sum(isinstance(r, ExchangeRound) for r in plan),
        "exchange_bits": sum(r.k for r in plan if isinstance(r, ExchangeRound)),
    }




# ---------------------------------------------------------------------------
# Executor (each rank of a binary mesh)
# ---------------------------------------------------------------------------

def binary_mesh(s: int, *, device: str = "cuda"):
    """Mesh of 2^s ranks as s binary axes sb{s-1}..sb0 (msb first): rank
    σ = Σ sb_m·2^m holds shard σ."""
    from ..launch.mesh import Mesh
    names = tuple(f"sb{m}" for m in reversed(range(s)))
    return Mesh((2,) * s, names, device=device)


def _c_eff(r: LocalRound, s: int, shard: int) -> int:
    """The round's complement on shard σ: ``c ^ (ls · σ)``."""
    c = r.c
    for i, row in enumerate(r.ls_rows):
        c ^= f2.parity(row & shard) << i
    return c


def _permute_shards(xs, r: PermuteRound, s: int, shard: int, mesh):
    """Shard σ goes to shard ``S·σ ^ c``: one paired send and receive."""
    import torch.distributed as dist

    names_msb = tuple(f"sb{m}" for m in reversed(range(s)))
    dst = f2.matvec(r.rows, shard) ^ r.c
    src = f2.matvec(f2.inverse(r.rows), shard ^ r.c)
    if dst == shard:
        return xs

    def rank(sig):
        return mesh.rank_of({a: (sig >> m) & 1 for m, a in zip(
            reversed(range(s)), names_msb)})
    out = torch.empty_like(xs)
    ops = [dist.P2POp(dist.isend, xs.contiguous(), rank(dst)),
           dist.P2POp(dist.irecv, out, rank(src))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def run_plan(x, plan: List[Round], s: int, mesh=None):
    """Apply a distributed BMMC plan on this rank: ``x`` is its shard
    (shape (2^(n-s),) or (2^(n-s), d)); returns its shard of the output.
    ``mesh`` defaults to :func:`binary_mesh` on ``x``'s device type."""
    from ..kernels.ops import bmmc_permute
    from ..launch.mesh import all_to_all

    mesh = mesh or binary_mesh(s, device=x.device.type)
    names_msb = tuple(f"sb{m}" for m in reversed(range(s)))
    shard = mesh.index(names_msb)
    nl = int(np.log2(x.shape[0]))
    if x.shape[0] != 1 << nl:
        raise ValueError(f"a shard of {x.shape[0]} rows is not a power of 2")
    xs = x
    for r in plan:
        if isinstance(r, LocalRound):
            xs = bmmc_permute(xs, Bmmc(r.rows, _c_eff(r, s, shard)))
        elif isinstance(r, PermuteRound):
            xs = _permute_shards(xs, r, s, shard, mesh)
        else:  # ExchangeRound
            k = r.k
            tail = xs.shape[1:]
            xs2 = xs.reshape((1 << k, 1 << (nl - k)) + tail)
            ex_names = tuple(f"sb{m}" for m in reversed(range(k)))
            xs2 = all_to_all(xs2, mesh.group(ex_names))
            xs = xs2.reshape((1 << nl,) + tail)
    return xs


def distributed_bmmc(x, bmmc: Bmmc, s: int, mesh=None):
    """End-to-end: plan + execute a BMMC over a 2^s-sharded array (``x``
    this rank's shard)."""
    return run_plan(x, make_plan(bmmc, s), s, mesh)
