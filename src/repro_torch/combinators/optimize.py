"""Lowering and the §7.2 rewrite algebra for combinator expressions.

The counterpart of :mod:`repro.combinators.optimize`: the same passes,
the same programs and the same cost model, stage for stage.

``lower(expr, n)`` eliminates every structured node, producing a flat
tuple of primitive stages (``Perm`` / ``CmpHalves`` / ``Bfly`` / ``Map``):

* ``Seq``            — concatenation of the lowered parts.
* ``Two(f)``         — lower ``f`` on 2^(n-1) and *lift* each stage:
    - ``Perm(A)``    -> ``Perm(diag(A, 1))`` (block diagonal, top bit fixed),
    - ``Map``        -> unchanged (elementwise),
    - ``CmpHalves``  -> conjugated by the top-two-bit swap,
    - ``Bfly(w)``    -> conjugated by the swap, twiddles tiled (``w ++ w``).
* ``ParmE(mask, f)`` — paper §7.2: ``Perm(A_mask) ; lift(f) ; Perm(A_mask^-1)``
  with ``A_mask = parm_matrix`` (Fig. 13), i.e. ``parm`` reduces to ``two``
  conjugated by one BMMC on each side.
* ``Ilv(f)``         — sugar for ``ParmE(1, f)``.

``fuse(program)`` applies the rewrite algebra::

    bmmc B ∘ bmmc A          ->  bmmc (B A)          (fusion)
    bmmc A ∘ bmmc A^-1       ->  id                  (cancellation, via fusion)
    id                       ->  (dropped)

Fusion can only ever *merge or drop* ``Perm`` stages, so the optimized
program never has more permutation stages — and therefore never more
tiled kernel passes — than the raw lowering (tested property).

``cluster(program, n, t)`` goes one level deeper than ``fuse``: it groups
``Perm → compute → Perm → …`` runs into :class:`FusedStage` objects that
a single tiled megakernel pass can execute — the composed permutation is
applied by the pass's row loads + gather, and each interior compute
(``CmpHalves`` / ``Bfly`` / ``Map``) runs on the tile while it sits in
on-chip memory. A compute is *tile-local* (free to fuse) iff its pairing vector,
pulled back to input space through the perms preceding it in the run,
lies in the span of the composed plan's tile row/column bits — then both
elements of every compare/butterfly pair are resident in the same tile
and the compute costs zero extra HBM traffic (DESIGN.md §10).

On the H100 the tile is 2^t x 2^t elements at most (``ops.choose_tile``
fits it in 16 KiB of shared memory), so the clustering at the port's own
``t`` differs from the reference's at its larger ``t``; at equal ``t``
the two agree stage for stage.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

from ..core import f2
from ..core.bmmc import Bmmc
from ..core.parm import parm_matrix
from ..core.tiling import pairing_vector, pass_spans
from ..obs import metrics as _ometrics
from .ir import (Bfly, CmpHalves, Expr, Id, Ilv, Map, ParmE, Perm, Seq, Two,
                 PRIMITIVES)

Program = Tuple[Expr, ...]  # primitives only

COMPUTES = (CmpHalves, Bfly, Map)

# Budget for a Bfly twiddle-value table ((2^(n-1), 2) float32) read by
# the fused kernel; butterflies past it stay unfused. The reference held
# the table resident in 1 MiB of VMEM; the CUDA kernel reads it from
# device memory through the 50 MB L2 cache, so the port's budget is a
# table that fits L2 (up to 2^23 points). Up to 2^18 points both budgets
# admit every butterfly, so the two packages cluster alike there.
_W_TABLE_BYTES = 32 * 1024 * 1024


def _lift(stages: Program, n: int) -> Program:
    """Lift a program on 2^(n-1) arrays to act on both halves of 2^n."""
    swap = Bmmc.from_perm([*range(n - 2), n - 1, n - 2]) if n >= 2 else None
    out: List[Expr] = []
    for s in stages:
        if isinstance(s, Perm):
            rows = tuple(s.bmmc.rows) + (1 << (n - 1),)
            out.append(Perm(Bmmc(rows, s.bmmc.c)))
        elif isinstance(s, Map):
            out.append(s)
        elif isinstance(s, CmpHalves):
            out.extend([Perm(swap), CmpHalves(), Perm(swap)])
        elif isinstance(s, Bfly):
            out.extend([Perm(swap), Bfly(s.twiddles + s.twiddles), Perm(swap)])
        else:  # pragma: no cover - lower() only emits primitives
            raise TypeError(f"cannot lift {type(s).__name__}")
    return tuple(out)


def lower(expr: Expr, n: int) -> Program:
    """Flatten ``expr`` (on arrays of 2^n) into primitive stages."""
    if isinstance(expr, Id):
        return ()
    if isinstance(expr, Seq):
        out: List[Expr] = []
        for f in expr.fs:
            out.extend(lower(f, n))
        return tuple(out)
    if isinstance(expr, Two):
        if n < 1:
            raise ValueError("Two needs n >= 1")
        return _lift(lower(expr.f, n - 1), n)
    if isinstance(expr, Ilv):
        return lower(ParmE(1, expr.f), n)
    if isinstance(expr, ParmE):
        if not expr.mask < (1 << n):
            raise ValueError(f"parm mask {expr.mask:#x} out of range for n={n}")
        a = parm_matrix(n, expr.mask)
        body = _lift(lower(expr.f, n - 1), n)
        return (Perm(a),) + body + (Perm(a.inverse()),)
    if isinstance(expr, Perm):
        if expr.bmmc.n != n:
            from ..guard.errors import BadInput
            raise BadInput(f"Perm is on {expr.bmmc.n} bits, array has {n}")
        return (expr,)
    if isinstance(expr, Bfly):
        if expr.size_bits() != n:
            from ..guard.errors import BadInput
            raise BadInput(
                f"Bfly is on {expr.size_bits()} bits, array has {n}")
        return (expr,)
    if isinstance(expr, PRIMITIVES):
        return (expr,)
    raise TypeError(f"unknown Expr node {type(expr).__name__}")


def fuse(program: Sequence[Expr]) -> Program:
    """Fuse adjacent ``Perm`` stages and drop identity permutations."""
    out: List[Expr] = []
    for s in program:
        if isinstance(s, Perm) and out and isinstance(out[-1], Perm):
            out[-1] = Perm(s.bmmc @ out[-1].bmmc)
        else:
            out.append(s)
    return tuple(s for s in out
                 if not (isinstance(s, Perm) and s.bmmc.is_identity_perm()))


def optimize(expr: Expr, n: int) -> Program:
    """Lower and fuse: the full offline pipeline."""
    return fuse(lower(expr, n))


# ---------------------------------------------------------------------------
# Fused-stage clustering (the megakernel grouping pass)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedStage:
    """A ``Perm → compute → … → Perm`` run executable as ONE tiled pass.

    ``stages`` is the original primitive run (the oracle / fallback / VJP
    replay path executes it stage-at-a-time); ``bmmc`` the composed
    permutation the megakernel's DMA+gather realizes; ``computes`` the
    interior compute stages paired with the *prefix* permutation (the
    composition of the run's perms before them) whose output index space
    they act in. Hashable, so fused programs can key plan caches.
    """

    stages: Program
    bmmc: Bmmc
    computes: Tuple[Tuple[Expr, Bmmc], ...]

    def size_bits(self) -> int:
        return self.bmmc.n


def _run_fused(stages: Sequence[Expr], n: int) -> FusedStage:
    """Build the FusedStage for a validated run."""
    prefix = Bmmc.identity(n)
    computes: List[tuple] = []
    for s in stages:
        if isinstance(s, Perm):
            prefix = s.bmmc @ prefix
        else:
            computes.append((s, prefix))
    return FusedStage(tuple(stages), prefix, tuple(computes))


def _run_valid(stages: Sequence[Expr], n: int, t: int) -> bool:
    """Can this run execute as one fused megakernel dispatch?

    The composed permutation runs as its tiled passes (ONE for any BMMC
    the classic or generalized witness-direction planner takes — i.e.
    always when 2t <= n — else the §5.2 two-pass factorization), and
    every interior compute must be tile-local *in the first pass*: its
    pairing vector ``A_M^{-1} e_{n-1}`` (``M`` = prefix perms), pulled
    back to input space, lies in the span of the first pass's tile
    directions (witness directions plus the low lane bits), so both
    halves of every pair land in the same on-chip tile. (Computes are
    applied to the input tile before the first gather — a permutation
    only moves values, so a compute pulled back through its prefix
    commutes exactly.) ``Map`` is elementwise and always local; ``Bfly``
    additionally gates on its twiddle table fitting ``_W_TABLE_BYTES``.
    """
    fs = _run_fused(stages, n)
    spans = pass_spans(fs.bmmc, t)
    if spans is None:
        return False
    first = spans[0]
    for comp, prefix in fs.computes:
        if isinstance(comp, Map):
            continue
        if isinstance(comp, Bfly):
            if len(comp.twiddles) * 8 > _W_TABLE_BYTES:
                return False
        if not f2.in_span(pairing_vector(prefix), first):
            return False
    return True


def cluster(program: Sequence[Expr], n: int,
            t: Optional[int]) -> Tuple[Expr, ...]:
    """Greedily group runs of a fused program into :class:`FusedStage`\\ s.

    Starting at each ``Perm`` — or at a *compute* whose pairing vector
    is already tile-local in the following permutation's first pass
    (prefix = identity), so it rides that pass's tiles instead of paying
    its own elementwise HBM sweep — the run is extended one stage at a
    time, or by a ``(compute, Perm)`` pair when the compute only becomes
    tile-local under the *longer* composition, while :func:`_run_valid`
    holds. ``t=None`` (array too small to tile) disables clustering.
    Stages outside any run pass through unchanged, so ``cluster`` is the
    identity on programs the megakernel cannot speed up.
    """
    prog = tuple(program)
    if t is None:
        return prog
    out: List[Expr] = []
    i = 0
    while i < len(prog):
        s = prog[i]
        run: List[Expr] = []
        j = i
        if isinstance(s, COMPUTES):
            # leading computes: absorb the longest suffix of the compute
            # block that is tile-local in the next Perm's first pass
            k = i
            while k < len(prog) and isinstance(prog[k], COMPUTES):
                k += 1
            if k < len(prog) and isinstance(prog[k], Perm):
                for start in range(i, k):
                    cand = list(prog[start:k + 1])
                    if _run_valid(cand, n, t):
                        out.extend(prog[i:start])
                        run = cand
                        j = k + 1
                        break
            if not run:
                out.append(s)
                i += 1
                continue
        elif isinstance(s, Perm):
            run = [s]
            j = i + 1
        else:
            out.append(s)
            i += 1
            continue
        while j < len(prog):
            if _run_valid(run + [prog[j]], n, t):
                run.append(prog[j])
                j += 1
            elif (isinstance(prog[j], COMPUTES) and j + 1 < len(prog)
                  and isinstance(prog[j + 1], Perm)
                  and _run_valid(run + [prog[j], prog[j + 1]], n, t)):
                run.extend((prog[j], prog[j + 1]))
                j += 2
            else:
                break
        if len(run) == 1:
            out.append(s)
            i += 1
        else:
            # telemetry: planner decisions, recorded at plan time (the
            # clustered-program cache makes this once per (expr, n, t))
            _ometrics.inc("optimize.clusters")
            _ometrics.inc("optimize.cluster_stages_absorbed", len(run))
            out.append(_run_fused(run, n))
            i = j
    return tuple(out)


# ---------------------------------------------------------------------------
# Free-stage folding (DESIGN.md §11): complement-only and tile-index-only
# permutations never deserve their own HBM round trip — a complement
# changes only the affine offset of a neighbouring stage's DMA source
# map (same matrix, same tile geometry), and a tile-index-only
# permutation relabels whole rows, which the neighbouring pass's
# ``in_rows``/``out_rows`` tables absorb verbatim.
# ---------------------------------------------------------------------------

FREE_CLASSES = ("complement", "block")


def _merge_stages(a: Expr, b: Expr) -> tuple:
    sa = a.stages if isinstance(a, FusedStage) else (a,)
    sb = b.stages if isinstance(b, FusedStage) else (b,)
    return tuple(sa) + tuple(sb)


def fold_free(program: Sequence[Expr], n: int,
              t: Optional[int]) -> Tuple[Expr, ...]:
    """Fold standalone free-class ``Perm`` stages (complement-only /
    tile-index-only at ``t``) into an adjacent ``Perm``/:class:
    `FusedStage`, so they cost zero HBM round trips.

    Folding into the *following* stage composes the free BMMC into that
    stage's DMA **source** map; folding into the *preceding* stage
    composes into its **output** map. Either way the merged run is
    re-validated with :func:`_run_valid` (a complement fold always
    passes — the composed matrix is unchanged — and a block fold passes
    whenever the composed plan keeps every compute tile-local), so the
    pass is conservative: stages that cannot fold stay standalone.
    """
    prog = list(program)
    if t is None:
        return tuple(prog)
    changed = True
    while changed:
        changed = False
        for i, s in enumerate(prog):
            if not isinstance(s, Perm):
                continue
            if s.bmmc.bmmc_class(t) not in FREE_CLASSES:
                continue
            for j in (i + 1, i - 1):
                if not 0 <= j < len(prog):
                    continue
                other = prog[j]
                if not isinstance(other, (Perm, FusedStage)):
                    continue
                merged = (_merge_stages(s, other) if j > i
                          else _merge_stages(other, s))
                if _run_valid(merged, n, t):
                    lo, hi = min(i, j), max(i, j)
                    prog[lo:hi + 1] = [_run_fused(merged, n)]
                    _ometrics.inc("optimize.fold_free_folds",
                                  cls=s.bmmc.bmmc_class(t))
                    changed = True
                    break
            if changed:
                break
    return tuple(prog)


def expand_clusters(program: Sequence[Expr]) -> Program:
    """Inverse of :func:`cluster`: replace FusedStages by their stages."""
    out: List[Expr] = []
    for s in program:
        if isinstance(s, FusedStage):
            out.extend(s.stages)
        else:
            out.append(s)
    return tuple(out)


def is_perm_program(program: Iterable[Expr]) -> bool:
    """True iff every stage is a ``Perm`` or a compute-free
    :class:`FusedStage` — the programs with an exact offline inverse
    (and therefore a fully precompiled backward pass, DESIGN.md §13)."""
    return all(isinstance(s, Perm)
               or (isinstance(s, FusedStage) and not s.computes)
               for s in program)


def inverse_stage(s: Expr) -> Expr:
    """The offline inverse of one permutation stage.

    A ``Perm``'s inverse is the offline F2-inverted BMMC. A compute-free
    :class:`FusedStage`'s inverse is a FusedStage of the inverted member
    stages in reverse order — its composed BMMC is ``bmmc.inverse()``,
    so it dispatches through the same megakernel machinery as the
    forward cluster (per-class closure: identity / complement / block /
    lane BMMCs invert within their class, and any invertible BMMC keeps
    its one-pass plan when ``2t <= n``, DESIGN.md §13). Compute-bearing
    clusters have no static inverse (``CmpHalves``' adjoint routes by
    the primal values); their backward is handled by the executor's
    pulled-back VJP instead (:func:`repro.combinators.execute.
    fused_apply`).
    """
    if isinstance(s, Perm):
        return Perm(s.bmmc.inverse())
    if isinstance(s, FusedStage) and not s.computes:
        return _run_fused(
            tuple(Perm(st.bmmc.inverse()) for st in reversed(s.stages)),
            s.bmmc.n)
    from ..guard.errors import BadStage
    raise BadStage(
        f"inverse_program needs a permutation-only program; "
        f"found {type(s).__name__}"
        + (" with compute stages" if isinstance(s, FusedStage) else ""))


def inverse_program(program: Sequence[Expr]) -> Program:
    """The exact inverse of a permutation-only program: stages reversed,
    each stage replaced by its offline inverse (``Perm`` → inverted
    BMMC; compute-free :class:`FusedStage` → the inverted cluster, see
    :func:`inverse_stage`) — so the inverse of a *clustered* program is
    itself clustered, mirroring the forward plan stage for stage.

    This is also the *VJP program* of the forward program — a BMMC
    permutation matrix is orthogonal over the reals, so its Jacobian
    transpose equals its inverse — which is what lets the executor's
    backward pass ride the same megakernel/class-dispatch executables
    as the forward (DESIGN.md §9/§13). Raises ``TypeError`` on
    non-``Perm`` stages (``CmpHalves`` is not invertible; ``Bfly``/
    ``Map`` have state-dependent adjoints handled by the executor's
    compute-VJP path instead).
    """
    return tuple(inverse_stage(s) for s in reversed(tuple(program)))


def num_perm_stages(program: Iterable[Expr]) -> int:
    return sum(isinstance(s, Perm) for s in program)


def program_cost(program: Sequence[Expr], t: int, itemsize: int = 4) -> dict:
    """Offline cost report: HBM round trips + DMA descriptors + per-class
    kernel counts.

    ``t`` is the tile parameter of the executing kernel. Each ``Perm``
    contributes its class-dispatched kernel — zero passes for an
    identity, ONE for block / lane / tiled / generalized-tiled, two only
    for the §5.2 fallback; each :class:`FusedStage` likewise, regardless
    of how many stages it swallowed (that is the megakernel's whole
    point); each *standalone* compute stage one full elementwise sweep
    (read + write of the array — what the per-stage jnp path pays).
    ``round_trips`` totals them; ``round_trips_unfused`` is the same
    program with every cluster expanded, so ``round_trips_saved`` is the
    megakernel's win as seen by the transaction model.

    ``kernels`` counts stage dispatches per kernel class (DESIGN.md §11
    — ``block``/``lane``/``tiled``/``general``/``general2`` for
    standalone ``Perm``\\ s, ``fused`` for megakernel clusters, which
    always run the tiled pipeline regardless of their composed BMMC's
    class, plus ``sweep`` for standalone computes); ``roofline_ratio``
    is modeled
    copy-kernel descriptors over program descriptors — 1.0 means the
    whole program runs at the speed of ``round_trips`` array copies.
    """
    from ..core.tiling import copy_descriptors
    from ..kernels.ops import modeled_transactions

    prog = tuple(program)
    n = None
    for s in prog:
        if isinstance(s, (Perm, FusedStage)):
            n = s.bmmc.n
            break
    passes = 0
    descriptors = 0
    bytes_moved = 0
    round_trips = 0
    compute_sweeps = 0
    fused_stages = 0
    kernels: dict = {}
    copy_desc = 0
    for s in prog:
        if isinstance(s, (Perm, FusedStage)):
            if isinstance(s, FusedStage):
                # a cluster always executes through the tiled megakernel
                # (it needs the gather + epilogue machinery), so model
                # its tiled passes — NOT the class fast path its composed
                # BMMC might qualify for standalone
                from ..core.tiling import stats_bmmc
                stats = stats_bmmc(s.bmmc, t)
                tx = {"passes": len(stats),
                      "descriptors": sum(p.dma_descriptors() for p in stats),
                      "bytes_moved": 2 * (1 << s.bmmc.n) * itemsize
                      * len(stats),
                      "kernel": "fused"}
                fused_stages += 1
            else:
                tx = modeled_transactions(s.bmmc, t, itemsize)
            passes += tx["passes"]
            round_trips += tx["passes"]
            descriptors += tx["descriptors"]
            bytes_moved += tx["bytes_moved"]
            kernels[tx["kernel"]] = kernels.get(tx["kernel"], 0) + 1
            copy_desc += copy_descriptors(s.bmmc.n) * tx["passes"]
        else:  # standalone compute: one full elementwise sweep over HBM
            compute_sweeps += 1
            round_trips += 1
            kernels["sweep"] = kernels.get("sweep", 0) + 1
            if n is not None:
                descriptors += copy_descriptors(n)
                copy_desc += copy_descriptors(n)
                bytes_moved += 2 * (1 << n) * itemsize
    cost = {
        "stages": len(prog),
        "perm_stages": num_perm_stages(prog),
        "fused_stages": fused_stages,
        "compute_sweeps": compute_sweeps,
        "tiled_passes": passes,
        "descriptors": descriptors,
        "bytes_moved": bytes_moved,
        "round_trips": round_trips,
        "kernels": kernels,
        "roofline_ratio": copy_desc / max(descriptors, 1),
    }
    if fused_stages:
        unfused = program_cost(expand_clusters(prog), t, itemsize)
        cost["round_trips_unfused"] = unfused["round_trips"]
        cost["round_trips_saved"] = (unfused["round_trips"]
                                     - cost["round_trips"])
    return cost
