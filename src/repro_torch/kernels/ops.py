"""Public BMMC permutation ops: planning, class dispatch, entry points.

The counterpart of :mod:`repro.kernels.ops`. ``bmmc_permute`` is the
user-facing entry point. Dispatch walks the class hierarchy
most-specialized-first:

* degenerate / tiny arrays                -> plain gather (ref oracle);
* identity                                -> no-op;
* tile-index-only (incl. high complement) -> block-permute kernel (K2);
* lane-local (incl. low complement)       -> lane-permute kernel (K3);
* tiled BMMC (incl. every BPC)            -> one tiled pass (K4a);
* general BMMC                            -> ONE generalized tiled pass,
                                             with the §5.2 two-pass
                                             factorization as fallback.

Plans and tables are built once per (matrix, t) on the host and cached;
their tables are uploaded to the device once per plan.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import guard as _guard
from ..core.bmmc import Bmmc
from ..core.tiling import (class_stats, copy_descriptors, dispatch_kernel,
                           plan_block, plan_bmmc, plan_lane)
from ..guard import runtime as _grt
from ..guard.errors import BadInput, UnknownEngine
from ..obs import metrics as _ometrics
from ..obs import trace as _otrace
from . import ref as _ref
from .bmmc_permute import (block_permute, check_no_grad, lane_permute,
                           tiled_permute)

# Shared-memory budget for one tile. The reference sized its tile for a
# 2 MiB VMEM buffer (t up to 12); a Hopper block has at most 227 KB of
# shared memory, and a 16 KiB tile leaves room for about a dozen resident
# blocks per SM to keep loads in flight. The worst case tile is
# 2^t x 2^t elements (n_over = 0): int32 gets t = 6, float32 with a d = 8
# tail t = 4.
_SMEM_TILE_BYTES = 16 * 1024
_MAX_T = 12


def choose_tile(n: int, itemsize: int, d: int = 1,
                t: Optional[int] = None) -> Optional[int]:
    """Pick n_tile: the LARGEST t whose worst-case (2^t x 2^t) tile fits
    the per-block shared-memory budget ``_SMEM_TILE_BYTES``.

    Returns None if the array is too small to be worth tiling (fallback to
    the reference gather).
    """
    return _choose_tile(n, itemsize, d, t)


@functools.lru_cache(maxsize=1024)
def _choose_tile(n: int, itemsize: int, d: int, t: Optional[int]):
    if t is not None:
        return t if 2 * t <= n else None
    t = _MAX_T
    while t > 1 and (1 << (2 * t)) * itemsize * d > _SMEM_TILE_BYTES:
        t -= 1
    t = min(t, n // 2)
    if t < 1:
        return None
    return t


@functools.lru_cache(maxsize=512)
def _plans_cached(rows: tuple, c: int, t: int) -> tuple:
    return tuple(plan_bmmc(Bmmc(rows, c), t))


def _build_class_plan(rows: tuple, c: int, t: int) -> tuple:
    """Derive the class dispatch and construct its payload tables."""
    bmmc = Bmmc(rows, c)
    kernel = dispatch_kernel(bmmc, t)
    if kernel == "none":
        return (kernel, ())
    if kernel == "block":
        return (kernel, plan_block(bmmc, t))
    if kernel == "lane":
        return (kernel, plan_lane(bmmc, t))
    return (kernel, _plans_cached(rows, c, t))


@functools.lru_cache(maxsize=512)
def _class_plan_cached(rows: tuple, c: int, t: int) -> tuple:
    """(kernel name, plan payload) for the class dispatch. The payload is
    the fast-path plan for "block"/"lane", the tiled pass tuple
    otherwise. Backed by the durable plan store when one is configured
    (``REPRO_STORE``, :mod:`repro_torch.store`): a disk hit is decoded and
    re-audited through guard ring 1 before it is trusted; an integrity
    failure quarantines the entry and falls through to fresh planning."""
    from .. import store as _store

    return _store.class_plan_through(
        rows, c, t, lambda: _build_class_plan(rows, c, t))


def bmmc_plans(bmmc: Bmmc, t: int):
    return _plans_cached(bmmc.rows, bmmc.c, t)


def class_plan(bmmc: Bmmc, t: int) -> tuple:
    """Class-dispatch decision: ``(kernel, payload)``; see
    :func:`repro_torch.core.tiling.dispatch_kernel` for the kernel names."""
    return _class_plan_cached(bmmc.rows, bmmc.c, t)


def class_dispatch(x: torch.Tensor, bmmc: Bmmc, t: Optional[int],
                   batched: bool) -> Optional[tuple]:
    """The full class-dispatch decision for this array: ``(kernel,
    payload)``, or None when the array is too small to tile (callers
    fall back to the reference gather).

    Telemetry hangs here as in the reference: one ``kernel.dispatch``
    span plus the per-kernel / per-class counters and the modeled
    descriptor / round-trip totals, from offline plans."""
    lead = 1 if batched else 0
    d = x.shape[1 + lead] if x.dim() == 2 + lead else 1
    teff = choose_tile(bmmc.n, x.element_size(), d, t)
    if teff is None:
        return None
    if not _otrace._state.enabled:
        return class_plan(bmmc, teff)
    with _otrace.span("kernel.dispatch", n=bmmc.n, t=teff) as sargs:
        got = class_plan(bmmc, teff)
        sargs["kernel"] = got[0]
        _ometrics.inc("dispatch.kernel", kernel=got[0])
        _ometrics.inc("dispatch.class", cls=bmmc.bmmc_class(teff))
        tx = modeled_transactions(bmmc, teff, x.element_size())
        _ometrics.inc("dma.descriptors", tx["descriptors"])
        _ometrics.inc("model.round_trips", tx["passes"])
    return got


def bmmc_permute(x: torch.Tensor, bmmc: Bmmc, *, t: Optional[int] = None,
                 engine: str = "cuda", batched: bool = False) -> torch.Tensor:
    """Permute ``x`` (shape (2^n,) or (2^n, d)) by ``out[A i ^ c] = x[i]``.

    ``engine``: "cuda" (class-dispatched kernels) or "ref" (plain
    gather). The kernels run on ``x``'s device: a CUDA tensor launches
    them (a build, load or launch failure raises), a CPU tensor runs
    their plain PyTorch versions. ``batched=True`` shifts the permuted
    axis to axis 1 — ``x`` is ``(B, 2^n)`` or ``(B, 2^n, d)`` and all batch
    rows share one plan. A non-contiguous ``x`` is made contiguous first.
    A tensor that requires grad raises ``NotImplementedError``: the
    kernels write through raw pointers, which autograd cannot see (the
    reference's ``pallas_call`` has no VJP either). Gradients of
    permutations run through :mod:`repro_torch.combinators`.

    With guards on (:func:`repro_torch.guard.enable`) the call is guarded
    (:func:`repro_torch.guard.runtime.guarded_bmmc_permute`): the guarded
    kernel variant and a parity probe write a device flag word that is
    read once here; a trap falls back from "cuda" to "ref".
    """
    check_no_grad(x, "bmmc_permute")
    if engine in ("cuda", "ref") and _guard.enabled():
        if _grt.ring2_active():
            return _grt.guarded_bmmc_permute(x, bmmc, t=t, engine=engine,
                                             batched=batched)
    return _bmmc_permute(x, bmmc, t=t, engine=engine, batched=batched)


def _bmmc_permute(x: torch.Tensor, bmmc: Bmmc, *, t: Optional[int] = None,
                  engine: str = "cuda", batched: bool = False) -> torch.Tensor:
    """:func:`bmmc_permute` past its guard: the class dispatch (the guarded
    variants when a guard flag word is active)."""
    lead = 1 if batched else 0
    if x.dim() <= lead or x.shape[lead] != bmmc.size:
        raise BadInput(f"bmmc_permute on 2^{bmmc.n} indices needs axis "
                       f"{lead} of length {bmmc.size}, got shape "
                       f"{tuple(x.shape)}")
    if engine == "ref":
        return _ref.bmmc_ref(x, bmmc, batched=batched)
    if engine != "cuda":
        raise UnknownEngine(f"unknown engine {engine!r} (cuda, ref)")
    if bmmc.is_identity_perm():
        _ometrics.inc("dispatch.kernel", kernel="none")
        return x
    got = class_dispatch(x, bmmc, t, batched)
    if got is None:
        return _ref.bmmc_ref(x, bmmc, batched=batched)
    kernel, payload = got
    x = x.contiguous()
    if kernel == "block":
        return block_permute(x, payload, batched=batched)
    if kernel == "lane":
        return lane_permute(x, payload, batched=batched)
    for plan in payload:
        x = tiled_permute(x, plan, batched=batched)
    return x


def num_passes(bmmc: Bmmc, t: int) -> int:
    """1 for every BMMC the one-pass planners take (tiled, generalized);
    2 only for the §5.2 fallback (t > n/2)."""
    return len(bmmc_plans(bmmc, t))


def make_bmmc_permute(bmmc: Bmmc, *, t: Optional[int] = None,
                      engine: str = "cuda"):
    """A unary function specialized to ``bmmc`` (the reference returns a
    jitted one; PyTorch runs eagerly, so this is a plain closure)."""
    def fn(x):
        return bmmc_permute(x, bmmc, t=t, engine=engine)
    return fn


# ---------------------------------------------------------------------------
# Transaction model — the offline counterpart of the paper's effective-
# bandwidth measurements.
# ---------------------------------------------------------------------------

def modeled_transactions(bmmc: Bmmc, t: int, itemsize: int = 4) -> dict:
    """DMA descriptor counts + bytes for the class-dispatched kernel vs a
    copy. ``class``/``kernel``/``roofline_ratio`` report the dispatch
    decision and the modeled fraction of copy-kernel descriptor
    throughput (1.0 == the permutation costs exactly an array copy)."""
    n = bmmc.n
    nbytes = (1 << n) * itemsize
    cs = class_stats(bmmc, t)
    passes = max(cs["passes"], 0)
    kernel, payload = class_plan(bmmc, t)
    if kernel in ("none", "block", "lane"):
        total_desc = cs["descriptors"]
        min_run_bytes = nbytes if kernel == "none" else (
            (1 << payload.b) * itemsize if kernel == "block"
            else payload.rows_per_block * (1 << payload.t) * itemsize)
    else:
        plans = payload
        total_desc = sum(p.dma_descriptors() for p in plans)
        min_run = min(min(p.in_run, p.out_run) for p in plans)
        min_run_bytes = min_run * (1 << t) * itemsize
    return {
        "class": cs["class"],
        "kernel": kernel,
        "passes": passes,
        "descriptors": total_desc,
        "copy_descriptors": 2 * (1 << (n - t)),
        "roofline_ratio": (copy_descriptors(n) / max(total_desc, 1)
                           if passes else 1.0),
        "bytes_moved": nbytes * 2 * passes,
        "copy_bytes": nbytes * 2,
        "min_run_bytes": min_run_bytes,
        "bandwidth_fraction": 1.0 if passes == 0 else 1.0 / passes,
    }
