"""Validated execution: the counterpart of :mod:`repro.guard`, three guard
rings around the permutation engine.

* **Ring 1 — plan time, always on** (:mod:`.validate`): the BMMC rank
  check, the descriptor audits (``TilePlan.audit()``, ``BlockPlan.audit()``
  and ``LanePlan.audit()`` call them), the cached class-dispatch and
  fused-cluster proofs, input preconditions, and fingerprints of every
  validated plan's tables for later poisoning detection.

* **Ring 2 — run time, opt-in** (:mod:`.runtime`): ``enable()`` (or
  ``REPRO_GUARD`` = ``1`` / ``true`` / ``on`` / ``yes`` in the
  environment) switches ``CompiledExpr`` calls and
  ``kernels.ops.bmmc_permute`` to guarded dispatch. The guarded variants
  of K2, K3, K4a and K4b test every table entry before the access it
  addresses and set bit 1 of a device flag word instead of making an
  access out of range (which would lose the CUDA context); probes add a
  nonfinite sentinel (bit 2) and a parity sample (bit 4). The flag word
  is read once, at the API edge. On a trap the call falls back from the
  ``cuda`` engine to ``ref`` (``guard.trap{kind}`` /
  ``guard.fallback{engine}``), and fails loudly —
  :class:`~.errors.GuardTrap` or :class:`~.errors.CachePoisoned` — only
  when ``ref`` traps too. The circuit breakers of
  :mod:`repro_torch.resilience` front every guarded call.

* **Ring 3 — test time** (:mod:`.inject`): fault injection into each
  layer (a bit-flipped BMMC row, swapped descriptors, a poisoned plan
  table on the host or on the card, a truncated parity table, malformed
  inputs, and five disk faults of the plan store), with
  ``run_fault_matrix`` asserting each is caught, never silently wrong.
"""
from __future__ import annotations

import os
import threading

from .errors import (BadInput, BadStage, CachePoisoned, ClassMismatch,
                     DescriptorOOB, GuardError, GuardTrap, NotInvertible,
                     UnknownEngine)

_STATS_LOCK = threading.Lock()
_STATS: dict = {"traps": {}, "fallbacks": {}, "recovered": 0, "raised": {},
                "store_quarantined": {}}

_ENV_FLAG = os.environ.get("REPRO_GUARD", "").strip().lower() in (
    "1", "true", "on", "yes")
_enabled = _ENV_FLAG


def enable() -> None:
    """Turn on guarded dispatch for subsequent calls."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    """Is guarded dispatch active (``enable()`` or ``REPRO_GUARD=1``)?"""
    return _enabled


class guarded:
    """Context manager: guards on inside the block, restored after."""

    def __enter__(self):
        self._prev = _enabled
        enable()
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled = self._prev
        return False


def _record_trap(kind: str, engine: str) -> None:
    from ..obs import metrics as _om
    with _STATS_LOCK:
        k = (kind, engine)
        _STATS["traps"][k] = _STATS["traps"].get(k, 0) + 1
    _om.inc("guard.trap", kind=kind, engine=engine)


def _record_fallback(engine: str) -> None:
    from ..obs import metrics as _om
    with _STATS_LOCK:
        _STATS["fallbacks"][engine] = _STATS["fallbacks"].get(engine, 0) + 1
    _om.inc("guard.fallback", engine=engine)


def _record_recovered() -> None:
    from ..obs import metrics as _om
    with _STATS_LOCK:
        _STATS["recovered"] += 1
    _om.inc("guard.recovered")


def _record_raised(err: BaseException) -> None:
    from ..obs import metrics as _om
    name = type(err).__name__
    with _STATS_LOCK:
        _STATS["raised"][name] = _STATS["raised"].get(name, 0) + 1
    _om.inc("guard.raised", error=name)


def _record_store_quarantine(reason: str) -> None:
    """Mirror of the plan store's quarantine events: a quarantined disk
    entry IS a CachePoisoned detection, so it shows up in the guard
    report alongside traps and fallbacks."""
    with _STATS_LOCK:
        q = _STATS["store_quarantined"]
        q[reason] = q.get(reason, 0) + 1


def stats() -> dict:
    """Guard-subsystem counters (always recorded while guards are on,
    independent of :mod:`repro_torch.obs` being enabled): per-(kind,
    engine) trap counts, per-engine fallback counts, recovered-request
    count, per-type raised-error counts, and per-reason plan-store
    quarantine counts (mirrored from :func:`repro_torch.store.stats`)."""
    with _STATS_LOCK:
        return {"traps": dict(_STATS["traps"]),
                "fallbacks": dict(_STATS["fallbacks"]),
                "recovered": _STATS["recovered"],
                "raised": dict(_STATS["raised"]),
                "store_quarantined": dict(_STATS["store_quarantined"])}


def reset_stats() -> None:
    with _STATS_LOCK:
        _STATS["traps"].clear()
        _STATS["fallbacks"].clear()
        _STATS["raised"].clear()
        _STATS["store_quarantined"].clear()
        _STATS["recovered"] = 0


from .validate import (  # noqa: E402  (needs the state above)
    audit_block_plan, audit_lane_plan, audit_tile_plan, clear_guard_caches,
    guard_cache_stats, plan_fingerprint, validate_dispatch, validate_input,
    validate_program, verify_bmmc)
from .runtime import (  # noqa: E402
    TRAP_KINDS, guarded_bmmc_permute, guarded_call, resolve_flags)

__all__ = [
    "GuardError", "NotInvertible", "ClassMismatch", "DescriptorOOB",
    "BadInput", "BadStage", "UnknownEngine", "CachePoisoned", "GuardTrap",
    "enable", "disable", "enabled", "guarded", "stats", "reset_stats",
    "verify_bmmc", "validate_dispatch", "validate_program",
    "validate_input", "audit_tile_plan", "audit_block_plan",
    "audit_lane_plan", "plan_fingerprint", "guard_cache_stats",
    "clear_guard_caches", "guarded_call", "resolve_flags",
    "guarded_bmmc_permute", "TRAP_KINDS",
]
