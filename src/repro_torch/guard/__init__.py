"""Validated execution: the counterpart of :mod:`repro.guard`.

This slice carries ring 1 (plan-time validation, :mod:`.validate`: the
BMMC rank check and the descriptor audits that ``TilePlan.audit()``,
``BlockPlan.audit()`` and ``LanePlan.audit()`` call) and the ring-2
switch with the reference's semantics: ``enable()`` / ``disable()`` /
``enabled()`` / ``guarded()``, on by default when ``REPRO_GUARD`` is
``1`` / ``true`` / ``on`` / ``yes`` in the environment. While the switch
is on, the kernel wrappers refuse to launch with a table that
addresses outside its geometry (``bmmc_permute._trap_tables``). The
in-program probes and the fallback machine of ring 2 arrive in a later
slice.
"""
from __future__ import annotations

import os

from .errors import (BadInput, BadStage, CachePoisoned, ClassMismatch,
                     DescriptorOOB, GuardError, GuardTrap, NotInvertible,
                     UnknownEngine)

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


from .validate import (  # noqa: E402
    audit_block_plan, audit_lane_plan, audit_tile_plan, verify_bmmc)

__all__ = [
    "GuardError", "NotInvertible", "ClassMismatch", "DescriptorOOB",
    "BadInput", "BadStage", "UnknownEngine", "CachePoisoned", "GuardTrap",
    "enable", "disable", "enabled", "guarded", "verify_bmmc",
    "audit_tile_plan", "audit_block_plan", "audit_lane_plan",
]
