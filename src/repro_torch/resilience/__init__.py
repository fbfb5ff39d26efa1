"""Resilience layer: circuit breakers, request lifecycle policy, and
the chaos soak harness (DESIGN.md §16) — the counterpart of
:mod:`repro.resilience`.

Sits on top of the guard rings (DESIGN.md §14) and the durable plan
store (§15): the guard *detects* faults per call; this layer decides
what the serving runtime *does about them over time* — route around a
persistently bad engine (:mod:`.breaker`), retry transient faults with
deadlines and bounded backoff (:mod:`.policy`), and prove the whole
stack holds its SLOs under scheduled fault injection (:mod:`.chaos`).

Like ``guard.stats()``/``store.stats()``, :func:`stats` is always on
(plain dict counters); the same events also mirror into the opt-in
``resilience.*`` obs counters when telemetry is enabled.
"""
from __future__ import annotations

from . import breaker, policy
from .breaker import BreakerBoard, Route, board, configure
from .policy import (AdmissionQueue, DeadlineExceeded, RequestResult,
                     RetryPolicy, classify, run_with_policy, shed_result)

__all__ = [
    "AdmissionQueue", "BreakerBoard", "DeadlineExceeded", "RequestResult",
    "RetryPolicy", "Route", "board", "breaker", "classify", "configure",
    "policy", "reset", "run_with_policy", "shed_result", "stats",
]


def stats() -> dict:
    """Always-on resilience counters: the request-policy record plus
    the breaker board's transition counts and live circuit states."""
    out = policy.stats()
    out["breaker"] = board().stats()
    out["circuits"] = board().snapshot()
    return out


def reset() -> None:
    """Reset every resilience counter and circuit (test hermeticity;
    called from ``execute.clear_caches`` / ``inject._fresh_guard_state``)."""
    policy.reset_stats()
    board().reset()
