"""Counters + histograms for the permutation executor stack.

Counters are labeled monotonic sums (``inc``); histograms keep running
count/sum/min/max plus a fixed-size deterministic reservoir for
percentiles (``observe``). Both are plain host-side Python — safe to
call at dispatch time (values must be concrete Python numbers, which
every instrumentation site guarantees: they come from offline plans and
host clocks, never from device tensors) — and both are no-ops while
telemetry is disabled.

Counter vocabulary (the names of :mod:`repro.obs.metrics`, so counts
of the two packages compare key for key):

* ``dispatch.kernel{kernel=...}`` — one count per kernel dispatch, in
  the ``program_cost(...)["kernels"]`` vocabulary (``none`` / ``block``
  / ``lane`` / ``tiled`` / ``general`` / ``general2`` / ``fused`` /
  ``sweep``) plus ``ref`` for gather-oracle executions.
* ``dispatch.class{cls=...}`` — the BMMC *class* (identity / complement
  / block / lane / tiled / general) of each dispatched matrix.
* ``dma.descriptors`` / ``model.round_trips`` — modeled DMA descriptor
  and HBM-round-trip totals of everything dispatched.
* ``dispatch.fused_fallback`` — clusters the fused kernels could not
  take (forward: K4b; backward: K5), run another way.
* ``dispatch.vjp{kind=...}`` — one count per backward rule executed
  (``program`` / ``fused`` / ``stage``), i.e. which backward path
  (DESIGN.md §13) a gradient took.
* ``model.vjp_round_trips`` — the slice of ``model.round_trips``
  attributable to backward-rule bodies: each rule records the
  ``model.round_trips`` delta its own dispatches produced, so a cold
  backward call's ``model.vjp_round_trips`` delta equals the modeled
  cost of the backward it ran (``CompiledExpr.vjp_round_trips`` — the
  backward honesty gate). On the gradient kernel route each K5 pass
  counts one round trip (as the forward pass it transposes) and each
  standalone compute's VJP one ``sweep``.

Span vocabulary for gradients mirrors the forward's: ``program.vjp`` /
``fused.vjp`` / ``stage.vjp`` wrap the corresponding backward rule
bodies, and ``kernel.fused_bwd`` wraps the gradient kernel K5.

Validated, durable and resilient execution (the reference's names; each
also has an always-on record: ``guard.stats()``, ``store.stats()``,
``resilience.stats()``):

* ``guard.trap{kind, engine}`` — a guarded call's flag word had bit
  ``kind`` (``oob`` / ``nonfinite`` / ``parity``) set on ``engine``;
  ``guard.fallback{engine}`` — a trapped call re-run on ``engine``
  (``ref``); ``guard.recovered`` — a fallback that ran clean;
  ``guard.raised{error}`` — a request that failed loudly
  (``GuardTrap`` / ``CachePoisoned``).
* ``store.{hit, miss, write, write_failed, corrupt, quarantined,
  version_skew, plan_built}{kind}`` — the plan store's load-through
  events (``kind``: ``class`` / ``fused``, or the quarantine reason
  ``corrupt`` / ``audit``).
* ``resilience.breaker.{open, probe, close, shunt}{engine}`` — circuit
  transitions and calls routed to the fallback; ``resilience.retry``,
  ``resilience.deadline``, ``resilience.shed`` — the request policy.

The optimizer's counters arrive with the layer that records them.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Tuple

from . import trace as _trace

_RESERVOIR = 1024

_lock = threading.Lock()
_counters: Dict[tuple, float] = {}
_hists: Dict[tuple, "_Hist"] = {}

Key = Tuple[str, tuple]


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "sample")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.sample: list = []

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.sample) < _RESERVOIR:
            self.sample.append(v)
        else:  # deterministic overwrite (no RNG: identical across runs)
            self.sample[self.count % _RESERVOIR] = v

    def summary(self) -> dict:
        s = sorted(self.sample)

        def pct(p: float) -> float:
            return s[min(len(s) - 1, int(p * len(s)))] if s else 0.0

        return {
            "count": self.count, "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.total / self.count if self.count else 0.0,
            "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
        }


def _key(name: str, labels: dict) -> Key:
    return (name, tuple(sorted(labels.items())))


def inc(name: str, value: float = 1, **labels) -> None:
    """Add ``value`` to a labeled counter. No-op when disabled."""
    if not _trace._state.enabled:
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0) + value


def observe(name: str, value: float, **labels) -> None:
    """Record one histogram observation. No-op when disabled."""
    if not _trace._state.enabled:
        return
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Hist()
        h.add(value)


def counters() -> dict:
    """Snapshot ``{(name, ((label, value), ...)): count}``."""
    with _lock:
        return dict(_counters)


def counter_value(name: str, **labels) -> float:
    with _lock:
        return _counters.get(_key(name, labels), 0)


def counter_total(name: str) -> float:
    """Sum of a counter across all label sets."""
    with _lock:
        return sum(v for (n, _), v in _counters.items() if n == name)


def histograms() -> dict:
    """Snapshot ``{(name, labels): summary-dict}``."""
    with _lock:
        return {k: h.summary() for k, h in _hists.items()}


def _label_counts(name: str, label: str) -> dict:
    out: dict = {}
    with _lock:
        for (n, labels), v in _counters.items():
            if n != name:
                continue
            key = dict(labels).get(label, "?")
            out[key] = out.get(key, 0) + int(v)
    return out


def kernel_counts() -> dict:
    """Per-kernel dispatch counts in the ``program_cost`` vocabulary —
    directly comparable to ``CompiledExpr.cost(...)["kernels"]``."""
    return _label_counts("dispatch.kernel", "kernel")


def class_counts() -> dict:
    """Per-BMMC-class dispatch counts (identity/complement/block/lane/
    tiled/general)."""
    return _label_counts("dispatch.class", "cls")


def reset() -> None:
    with _lock:
        _counters.clear()
        _hists.clear()
