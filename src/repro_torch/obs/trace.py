"""Structured tracing: hierarchical spans with Chrome-trace export.

Spans record at *dispatch time* — the host-side Python that plans and
launches kernels — never inside kernel bodies, so the layer adds
nothing to the device work and forces no host sync of its own.
Disabled (the default) every instrumentation site reduces to a single
module-attribute check.

Span taxonomy (the same names as :mod:`repro.obs`), as
:mod:`repro_torch.combinators.execute` emits them: ``program.call`` (one
compiled program call, labeled by engine, path and warm/cold; the
guarded path of :mod:`repro_torch.guard.runtime` emits it too) >
``stage.*`` (one stage of an eager program walk: ``stage.perm``,
``stage.cmphalves``, ``stage.map``, ``stage.fusedstage``, ...; a call
replayed from a CUDA graph records none) > ``kernel.fused`` (one fused
cluster's tiled pass, K4b) and ``kernel.dispatch`` (one class-dispatch
decision, :mod:`repro_torch.kernels.ops`). Backward rules record
``program.vjp`` / ``fused.vjp`` / ``stage.vjp``, and ``kernel.fused_bwd``
wraps the gradient kernel K5. The drivers add ``serve.prefill``,
``serve.decode_step`` and ``train.step``.

``enable(sync=True)`` additionally lets *measurement sites* block on
device results so recorded wall-clock is end-to-end; ``sync=False``
keeps the layer strictly non-blocking and the recorded durations are
dispatch time only.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

_MAX_EVENTS = 200_000  # hard bound; events past it are counted, not kept


class _State:
    __slots__ = ("enabled", "sync")

    def __init__(self) -> None:
        self.enabled = False
        self.sync = True


_state = _State()
_events: list = []
_dropped = 0
_lock = threading.Lock()
_tls = threading.local()


def enabled() -> bool:
    """Is telemetry recording?  The one check every site pays."""
    return _state.enabled


def sync_enabled() -> bool:
    """May measurement sites block on device results for end-to-end
    wall-clock?  (Never True when telemetry is off.)"""
    return _state.enabled and _state.sync


def enable(sync: bool = True) -> None:
    _state.enabled = True
    _state.sync = sync


def disable() -> None:
    _state.enabled = False


def reset() -> None:
    """Drop all recorded events (counters live in :mod:`.metrics`)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def now_us() -> float:
    """The trace clock (µs); shared by every event so exports line up."""
    return time.perf_counter_ns() / 1e3


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextmanager
def span(name: str, cat: str = "repro_torch", **args) -> Iterator[Optional[dict]]:
    """Hierarchical trace span. Yields a mutable dict merged into the
    event's args at exit, so callers can attach facts discovered inside
    (e.g. the dispatched kernel). No-op when disabled."""
    if not _state.enabled:
        yield None
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    ev_args = dict(args)
    stack.append(name)
    t0 = now_us()
    try:
        yield ev_args
    finally:
        dur = now_us() - t0
        stack.pop()
        record_event(name, cat, t0, dur, ev_args,
                     parent=parent, depth=len(stack))


def record_event(name: str, cat: str, ts_us: float, dur_us: float,
                 args: Optional[dict] = None, parent: Optional[str] = None,
                 depth: int = 0) -> None:
    """Append one Chrome-trace complete event (``ph: "X"``)."""
    if not _state.enabled:
        return
    global _dropped
    ev = {
        "name": name, "cat": cat, "ph": "X", "pid": 1,
        "tid": threading.get_ident() % 1_000_000,
        "ts": round(ts_us, 3), "dur": round(dur_us, 3),
        "args": dict(args or {}),
    }
    if parent is not None:
        ev["args"]["parent"] = parent
    if depth:
        ev["args"]["depth"] = depth
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return
        _events.append(ev)


def events() -> list:
    with _lock:
        return list(_events)


def dropped() -> int:
    return _dropped
