"""Per-(engine, fault-class) circuit breakers (DESIGN.md §16), the
counterpart of :mod:`repro.resilience.breaker`.

The guard subsystem's fallback machine (DESIGN.md §14) recovers a
trapped cuda call by re-dispatching it through the ref engine — but
it is *stateless*: a persistently poisoned cuda path pays the full
trap + fallback cost (two guarded dispatches plus the flag readback)
on **every** call. The breaker adds the memory: after ``threshold``
consecutive trapped calls on an (engine, fault-kind) pair, the circuit
**opens** and the dispatcher routes straight to the fallback engine at
plan level — one clean ref dispatch per call, zero per-call trap cost —
until a cool-down of ``cooldown`` routed calls has elapsed. The circuit
then goes **half-open**: exactly one probe request is admitted back to
the protected engine to rediscover its health. A clean probe closes
the circuit (full cuda service resumes); a trapped probe reopens it
for another cool-down.

State machine per ``(engine, kind)``::

      CLOSED --[threshold consecutive failures]--> OPEN
      OPEN   --[cooldown routed calls]-----------> HALF_OPEN
      HALF_OPEN --[probe succeeds]---------------> CLOSED
      HALF_OPEN --[probe traps]------------------> OPEN   (fresh cool-down)

Invariants (property-tested in ``tests/test_resilience.py``):

* no transition out of OPEN before the cool-down has fully elapsed;
* HALF_OPEN admits **exactly one** in-flight probe — every other call
  keeps routing to the fallback until the probe resolves;
* a trap during the probe reopens the circuit.

The :class:`BreakerBoard` aggregates the per-kind breakers for one
protected engine and makes the per-call routing decision the guard
runtime consults (:func:`repro_torch.guard.runtime._resolve_or_fallback`).
Only engines with a fallback are protected — today that is ``cuda``
(fallback ``ref``); the ref oracle is the engine of last resort and is
never re-routed. Transitions mirror into ``resilience.breaker.{open,
probe,close,shunt}`` obs counters and into the always-on
:func:`repro_torch.resilience.stats` record.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# breakers guard engines that have somewhere to degrade to
FALLBACK_OF = {"cuda": "ref"}

DEFAULT_THRESHOLD = 3
DEFAULT_COOLDOWN = 8


def _count(event: str, **labels) -> None:
    from ..obs import metrics as _om

    _om.inc(f"resilience.breaker.{event}", **labels)


class Breaker:
    """One (engine, fault-kind) circuit. Not thread-safe on its own —
    the :class:`BreakerBoard` serializes access."""

    __slots__ = ("threshold", "cooldown", "state", "failures",
                 "cool_remaining", "probe_inflight",
                 "opens", "probes", "closes")

    def __init__(self, threshold: int = DEFAULT_THRESHOLD,
                 cooldown: int = DEFAULT_COOLDOWN):
        if threshold < 1 or cooldown < 1:
            raise ValueError("threshold and cooldown must be >= 1")
        self.threshold = threshold
        self.cooldown = cooldown
        self.state = CLOSED
        self.failures = 0          # consecutive, while CLOSED
        self.cool_remaining = 0    # routed-away calls left, while OPEN
        self.probe_inflight = False
        self.opens = 0
        self.probes = 0
        self.closes = 0

    def _open(self) -> None:
        self.state = OPEN
        self.failures = 0
        self.cool_remaining = self.cooldown
        self.probe_inflight = False
        self.opens += 1

    def decide(self) -> str:
        """One routing decision: ``"run"`` (closed), ``"shunt"`` (route
        to the fallback), or ``"probe"`` (half-open, this call is the
        probe). OPEN ticks its cool-down on every decision and flips to
        HALF_OPEN only after the full cool-down elapsed — the next
        decision after the flip is the probe."""
        if self.state == CLOSED:
            return "run"
        if self.state == OPEN:
            self.cool_remaining -= 1
            if self.cool_remaining <= 0:
                self.state = HALF_OPEN
                self.probe_inflight = False
            return "shunt"
        # HALF_OPEN: exactly one probe in flight
        if self.probe_inflight:
            return "shunt"
        self.probe_inflight = True
        self.probes += 1
        return "probe"

    def on_success(self, probe: bool) -> None:
        if self.state == HALF_OPEN and probe:
            self.state = CLOSED
            self.failures = 0
            self.probe_inflight = False
            self.closes += 1
        elif self.state == CLOSED:
            self.failures = 0

    def on_failure(self, probe: bool) -> None:
        if self.state == HALF_OPEN and probe:
            self._open()
        elif self.state == CLOSED:
            self.failures += 1
            if self.failures >= self.threshold:
                self._open()
        # a failure while OPEN can only come from a shunted call that
        # trapped on the *fallback* engine; it never touches this circuit

    def snapshot(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "cool_remaining": self.cool_remaining,
                "probe_inflight": self.probe_inflight,
                "opens": self.opens, "probes": self.probes,
                "closes": self.closes}


@dataclass(frozen=True)
class Route:
    """One routing decision for one guarded call."""

    engine: object          # the engine to actually dispatch on
    requested: object       # the engine the caller asked for
    probe: bool = False     # this call is the half-open health probe
    shunted: bool = False   # an open circuit routed it to the fallback

    @property
    def engaged(self) -> bool:
        return self.probe or self.shunted


class BreakerBoard:
    """The per-kind breakers of every protected engine, plus the
    aggregate routing decision: if ANY circuit for the engine is open,
    the call shunts to the fallback (each open circuit ticks its
    cool-down); once every open circuit has cooled, the first call
    probes ALL half-open circuits at once (one probe request total —
    the engine is healthy or it is not); otherwise the call runs
    normally. Thread-safe; the no-breakers fast path is one dict
    emptiness check."""

    def __init__(self, threshold: int = DEFAULT_THRESHOLD,
                 cooldown: int = DEFAULT_COOLDOWN):
        self.threshold = threshold
        self.cooldown = cooldown
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple[str, str], Breaker] = {}
        self._stats = {"open": 0, "probe": 0, "close": 0, "shunt": 0}

    def configure(self, threshold: Optional[int] = None,
                  cooldown: Optional[int] = None) -> None:
        """Set thresholds for breakers created from now on and reset
        live circuits (a reconfigured machine starts from CLOSED)."""
        with self._lock:
            if threshold is not None:
                self.threshold = threshold
            if cooldown is not None:
                self.cooldown = cooldown
            self._breakers.clear()

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()
            for k in self._stats:
                self._stats[k] = 0

    def _engine_breakers(self, engine: str):
        return [b for (e, _), b in self._breakers.items() if e == engine]

    def route(self, engine) -> Route:
        """The per-call routing decision. Engines without a fallback
        (and injected engine callables) are never re-routed."""
        fallback = FALLBACK_OF.get(engine) if isinstance(engine, str) \
            else None
        if fallback is None or not self._breakers:
            return Route(engine, engine)
        with self._lock:
            brs = self._engine_breakers(engine)
            if not brs:
                return Route(engine, engine)
            open_brs = [b for b in brs if b.state == OPEN]
            if open_brs:
                for b in open_brs:
                    b.decide()          # ticks the cool-down
                self._stats["shunt"] += 1
            else:
                half = [b for b in brs if b.state == HALF_OPEN]
                if not half:
                    return Route(engine, engine)
                decisions = [b.decide() for b in half]
                if "probe" in decisions:
                    self._stats["probe"] += 1
                    _count("probe", engine=engine)
                    return Route(engine, engine, probe=True)
                self._stats["shunt"] += 1
        _count("shunt", engine=engine)
        return Route(fallback, engine, shunted=True)

    def on_success(self, route: Route) -> None:
        """The call ran clean ON THE REQUESTED ENGINE (a shunted call's
        success says nothing about the protected engine)."""
        if route.engine != route.requested:
            return
        with self._lock:
            closed_any = False
            for b in self._engine_breakers(route.requested):
                was = b.state
                b.on_success(route.probe)
                closed_any |= (was == HALF_OPEN and b.state == CLOSED)
            if closed_any:
                self._stats["close"] += 1
        if closed_any:
            _count("close", engine=route.requested)

    def on_trap(self, route: Route, kinds) -> None:
        """The call trapped on the requested engine: per-kind failure
        accounting, plus — on a trapped probe — reopening every
        half-open circuit (one bad probe re-condemns the engine)."""
        if route.engine != route.requested:
            return
        engine = route.requested
        if not isinstance(engine, str) or engine not in FALLBACK_OF:
            # the engine of last resort has nowhere to degrade to — a
            # circuit for it could open but never tick (route() never
            # re-routes it), so it gets no circuit at all
            return
        opened = 0
        with self._lock:
            for kind in kinds:
                key = (engine, kind)
                b = self._breakers.get(key)
                if b is None:
                    b = self._breakers[key] = Breaker(
                        self.threshold, self.cooldown)
                was_open = b.opens
                b.on_failure(route.probe)
                opened += b.opens - was_open
            if route.probe:
                for b in self._engine_breakers(engine):
                    if b.state == HALF_OPEN:
                        was_open = b.opens
                        b.on_failure(True)
                        opened += b.opens - was_open
            self._stats["open"] += opened
        for _ in range(opened):
            _count("open", engine=engine)

    def snapshot(self) -> dict:
        with self._lock:
            return {f"{e}/{k}": b.snapshot()
                    for (e, k), b in sorted(self._breakers.items())}

    def engaged(self, engine: str) -> bool:
        """Any circuit for ``engine`` not fully CLOSED (the serving loop
        uses this as the "degraded" signal; recovery = not engaged)."""
        with self._lock:
            return any(b.state != CLOSED
                       for b in self._engine_breakers(engine))

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)


_BOARD = BreakerBoard()


def board() -> BreakerBoard:
    return _BOARD


def configure(threshold: Optional[int] = None,
              cooldown: Optional[int] = None) -> None:
    _BOARD.configure(threshold, cooldown)


def reset() -> None:
    _BOARD.reset()
