"""Request lifecycle policy: deadlines, bounded retry + deterministic
backoff, and admission control with load shedding (DESIGN.md §16) — the
counterpart of :mod:`repro.resilience.policy`.

The guard taxonomy (DESIGN.md §14) splits into two operational classes:

=================  ==========  =========================================
error              class       why
=================  ==========  =========================================
CachePoisoned      retryable   the poisoned entry was quarantined /
                               the fingerprint mismatch named the cache;
                               a retry replans from clean state
GuardTrap          retryable   a runtime trap the fallback machine
                               already demonstrated it can route around
                               (transient poisoning, re-baked tables) —
                               EXCEPT engine="train" traps (a nonfinite
                               loss recomputes deterministically)
BadInput           terminal    the request itself is malformed
NotInvertible      terminal    the program is malformed
ClassMismatch /    terminal    plan-time refusals: retrying re-proves
DescriptorOOB /                the same invariant against the same
BadStage /                     artifact
UnknownEngine
=================  ==========  =========================================

Backoff is exponential with **deterministic seeded jitter**: the delay
for ``(seed, request_id, attempt)`` is a pure function, so a chaos run
replays byte-identically while distinct requests still decorrelate
(no thundering herd of synchronized retries).

:class:`AdmissionQueue` models the serving loop's bounded backlog: a
request is shed (``resilience.shed``) when the queue is at capacity or
when the backlog, at the observed per-request service latency, could
not drain inside the deadline budget anyway — shedding early is
cheaper than admitting work that is already doomed to time out.
"""
from __future__ import annotations

import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..guard.errors import CachePoisoned, GuardError, GuardTrap

RETRYABLE = "retryable"
TERMINAL = "terminal"

_STATS_LOCK = threading.Lock()
_STATS = {"retries": 0, "deadline_exceeded": 0, "shed": 0,
          "requests": 0, "errors": 0}


def _record(key: str, n: int = 1, obs_name: Optional[str] = None,
            **labels) -> None:
    from ..obs import metrics as _om

    with _STATS_LOCK:
        _STATS[key] += n
    if obs_name:
        _om.inc(obs_name, n, **labels)


def stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget ran out before an attempt could
    finish (or before a retry could be worth starting)."""

    def __init__(self, budget_s: float, elapsed_s: float):
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s
        super().__init__(
            f"deadline {budget_s * 1e3:.0f} ms exceeded "
            f"({elapsed_s * 1e3:.0f} ms elapsed)")


def classify(err: BaseException) -> str:
    """``retryable`` or ``terminal`` for one caught error (see the
    module table). Unknown (non-Guard) errors are terminal."""
    if isinstance(err, GuardTrap):
        # a "train"-engine trap is the step-level nonfinite health check
        # — deterministic on the same batch, retrying re-proves it
        if getattr(err, "engine", None) == "train":
            return TERMINAL
        return RETRYABLE
    if isinstance(err, CachePoisoned):
        return RETRYABLE
    return TERMINAL


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter.

    ``delay_s(attempt, request_id)`` is a pure function of
    ``(seed, request_id, attempt)``: base * 2^attempt, capped at
    ``max_delay_s``, with the top ``jitter`` fraction randomized by a
    CRC-seeded :class:`random.Random` — reproducible under a fixed
    seed, decorrelated across requests.
    """

    max_retries: int = 2
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    jitter: float = 0.5
    seed: int = 0

    def delay_s(self, attempt: int, request_id: int = 0) -> float:
        d = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        rng = random.Random(
            zlib.crc32(f"{self.seed}:{request_id}:{attempt}".encode()))
        return d * (1.0 - self.jitter + self.jitter * rng.random())


@dataclass
class RequestResult:
    """Structured outcome of one policied request — what serve.py
    records per request instead of aborting the process."""

    outcome: str                      # ok | error | deadline | shed
    value: object = None
    error: Optional[BaseException] = None
    error_class: Optional[str] = None  # retryable | terminal
    attempts: int = 0
    retries: int = 0
    latency_s: float = 0.0
    labels: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.outcome == "ok"

    def describe(self) -> str:
        if self.ok:
            return f"ok ({self.attempts} attempt(s))"
        if self.outcome == "shed":
            return "shed (admission control)"
        err = type(self.error).__name__ if self.error else "?"
        return (f"{self.outcome}: {err} [{self.error_class or '-'}] "
                f"after {self.attempts} attempt(s)")


def run_with_policy(fn: Callable[[], object], *,
                    policy: Optional[RetryPolicy] = None,
                    deadline_s: Optional[float] = None,
                    request_id: int = 0,
                    classify_fn: Callable = classify,
                    clock: Callable[[], float] = time.monotonic,
                    sleep: Callable[[float], None] = time.sleep,
                    ) -> RequestResult:
    """Run ``fn`` under the request lifecycle: bounded retries of
    retryable :class:`GuardError`\\ s with backoff, a deadline that
    bounds the WHOLE lifecycle (attempts + backoff sleeps), typed
    terminal errors returned — never raised — as a structured
    :class:`RequestResult`. ``clock``/``sleep`` are injectable so tests
    and the chaos harness run on a virtual clock."""
    pol = policy or RetryPolicy()
    _record("requests")
    t0 = clock()
    attempt = 0
    while True:
        if deadline_s is not None:
            elapsed = clock() - t0
            if elapsed >= deadline_s:
                _record("deadline_exceeded",
                        obs_name="resilience.deadline")
                return RequestResult(
                    "deadline", error=DeadlineExceeded(deadline_s, elapsed),
                    attempts=attempt, retries=max(0, attempt - 1),
                    latency_s=clock() - t0)
        try:
            value = fn()
            return RequestResult("ok", value=value, attempts=attempt + 1,
                                 retries=attempt, latency_s=clock() - t0)
        except GuardError as e:
            cls = classify_fn(e)
            if cls != RETRYABLE or attempt >= pol.max_retries:
                _record("errors")
                return RequestResult(
                    "error", error=e, error_class=cls, attempts=attempt + 1,
                    retries=attempt, latency_s=clock() - t0)
            delay = pol.delay_s(attempt, request_id)
            if deadline_s is not None and \
                    clock() - t0 + delay >= deadline_s:
                # the backoff alone would blow the budget: fail now as
                # a deadline, don't sleep into a guaranteed timeout
                _record("deadline_exceeded",
                        obs_name="resilience.deadline")
                return RequestResult(
                    "deadline", error=DeadlineExceeded(
                        deadline_s, clock() - t0),
                    error_class=cls, attempts=attempt + 1, retries=attempt,
                    latency_s=clock() - t0)
            _record("retries", obs_name="resilience.retry")
            sleep(delay)
            attempt += 1


def shed_result() -> RequestResult:
    """The structured result of a request refused at admission."""
    _record("shed", obs_name="resilience.shed")
    _record("requests")
    return RequestResult("shed")


class AdmissionQueue:
    """Bounded admission with deadline-aware load shedding.

    ``admit()`` refuses (returns False, counts ``resilience.shed``)
    when the backlog is at ``max_depth``, or when serving everything
    already queued plus this request — at the EWMA-observed per-request
    latency — would exceed ``deadline_s``. ``complete(latency_s)``
    feeds the latency estimate and frees a slot.
    """

    def __init__(self, max_depth: int = 64,
                 deadline_s: Optional[float] = None,
                 est_latency_s: float = 0.0, alpha: float = 0.2):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = max_depth
        self.deadline_s = deadline_s
        self.est_latency_s = est_latency_s
        self.alpha = alpha
        self._depth = 0
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0

    def would_shed(self, depth: Optional[int] = None) -> bool:
        d = self._depth if depth is None else depth
        if d >= self.max_depth:
            return True
        if self.deadline_s is not None and self.est_latency_s > 0:
            return (d + 1) * self.est_latency_s > self.deadline_s
        return False

    def admit(self) -> bool:
        with self._lock:
            if self.would_shed():
                self.shed += 1
                shed = True
            else:
                self._depth += 1
                self.admitted += 1
                shed = False
        if shed:
            _record("shed", obs_name="resilience.shed")
        return not shed

    def complete(self, latency_s: float) -> None:
        with self._lock:
            self._depth = max(0, self._depth - 1)
            if self.est_latency_s <= 0:
                self.est_latency_s = latency_s
            else:
                self.est_latency_s = ((1 - self.alpha) * self.est_latency_s
                                      + self.alpha * latency_s)

    @property
    def depth(self) -> int:
        return self._depth
