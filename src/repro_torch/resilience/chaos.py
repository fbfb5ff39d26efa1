"""Chaos soak harness: scheduled fault injection against a live
serving loop, with SLO assertions (DESIGN.md §16) — the counterpart of
:mod:`repro.resilience.chaos`.

The ring-3 injectors (:mod:`repro_torch.guard.inject`) prove each corruption
class is caught *once*; this harness proves the runtime stays healthy
when faults arrive **over time**: a timeline of fault windows is played
against a serve.py-style request loop (each request one guarded
compiled-permutation dispatch, every result bitwise-compared to the ref
oracle), and the report asserts the serving SLOs:

* **zero silent wrong outputs** — every result served while (or after)
  an injector is active is bitwise-equal to the oracle, or the request
  failed loudly (typed error / deadline / shed);
* **bounded error budget** — loud failures stay within the per-cell
  budget (0 for recoverable faults; the window length where the fault
  hits the engine of last resort);
* **breaker recovery** — the circuit opened by a fault window closes
  within ``recovery_k`` requests of the injector clearing (probe
  rediscovers cuda health), and while it is open the per-call trap
  cost is verifiably gone (``traps_while_open == 0``).

Timeline format: one fault kind + a ``[start, stop)`` request window.
``fault`` names the injector:

* ``poison_plan``      — memory fault: OOB-poison the cached kernel
  descriptor table, which the card then reads (the guarded kernel's trap
  -> ref fallback -> breaker opens);
* ``poison_ref_table`` — memory fault on the engine of last resort
  (loud per-request failure, no fallback left);
* ``disk_bitflip``     — disk fault: flip a payload bit of the durable
  plan-store entry (quarantine + replan on next load; the ref engine
  never consults the store, so its cell must be a no-op);
* ``none``             — control cell.

Requests run on the card unless ``device="cpu"`` is asked for.

CLI::

    python -m repro_torch.resilience.chaos --smoke [--device cpu] [--json OUT]

runs the full injector matrix (memory + disk x {ref, cuda}) and exits
nonzero on any SLO violation. The reference's SIGTERM drain drill boots
its LM server, which this package does not have yet; it is not here.
"""
from __future__ import annotations

import contextlib
import tempfile
from dataclasses import dataclass, field
from typing import Optional

MEMORY_FAULTS = ("poison_plan", "poison_ref_table")
DISK_FAULTS = ("disk_bitflip",)
FAULTS = MEMORY_FAULTS + DISK_FAULTS + ("none",)


@dataclass
class SoakReport:
    """Outcome of one soak cell; ``slo_violations`` empty == passed."""

    engine: str
    fault: str
    requests: int
    window: tuple
    ok: int = 0
    errors: int = 0
    deadline: int = 0
    shed: int = 0
    silent_wrong: int = 0
    faults_injected: int = 0
    faults_caught: int = 0
    shunted: int = 0
    traps_while_open: int = 0
    retries: int = 0
    detected: int = 0            # guard traps + store quarantines seen
    breaker: dict = field(default_factory=dict)
    recovered_at: Optional[int] = None
    recovery_requests: Optional[int] = None
    recovery_k: int = 0
    error_budget: int = 0
    slo_violations: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not self.slo_violations

    def summary(self) -> str:
        return (f"chaos[{self.engine}/{self.fault}]: "
                f"{self.ok}/{self.requests} ok, "
                f"{self.errors} error(s) (budget {self.error_budget}), "
                f"{self.silent_wrong} silent-wrong, "
                f"faults {self.faults_caught}/{self.faults_injected} "
                f"caught, breaker {self.breaker}, "
                f"recovery +{self.recovery_requests} req "
                f"(K={self.recovery_k}), "
                f"traps-while-open {self.traps_while_open}"
                + (" — PASS" if self.passed
                   else f" — FAIL {self.slo_violations}"))


def _trap_total() -> int:
    from .. import guard

    return sum(guard.stats()["traps"].values())


def soak(*, engine: str = "cuda", fault: str = "poison_plan",
         n: int = 6, requests: int = 32, window: tuple = (8, 16),
         threshold: int = 2, cooldown: int = 4,
         recovery_k: Optional[int] = None,
         error_budget: int = 0, max_retries: int = 1,
         deadline_s: Optional[float] = None,
         device="cuda") -> SoakReport:
    """Play one fault window against a live guarded request loop and
    return the :class:`SoakReport`. Deterministic (seeded input, seeded
    backoff jitter, request-count cool-downs); restores every piece of
    global state it touches (breaker config, store root, caches)."""
    import torch

    from .. import guard, store as _store
    from ..combinators import vocab as V
    from ..combinators.execute import compile_expr
    from ..core.bmmc import Bmmc
    from ..guard import inject
    from ..kernels import ops, ref as _ref
    from . import breaker as _breaker
    from .policy import RetryPolicy, run_with_policy

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    start, stop = window
    if recovery_k is None:
        # open at `threshold`, cool down, one (possibly wasted, fault
        # still active) probe, cool down again, clean probe
        recovery_k = 2 * cooldown + 2
    rep = SoakReport(engine=engine, fault=fault, requests=requests,
                     window=(start, stop), recovery_k=recovery_k,
                     error_budget=error_budget)

    x = torch.arange(1 << n, dtype=torch.float32, device=device)
    bmmc = Bmmc.bit_reverse(n)
    t = ops.choose_tile(n, 4)
    oracle = _ref.bmmc_ref(x, bmmc).view(torch.int32)
    policy = RetryPolicy(max_retries=max_retries, base_delay_s=1e-4,
                         max_delay_s=2e-3, seed=7)

    board = _breaker.board()
    prev_cfg = (board.threshold, board.cooldown)
    board.configure(threshold=threshold, cooldown=cooldown)

    prev_store = _store.active()
    store_root = None
    stack = contextlib.ExitStack()
    injector_active = False

    def activate():
        nonlocal injector_active
        if fault == "poison_plan":
            stack.enter_context(inject.poison_plan(bmmc, t))
            inject._clear_runtime_only()   # re-bake the poisoned tables
        elif fault == "poison_ref_table":
            stack.enter_context(inject.poison_ref_table(bmmc))
            inject._clear_runtime_only()
        elif fault == "disk_bitflip":
            st = _store.active()
            key = _store.class_key(bmmc.rows, bmmc.c, t)
            if st is not None and st.read_bytes(key) is not None:
                stack.enter_context(
                    inject.corrupt_store_entry(st, key, "bitflip"))
                inject._clear_replan_path()  # next call reaches the disk
        injector_active = True

    def deactivate():
        nonlocal injector_active
        stack.close()                      # restores the clean state
        if fault in MEMORY_FAULTS:
            inject._clear_runtime_only()   # re-bake the clean tables
        elif fault in DISK_FAULTS:
            inject._clear_replan_path()
        injector_active = False

    try:
        if fault in DISK_FAULTS:
            # the disk cells run against their own throwaway store so a
            # CI-level REPRO_STORE is never corrupted
            store_root = tempfile.mkdtemp(prefix="repro-torch-chaos-store-")
            _store.configure(store_root)
            inject._clear_replan_path()
        ce = compile_expr(V.bit_reverse(n), engine=engine, optimize=False)
        with guard.guarded():
            ce(x)                          # warm + populate the store
            base_traps = _trap_total()
            base_quar = _store.stats()["quarantined"]
            for i in range(requests):
                if i == start and fault != "none":
                    activate()
                if i == stop and injector_active:
                    deactivate()
                shunt0 = board.stats()["shunt"]
                traps0 = _trap_total()
                res = run_with_policy(lambda: ce(x), policy=policy,
                                      deadline_s=deadline_s, request_id=i)
                shunted = board.stats()["shunt"] > shunt0
                trap_delta = _trap_total() - traps0
                rep.retries += res.retries
                if shunted:
                    rep.shunted += 1
                    rep.traps_while_open += trap_delta
                if injector_active:
                    rep.faults_injected += 1
                if res.ok:
                    if torch.equal(res.value.view(torch.int32), oracle):
                        rep.ok += 1
                        if injector_active:
                            rep.faults_caught += 1
                    else:
                        rep.silent_wrong += 1
                elif res.outcome == "deadline":
                    rep.deadline += 1
                    if injector_active:
                        rep.faults_caught += 1  # loud, not silent
                else:
                    rep.errors += 1
                    if injector_active:
                        rep.faults_caught += 1  # loud, not silent
                if (i >= stop and rep.recovered_at is None
                        and not board.engaged(engine)):
                    rep.recovered_at = i
            rep.detected = (_trap_total() - base_traps
                            + _store.stats()["quarantined"] - base_quar)
    finally:
        stack.close()
        rep.breaker = board.stats()
        board.configure(threshold=prev_cfg[0], cooldown=prev_cfg[1])
        if fault in DISK_FAULTS:
            _store.configure(prev_store.root if prev_store else None)
            inject._clear_replan_path()
        elif fault in MEMORY_FAULTS:
            inject._clear_runtime_only()

    if rep.recovered_at is not None:
        rep.recovery_requests = rep.recovered_at - stop
    # ---- SLO assertions ----------------------------------------------
    if rep.silent_wrong:
        rep.slo_violations.append(
            f"silent_wrong_outputs={rep.silent_wrong} (must be 0)")
    if rep.faults_caught != rep.faults_injected:
        rep.slo_violations.append(
            f"faults_caught={rep.faults_caught} != "
            f"faults_injected={rep.faults_injected}")
    if rep.errors + rep.deadline > rep.error_budget:
        rep.slo_violations.append(
            f"errors={rep.errors + rep.deadline} exceed "
            f"budget={rep.error_budget}")
    if rep.recovered_at is None:
        rep.slo_violations.append("no recovery before the soak ended")
    elif rep.recovery_requests > recovery_k:
        rep.slo_violations.append(
            f"recovery took {rep.recovery_requests} requests "
            f"(K={recovery_k})")
    if rep.shunted and rep.traps_while_open:
        rep.slo_violations.append(
            f"open breaker still paid {rep.traps_while_open} trap(s) "
            f"across {rep.shunted} shunted request(s)")
    if fault != "none" and stop > start and rep.detected == 0:
        rep.slo_violations.append(
            "injector active but nothing was detected "
            "(no trap, no quarantine)"
            if engine != "ref" or fault not in DISK_FAULTS else "")
        rep.slo_violations = [v for v in rep.slo_violations if v]
    return rep


def default_matrix() -> list:
    """The full injector matrix: memory + disk faults x {ref, cuda}.

    * cuda x memory: the breaker arc — trap/fallback, open, shunted
      zero-trap service on ref, probe, close;
    * cuda x disk: quarantine + replan recovery (no breaker needed —
      detection happens at plan load, before any dispatch);
    * ref x memory: the engine of last resort failing LOUDLY per
      request (error budget = the window length x (1 + retries));
    * ref x disk: the ref oracle never consults the plan store, so a
      corrupt entry must not perturb it at all.
    """
    return [
        dict(engine="cuda", fault="poison_plan", requests=32,
             window=(8, 16), threshold=2, cooldown=4, error_budget=0),
        dict(engine="cuda", fault="disk_bitflip", requests=16,
             window=(6, 8), threshold=2, cooldown=4, error_budget=0),
        dict(engine="ref", fault="poison_ref_table", requests=18,
             window=(6, 9), threshold=2, cooldown=4, error_budget=3,
             max_retries=1),
        dict(engine="ref", fault="disk_bitflip", requests=14,
             window=(6, 8), threshold=2, cooldown=4, error_budget=0),
    ]


def run_matrix(cells: Optional[list] = None, device="cuda") -> list:
    """Run every cell on ``device``; returns the list of
    :class:`SoakReport`."""
    return [soak(**dict(cell, device=device))
            for cell in (cells or default_matrix())]


def main(argv=None) -> int:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run the default (short) injector matrix")
    ap.add_argument("--device", default="cuda",
                    help="the device the requests run on (default cuda)")
    ap.add_argument("--json", default=None, metavar="OUT.json")
    args = ap.parse_args(argv)

    reports = run_matrix(device=args.device)
    failures = []
    for rep in reports:
        print(rep.summary())
        if not rep.passed:
            failures.extend(
                f"{rep.engine}/{rep.fault}: {v}"
                for v in rep.slo_violations)
    if args.json:
        payload = {"cells": [vars(r) for r in reports],
                   "failures": failures}
        with open(args.json, "w") as f:
            _json.dump(payload, f, indent=1, default=str)
    if failures:
        print("chaos soak: SLO violations:")
        for msg in failures:
            print(f"  {msg}")
        return 1
    print(f"chaos soak: {len(reports)} cell(s) passed")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
