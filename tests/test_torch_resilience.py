"""The resilience layer of the PyTorch port (``repro_torch.resilience``)
held against the JAX reference (``repro.resilience``) on the CPU.

* Breakers and breaker boards driven by the same seeded event sequences
  (routing decisions, clean calls, traps of one or more kinds) walk
  through the same states, decisions and counters, the port's ``cuda``
  engine in the place of the reference's ``pallas``.
* The request policy (classification, deterministic backoff, retries,
  deadlines on a virtual clock) and the admission queue give the same
  outcomes for the same scripts.
* The chaos soak's SLO report at n = 6 matches the reference's cell for
  cell: every count the SLOs read (ok, errors, silent wrong outputs,
  faults injected and caught, shunted calls, traps while open, retries,
  recovery) and the verdict. The per-kind breaker and detection counts
  are compared apart: the reference's clamped out-of-range read also
  trips its parity probe (a second trap kind, a second circuit), where
  the port's guarded kernel makes no such read.
"""
import random

import pytest

from repro import guard as rguard
from repro import resilience as rres
from repro.resilience import breaker as rbreaker
from repro.resilience import chaos as rchaos
from repro.resilience import policy as rpolicy
from repro_torch import guard as pguard
from repro_torch import resilience as pres
from repro_torch.combinators import execute as pex
from repro_torch.resilience import breaker as pbreaker
from repro_torch.resilience import chaos as pchaos
from repro_torch.resilience import policy as ppolicy


@pytest.fixture(autouse=True)
def _clean():
    pres.reset()
    rres.reset()
    pbreaker.configure(pbreaker.DEFAULT_THRESHOLD, pbreaker.DEFAULT_COOLDOWN)
    rbreaker.configure(rbreaker.DEFAULT_THRESHOLD, rbreaker.DEFAULT_COOLDOWN)
    yield
    pres.reset()
    rres.reset()
    pex.clear_caches()


def _route_tuple(route, engine_map):
    return (engine_map.get(route.engine, route.engine),
            engine_map.get(route.requested, route.requested),
            route.probe, route.shunted)


@pytest.mark.parametrize("seed", range(6))
def test_board_traces_equal_the_reference(seed):
    rng = random.Random(seed)
    threshold, cooldown = rng.randint(1, 3), rng.randint(1, 4)
    pb = pbreaker.BreakerBoard(threshold, cooldown)
    rb = rbreaker.BreakerBoard(threshold, cooldown)
    to_ref = {"cuda": "pallas"}
    kinds_pool = [("oob",), ("parity",), ("oob", "parity"), ("nonfinite",)]
    for _ in range(120):
        engine = rng.choice(["acc", "acc", "acc", "ref"])
        pr = pb.route("cuda" if engine == "acc" else "ref")
        rr = rb.route("pallas" if engine == "acc" else "ref")
        assert _route_tuple(pr, to_ref) == _route_tuple(rr, {})
        if rng.random() < 0.45:
            kinds = rng.choice(kinds_pool)
            pb.on_trap(pr, kinds)
            rb.on_trap(rr, kinds)
        else:
            pb.on_success(pr)
            rb.on_success(rr)
        assert pb.stats() == rb.stats()
        assert {k.replace("cuda/", "pallas/"): v
                for k, v in pb.snapshot().items()} == rb.snapshot()
        assert pb.engaged("cuda") == rb.engaged("pallas")


@pytest.mark.parametrize("threshold,cooldown", [(1, 1), (2, 3), (3, 5)])
def test_single_breaker_traces_equal_the_reference(threshold, cooldown):
    rng = random.Random(threshold * 10 + cooldown)
    pb = pbreaker.Breaker(threshold, cooldown)
    rb = rbreaker.Breaker(threshold, cooldown)
    for _ in range(200):
        d = pb.decide()
        assert d == rb.decide()
        if rng.random() < 0.4:
            pb.on_failure(d == "probe")
            rb.on_failure(d == "probe")
        else:
            pb.on_success(d == "probe")
            rb.on_success(d == "probe")
        assert pb.snapshot() == rb.snapshot()


def _script(errors, pkg_guard):
    """A request function raising the named errors in turn, then ok."""
    it = iter(errors)

    def fn():
        name = next(it, None)
        if name is None:
            return "ok"
        if name == "GuardTrap":
            raise pkg_guard.GuardTrap(("oob",), "cuda")
        if name == "TrainTrap":
            raise pkg_guard.GuardTrap(("nonfinite",), "train")
        raise getattr(pkg_guard, name)("scripted")
    return fn


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.now += s


@pytest.mark.parametrize("errors,deadline", [
    ((), None), (("GuardTrap",), None), (("CachePoisoned", "GuardTrap"),
                                          None),
    (("GuardTrap",) * 5, None), (("BadInput",), None),
    (("TrainTrap",), None), (("NotInvertible",), None),
    (("GuardTrap", "GuardTrap"), 0.007), (("CachePoisoned",), 0.001)])
def test_policy_outcomes_equal_the_reference(errors, deadline):
    out = []
    for pkg_policy, pkg_guard in ((ppolicy, pguard), (rpolicy, rguard)):
        pkg_policy.reset_stats()
        clock = _Clock()
        pol = pkg_policy.RetryPolicy(max_retries=2, seed=3)
        res = pkg_policy.run_with_policy(
            _script(errors, pkg_guard), policy=pol, deadline_s=deadline,
            request_id=11, clock=clock, sleep=clock.sleep)
        out.append((res.outcome, type(res.error).__name__ if res.error
                    else None, res.error_class, res.attempts, res.retries,
                    round(res.latency_s, 12), pkg_policy.stats(),
                    [pol.delay_s(a, r) for a in range(4) for r in range(3)]))
    assert out[0] == out[1]


def test_admission_queue_equals_the_reference():
    rng = random.Random(5)
    pq = ppolicy.AdmissionQueue(max_depth=4, deadline_s=0.05,
                                est_latency_s=0.004)
    rq = rpolicy.AdmissionQueue(max_depth=4, deadline_s=0.05,
                                est_latency_s=0.004)
    for _ in range(200):
        if rng.random() < 0.6:
            assert pq.admit() == rq.admit()
        else:
            lat = rng.random() * 0.03
            pq.complete(lat)
            rq.complete(lat)
        assert (pq.depth, pq.admitted, pq.shed) == (rq.depth, rq.admitted,
                                                    rq.shed)
        assert pq.est_latency_s == pytest.approx(rq.est_latency_s, rel=0,
                                                 abs=0)


_SLO_FIELDS = ("fault", "requests", "window", "ok", "errors", "deadline",
               "shed", "silent_wrong", "faults_injected", "faults_caught",
               "shunted", "traps_while_open", "retries", "recovered_at",
               "recovery_requests", "recovery_k", "error_budget",
               "slo_violations")


def test_soak_slo_reports_equal_the_reference_cell_for_cell():
    got = pchaos.run_matrix(device="cpu")
    want = rchaos.run_matrix()
    assert [c["engine"] for c in pchaos.default_matrix()] == [
        "cuda" if c["engine"] == "pallas" else c["engine"]
        for c in rchaos.default_matrix()]
    for g, w in zip(got, want):
        assert g.passed and w.passed, (g.summary(), w.summary())
        assert {f: getattr(g, f) for f in _SLO_FIELDS} == {
            f: getattr(w, f) for f in _SLO_FIELDS}, (g.summary(),
                                                     w.summary())
        # per-kind counts: the port opens the out-of-bounds circuit only
        # (see the module docstring); each of its openings is matched by
        # one of the reference's, which also opens the parity circuit
        assert g.breaker["probe"] == w.breaker["probe"]
        assert g.breaker["close"] == w.breaker["close"]
        assert g.breaker["shunt"] == w.breaker["shunt"]
        assert g.breaker["open"] <= w.breaker["open"]
        assert (g.detected > 0) == (w.detected > 0)


def test_soak_cli_smoke_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "soak.json"
    assert pchaos.main(["--smoke", "--device", "cpu", "--json",
                        str(out)]) == 0
    assert out.exists()
    assert "4 cell(s) passed" in capsys.readouterr().out


def test_resilience_stats_and_reset():
    board = pres.board()
    route = board.route("cuda")
    for _ in range(pbreaker.DEFAULT_THRESHOLD):
        board.on_trap(route, ("oob",))
    s = pres.stats()
    assert s["breaker"]["open"] == 1 and s["circuits"]["cuda/oob"][
        "state"] == "open"
    assert board.route("cuda").engine == "ref"
    pex.clear_caches()         # resets the resilience record too
    assert pres.stats()["circuits"] == {} and not board.engaged("cuda")
