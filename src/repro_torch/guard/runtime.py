"""Ring 2 — guarded dispatch (opt-in): the counterpart of
:mod:`repro.guard.runtime`.

A guarded call runs the program (or one BMMC) with a device flag word,
one int32 on the input's device, and reads it back once, at the API edge
(:func:`_resolve_or_fallback`). Nothing reads it inside the program. The
trap kinds:

* **out of bounds** (bit 1): every table a kernel addresses memory
  through is tested *before* the access, on the card — the guarded
  variants of K2, K3, K4a and K4b (``kernels/csrc``) and, on the ``ref``
  engine, the gather table (clamped, with the flag). On the TPU an
  out-of-range gather clamps and the reference checks its baked-in tables
  in the program; on this card an out-of-range address raises
  ``cudaErrorIllegalAddress``, which loses the CUDA context for good, so
  the trap has to stop the access itself. The plain versions (CPU
  tensors) apply the same tests.
* **nonfinite sentinel** (bit 2): compute-bearing float programs flag an
  output nonfinite that the input did not already carry.
* **parity probe** (bit 4): for permutation-only programs the composed
  BMMC σ is built offline, and ``y[σ(i)] == x[i]`` is checked at 64
  sampled points (two small gathers).

On the card, one CUDA graph per ``(program, t, engine, batched, shape,
dtype, device)`` holds the whole guarded call: zero the flag word, run
the program with the guarded kernels, run the probes. Its first call runs
eagerly (uploading and pinning every table) and captures it; later calls
copy the input in, replay, and return a copy of the output. A guarded
``kernels.ops.bmmc_permute`` is one eager launch of the guarded kernel
plus the probes (the unguarded call is eager too). A call that builds an
autograd graph runs its forward eagerly under the flags; the backward is
not guarded (the reference's ring 2 guards no backward either).

Graceful degradation: a trapped ``cuda`` call re-runs the same program on
the guarded ``ref`` engine, whose gather table is independent of every
kernel plan, records ``guard.trap{kind}`` / ``guard.fallback{engine}``,
and returns the recovered result. Only when ``ref`` traps too does the
request fail loudly: :class:`~.errors.CachePoisoned` when the live plan
tables (host or device copies) no longer match their ring-1
fingerprints, :class:`~.errors.GuardTrap` otherwise. The breaker board of
:mod:`repro_torch.resilience.breaker` fronts every call.

Inside a CUDA-graph capture or a ``torch.compile`` trace the readback is
impossible, so guarded dispatch steps aside (:func:`in_capture_or_trace`);
ring 1 still runs.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.bmmc import Bmmc
from .errors import GuardTrap

TRAP_KINDS = {"oob": 1, "nonfinite": 2, "parity": 4}
_PARITY_SAMPLES = 64


def resolve_flags(mask: int) -> tuple:
    """Decode a flag bitmask into the trap-kind names that fired."""
    return tuple(k for k, bit in sorted(TRAP_KINDS.items()) if mask & bit)


def in_capture_or_trace() -> bool:
    """Is this thread recording a CUDA graph or tracing for
    ``torch.compile`` (where no value can be read back)?"""
    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def ring2_active() -> bool:
    """Should a call entering the executor take guarded dispatch: guards
    on, not already inside a guarded run, not capturing or tracing?"""
    from .. import guard as _g
    from ..kernels import bmmc_permute as K

    return (_g.enabled() and K.active_guard_flags() is None
            and not in_capture_or_trace())


# ---------------------------------------------------------------------------
# probes (built once per program, engine and device; only the checks run
# per call)
# ---------------------------------------------------------------------------

def _program_sigma(prog):
    """The composed input→output BMMC of a permutation-only program
    (``out[σ(i)] = x[i]``), or None for compute-bearing programs."""
    from ..combinators.optimize import is_perm_program

    if not prog or not is_perm_program(prog):
        return None
    sigma = None
    for st in prog:
        b = st.bmmc
        sigma = b if sigma is None else b @ sigma
    return sigma


def _parity_sample(sigma: Bmmc):
    size = sigma.size
    k = min(size, _PARITY_SAMPLES)
    xs = (np.arange(k, dtype=np.int64) * max(1, size // k)) % size
    ys = np.fromiter((sigma.apply(int(i)) for i in xs),
                     dtype=np.int64, count=k)
    return xs, ys


def _has_compute(prog) -> bool:
    from ..combinators.ir import Bfly, CmpHalves
    from ..combinators.optimize import FusedStage

    return any(isinstance(st, (CmpHalves, Bfly))
               or (isinstance(st, FusedStage) and st.computes)
               for st in prog)


def _build_probe(prog, batched: bool, device):
    """``probe(x, y, flags)``: the nonfinite and parity checks as tensor
    ops on ``device`` that OR their bits into ``flags`` (no readback)."""
    sigma = _program_sigma(prog)
    sample = None
    if sigma is not None:
        sample = tuple(torch.from_numpy(a).to(device)
                       for a in _parity_sample(sigma))
    check_finite = _has_compute(prog)
    axis = 1 if batched else 0

    def probe(x, y, flags):
        if check_finite and y.is_floating_point():
            made_bad = (~torch.isfinite(y)).any() & torch.isfinite(x).all()
            flags.bitwise_or_(made_bad.to(torch.int32)
                              * TRAP_KINDS["nonfinite"])
        if sample is not None:
            a = x.index_select(axis, sample[0])
            b = y.index_select(axis, sample[1])
            eq = a == b
            if y.is_floating_point():
                eq = eq | (torch.isnan(a) & torch.isnan(b))
            flags.bitwise_or_((~eq.all()).to(torch.int32)
                              * TRAP_KINDS["parity"])

    return probe


# ---------------------------------------------------------------------------
# guarded executables
# ---------------------------------------------------------------------------

def _run_guarded(prog, t, x, engine, batched, flags, probe):
    """The program on ``x`` with the guarded kernels writing into
    ``flags`` (zeroed first), then the probes."""
    from ..combinators import execute as _ex
    from ..kernels import bmmc_permute as K

    flags.zero_()
    with K.guard_flags(flags):
        if _ex._needs_grad(x):
            y = _ex._guarded_forward(prog, t, x, engine, batched)
        else:
            y = _ex.run_program(prog, x, engine, batched=batched)
    probe(x.detach(), y.detach(), flags)
    return y


class _GuardedProgram:
    """One resolved program and its probes, guarded, at one input shape,
    dtype and device. On the card: a CUDA graph, captured after an eager
    first call (as :class:`~repro_torch.combinators.execute.
    _CapturedProgram` captures the unguarded program); on the CPU, or
    for an input that requires grad, an eager run. ``__call__`` returns
    ``(y, flags)``; the caller reads ``flags``."""

    def __init__(self, prog, t, engine: str, batched: bool, device: str):
        self.prog, self.t, self.engine, self.batched = prog, t, engine, batched
        self.probe = _build_probe(prog, batched, device)
        self.flags = torch.zeros(1, dtype=torch.int32, device=device)
        self.graph = None

    def _run(self, x):
        return _run_guarded(self.prog, self.t, x, self.engine, self.batched,
                            self.flags, self.probe)

    def __call__(self, x):
        from ..combinators import execute as _ex

        if x.device.type != "cuda" or _ex._needs_grad(x):
            return self._run(x), self.flags
        if self.graph is not None:
            self.static_in.copy_(x)
            self.graph.replay()
            return self.static_out.clone(), self.flags
        with _ex.pin_device_tables() as pinned:
            y = self._run(x)
            static_in = torch.empty_like(x)
            graph = torch.cuda.CUDAGraph()
            # a capture records the zeroing, the program and the probes;
            # it runs none of them, so the flags keep the eager run's bits
            with _ex._telemetry_off(), torch.cuda.graph(graph):
                static_out = self._run(static_in)
        self.tables = pinned   # the graph reads these; keep them alive
        self.static_in, self.static_out = static_in, static_out
        self.graph = graph
        return y, self.flags


@functools.lru_cache(maxsize=64)
def _guarded_executable(prog: tuple, t, engine: str, batched: bool,
                        shape: tuple, dtype, device: str):
    return _GuardedProgram(prog, t, engine, batched, device)


from .validate import IdentityMemo as _IdentityMemo  # noqa: E402

# identity-keyed front memo over _guarded_executable: resolved program
# tuples are stable lru-cached objects, so a warm call skips hashing the
# deep program key
_EXEC_MEMO = _IdentityMemo(maxsize=1024)


def _guarded_exec_fast(prog: tuple, t, engine: str, batched: bool, x):
    key = (id(prog), t, engine, batched, tuple(x.shape), x.dtype,
           str(x.device))
    hit = _EXEC_MEMO.lookup(key, prog)
    if hit is not None:
        return hit
    ex = _guarded_executable(prog, t, engine, batched, tuple(x.shape),
                             x.dtype, str(x.device))
    _EXEC_MEMO.store(key, prog, ex)
    return ex


def _observed_guarded_call(prog: tuple, t, x, engine: str, batched: bool):
    """Telemetry mirror of the unguarded ``_observed_program_call`` for
    the guarded executable: one ``program.call`` span (``path=guarded``)
    and latency histogram per call, cold/warm by the guarded cache, and
    the modeled round trips."""
    from ..combinators import execute as _ex
    from ..obs import metrics as _ometrics, trace as _otrace

    with _otrace.span("program.call", engine=engine, stages=len(prog),
                      path="guarded", batched=batched) as sargs:
        t0 = time.perf_counter_ns()
        misses0 = _guarded_executable.cache_info().misses
        y, flags = _guarded_exec_fast(prog, t, engine, batched, x)(x)
        cold = _guarded_executable.cache_info().misses > misses0
        if _otrace._state.sync and y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
        dur_us = (time.perf_counter_ns() - t0) / 1e3
        rt = _ex._program_round_trips(prog, t)
        sargs["dur_us"] = round(dur_us, 1)
        sargs["cache"] = "cold" if cold else "warm"
        if rt is not None:
            sargs["model_round_trips"] = rt
    _ometrics.observe("program.call_us", dur_us, engine=engine,
                      cache="cold" if cold else "warm")
    if rt is not None:
        _ometrics.inc("program.model_round_trips", rt)
        if not cold:
            _ometrics.observe("program.us_per_round_trip",
                              dur_us / max(rt, 1), engine=engine)
    return y, flags


@functools.lru_cache(maxsize=256)
def _permute_probe(rows: tuple, c: int, batched: bool, device: str):
    from ..combinators.ir import Perm
    return _build_probe((Perm(Bmmc(rows, c)),), batched, device)


def _guarded_permute(x, bmmc: Bmmc, t, engine: str, batched: bool):
    """Guarded twin of :func:`repro_torch.kernels.ops.bmmc_permute` for
    one BMMC, eager: the guarded kernel (or guarded ref gather), then the
    parity probe, into a fresh flag word."""
    from ..kernels import bmmc_permute as K
    from ..kernels import ops

    flags = torch.zeros(1, dtype=torch.int32, device=x.device)
    with K.guard_flags(flags):
        y = ops._bmmc_permute(x, bmmc, t=t, engine=engine, batched=batched)
    _permute_probe(bmmc.rows, bmmc.c, batched, str(x.device))(x, y, flags)
    return y, flags


def _diagnose(prog, t, kinds, engine):
    """Classify an unrecovered trap: poisoned tables get the precise
    :class:`CachePoisoned`; anything else fails as :class:`GuardTrap`."""
    from .errors import CachePoisoned
    from . import validate as _v

    poisoned = _v.check_fingerprints(prog, t) if t is not None else []
    if poisoned:
        return CachePoisoned(
            f"guard trap(s) {sorted(kinds)} with {len(poisoned)} plan "
            f"fingerprint mismatch(es) — cached tables were mutated "
            f"after validation: {poisoned[:3]!r}")
    return GuardTrap(kinds, engine)


def _resolve_or_fallback(prog, t, x, engine, batched, run_engine):
    """The fallback state machine: run guarded on ``engine``; on a trap,
    degrade cuda → ref; raise typed only when the last engine traps.

    The breaker board fronts the dispatch: an open circuit rewrites
    ``engine`` to its fallback *before* the call, and clean/trapped
    outcomes on the requested engine feed the circuit state (shunted
    outcomes do not)."""
    from .. import guard as _g
    from ..resilience import breaker as _breaker

    board = _breaker.board()
    route = board.route(engine)
    engine = route.engine      # an open circuit shunts to the fallback
    y, flags = run_engine(engine)(x)
    mask = int(flags.item())   # the ONE readback, at the API edge
    if not mask:
        board.on_success(route)
        return y
    kinds = resolve_flags(mask)
    for k in kinds:
        _g._record_trap(k, engine)
    board.on_trap(route, kinds)
    if engine != "ref":
        _g._record_fallback("ref")
        y2, flags2 = run_engine("ref")(x)
        mask2 = int(flags2.item())
        if not mask2:
            _g._record_recovered()
            return y2
        kinds = resolve_flags(mask2)
        for k in kinds:
            _g._record_trap(k, "ref")
    err = _diagnose(prog, t, kinds, "ref")
    _g._record_raised(err)
    raise err


def guarded_call(prog, t, x, engine, batched: bool):
    """Guarded ``CompiledExpr`` call: ring-1 validation (cached), then the
    guarded executable with its flag word and the cuda → ref → loud
    failure machine."""
    from ..combinators import execute as _ex
    from ..obs import trace as _otrace
    from . import validate as _v

    prog = tuple(prog)
    _v.validate_program_fast(prog, t)
    _v.validate_input(tuple(x.shape), x.dtype, batched=batched)
    if (not isinstance(engine, str) or engine not in ("cuda", "ref")
            or _ex._has_map(prog)):
        # injected engines and user-Map programs stay on the unguarded
        # dispatch (the guarded K4b takes no maps); ring 1 still ran
        return _ex._dispatch_program(prog, t, x, engine, batched)

    def run_engine(eng):
        if _otrace._state.enabled:
            return lambda xx: _observed_guarded_call(prog, t, xx, eng,
                                                     batched)
        return _guarded_exec_fast(prog, t, eng, batched, x)

    return _resolve_or_fallback(prog, t, x, engine, batched, run_engine)


def guarded_bmmc_permute(x, bmmc: Bmmc, *, t, engine: str, batched: bool):
    """Guarded :func:`repro_torch.kernels.ops.bmmc_permute`: verify +
    dispatch validation, the guarded kernel and the probe, cuda → ref
    fallback."""
    from ..combinators.ir import Perm
    from ..kernels import ops
    from . import validate as _v

    _v.verify_bmmc(bmmc)
    _v.validate_input(tuple(x.shape), x.dtype, batched=batched, n=bmmc.n)
    lead = 1 if batched else 0
    d = x.shape[1 + lead] if x.dim() == 2 + lead else 1
    teff = ops.choose_tile(bmmc.n, x.element_size(), d, t)
    if teff is not None and engine == "cuda":
        _v.validate_dispatch(bmmc.rows, bmmc.c, teff)

    def run_engine(eng):
        return lambda xx: _guarded_permute(xx, bmmc, t, eng, batched)

    return _resolve_or_fallback((Perm(bmmc),), teff, x, engine, batched,
                                run_engine)


def executable_cache_stats() -> dict:
    return {"guard_program": _guarded_executable.cache_info(),
            "guard_permute_probe": _permute_probe.cache_info(),
            "guard_exec_memo": _EXEC_MEMO.cache_info()}


def clear_executables() -> None:
    """Drop every guarded executable (graphs, flag words, probes): the
    next guarded call captures anew."""
    _guarded_executable.cache_clear()
    _permute_probe.cache_clear()
    _EXEC_MEMO.clear()
