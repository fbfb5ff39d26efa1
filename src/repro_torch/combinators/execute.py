"""Multi-engine executor with a compiled-plan cache: the forward half of
:mod:`repro.combinators.execute`.

Engines map a ``Perm`` stage to an actual array permutation:

* ``"ref"``  — the plain gather oracle (:mod:`repro_torch.kernels.ref`).
* ``"cuda"`` — the class-dispatched CUDA kernels (:mod:`repro_torch.
  kernels`), the counterpart of the reference's ``"pallas"`` engine. The
  kernels take their tables as arguments, so there is no per-geometry
  executable to cache; the tables are uploaded to the device once per
  plan.

Any callable ``(x, bmmc) -> x`` is also accepted wherever an engine name
is, so tests can inject instrumented engines. Every engine runs on the
device of its tensor: a CUDA tensor launches the kernels, a CPU tensor
runs their plain PyTorch versions.

``compile_expr(expr)`` is the user entry point: lowering + fusion happen
once per ``(expr, n)``, kernel plans once per ``(bmmc, t)``.

Fused stages (DESIGN.md §10): on the ``"cuda"`` engine the compiled
program is additionally run through :func:`repro_torch.combinators.
optimize.cluster`, which groups ``Perm → compute → Perm`` runs into
:class:`~repro_torch.combinators.optimize.FusedStage`\\ s. A FusedStage
runs as ONE tiled pass of K4b (``tile_fused.cu``) — one HBM round trip
for the whole run, with the interior ``CmpHalves``/``Bfly`` stages
applied to each tile in shared memory. Every other engine executes the
cluster's original stages one at a time. A complex64 array's butterfly
clusters run on its planar (re, im) float32 view. Clusters the kernel
cannot take fall back to stage-at-a-time execution and count
``dispatch.fused_fallback``: other dtypes than int32, float32 and
bfloat16, butterflies off the planar float32 layout, arrays too small
to tile, and — unlike the reference, whose kernel ran the ``Map``
callable on the tile — every cluster that holds a ``Map``: a CUDA kernel
cannot call a Python function.

Whole-program executable: the reference jit-compiles each resolved
program once per ``(program, engine, batched)``. Here that is a CUDA
graph, captured once per ``(program, engine, batched)`` and input
shape, dtype and device (a graph is shape-specific): the first call runs
the program eagerly (uploading every table, and counting telemetry as
the reference's trace does), then captures it; later calls copy the
input into the graph's input buffer, replay, and return a copy of the
graph's output buffer. A capture that fails raises. CPU tensors run the
program eagerly.

Gradients are not ported yet: every entry point here raises
``NotImplementedError`` for a tensor that requires grad while grad mode
is on (the kernels write through raw pointers, so autograd would drop
the gradient without a word). The reference's ``custom_vjp`` rules
become ``torch.autograd.Function``\\ s in the next slice.

Batching: ``run_program`` / ``CompiledExpr.__call__`` take
``batched=True`` to accept a leading batch axis — ``(B, 2^n)`` or
``(B, 2^n, d)`` — folded into the kernel grid with the tile plan shared
across the batch. Injected engines that don't understand ``batched``
are called once per batch row.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core.bmmc import Bmmc
from ..core.tiling import compute_tables, plan_bmmc, plan_general
from ..guard.errors import BadInput, BadStage, UnknownEngine
from ..kernels import ops
from ..kernels import ref as _ref
from ..kernels.ops import check_no_grad
from ..kernels.bmmc_permute import (_ELEM_TYPE, cmp_max, cmp_min,
                                    device_cached,
                                    device_tables, pin_device_tables,
                                    plan_geometry, tiled_permute,
                                    tiled_permute_tables)
from ..obs import metrics as _ometrics
from ..obs import trace as _otrace
from .ir import Bfly, CmpHalves, Expr, Map, Perm
from .optimize import (COMPUTES, FusedStage, Program, cluster, fold_free,
                       fuse, lower)

EngineFn = Callable[[torch.Tensor, Bmmc], torch.Tensor]

_ENGINES: Dict[str, EngineFn] = {}



def register_engine(name: str, fn: EngineFn) -> None:
    _ENGINES[name] = fn


def get_engine(engine: Union[str, EngineFn, None]) -> EngineFn:
    if engine is None:
        return _ENGINES["ref"]
    if callable(engine):
        return engine
    try:
        return _ENGINES[engine]
    except KeyError:
        raise UnknownEngine(
            f"unknown engine {engine!r}; registered engines: "
            f"{sorted(_ENGINES)}") from None


def engines() -> tuple:
    return tuple(sorted(_ENGINES))


register_engine("ref", _ref.bmmc_ref)
# the class-dispatched kernels; they move raw words, so complex tensors
# take them too
register_engine("cuda", ops.bmmc_permute)


# ---------------------------------------------------------------------------
# Fused-stage execution: the K4b dispatch path (DESIGN.md §10)
# ---------------------------------------------------------------------------

def _fused_entries(plans, computes):
    entries = []
    for comp, prefix in computes:
        if isinstance(comp, Map):
            entries.append(("map", comp))
            continue
        kind = "cmp" if isinstance(comp, CmpHalves) else "bfly"
        ct = compute_tables(plans[0], prefix, kind)
        if ct is None:
            return None
        entries.append((kind, comp, ct))
    return tuple(entries)


def _build_fused_plan(fs: FusedStage, t: int):
    """Plan a cluster from scratch.

    A classic plan's tile span can be narrower than the maximal
    ``ker(A[t:, :])`` span the clustering validated against; when a
    compute's pairing vector needs the extra room, the first pass is
    re-planned with :func:`repro_torch.core.tiling.plan_general`, whose
    span IS the maximum."""
    try:
        plans = list(plan_bmmc(fs.bmmc, t))
    except ValueError:
        return None
    entries = _fused_entries(plans, fs.computes)
    if entries is None and plans[0].row_cols:
        general = plan_general(plans[0].bmmc, t)
        if general is not None:
            plans[0] = general
            entries = _fused_entries(plans, fs.computes)
    if entries is None:
        return None
    return tuple(plans), tuple(entries)


@functools.lru_cache(maxsize=256)
def _fused_plan_cached(fs: FusedStage, t: int):
    """(pass plans, per-compute ComputeTables-or-Map entries) for a
    cluster, or None when the fused kernel cannot run it at this tile
    parameter (no pass plannable, or a compute not tile-local in the
    first pass — possible when the runtime ``t`` differs from the
    clustering ``t``). Computes always ride the FIRST pass's tiles (they
    are pulled back to input space, where pass 1 reads). (The reference
    backs this cache with its durable plan store; that layer is not
    ported yet.)"""
    return _build_fused_plan(fs, t)


@functools.lru_cache(maxsize=64)
def _w_planar_cached(bfly: Bfly, dtype: str) -> np.ndarray:
    """The (2^(n-1), 2) (re, im) twiddle-value table of a butterfly stage.
    Each value is the Python complex's double rounded once to ``dtype``,
    as the reference's table is. Keyed by the stage, whose hash is kept,
    not by its twiddle tuple, which would be hashed anew (2^21 complex
    numbers at 2^22 points) on every lookup."""
    w = np.array(bfly.twiddles, dtype=np.complex128)
    return np.stack([w.real.astype(dtype), w.imag.astype(dtype)], axis=-1)


def _fused_tile(x: torch.Tensor, fs: FusedStage,
                batched: bool) -> Optional[int]:
    """The tile parameter the fused kernel would use on ``x``, or None
    when the fused path cannot take this input (falls back per-stage)."""
    lead = 1 if batched else 0
    if x.dim() not in (1 + lead, 2 + lead) or x.dtype not in _ELEM_TYPE:
        return None
    if any(isinstance(s, Map) for s in fs.stages):
        return None  # no Python callable inside a CUDA kernel
    d = x.shape[1 + lead] if x.dim() == 2 + lead else 1
    if any(isinstance(c, Bfly) for c, _ in fs.computes):
        if x.dim() != 2 + lead or d != 2 or x.dtype != torch.float32:
            return None  # butterflies need the planar float32 layout
    t = ops.choose_tile(fs.bmmc.n, x.element_size(), d)
    if t is None or _fused_plan_cached(fs, t) is None:
        return None
    return t


def _fused_kernel_args(entries: tuple, dtype) -> tuple:
    """(signature, per-tile tables, per-row/lane tables, map fns) of a
    cluster's epilogues, in the reference's layout."""
    sig, scal, vmem, map_fns = [], [], [], []
    for e in entries:
        if e[0] == "map":
            sig.append(("map", e[1].name))
            map_fns.append(e[1].fn)
            scal.append(())
            vmem.append(())
            continue
        kind, comp, ct = e
        if kind == "cmp":
            sig.append(("cmp", ct.vr, ct.vc))
            scal.append((ct.hi_base,))
            vmem.append((ct.hi_row, ct.hi_lane))
        else:
            w = _w_planar_cached(comp, str(dtype).replace("torch.", ""))
            sig.append(("bfly", ct.vr, ct.vc, len(comp.twiddles)))
            scal.append((ct.hi_base, ct.tw_base))
            vmem.append((ct.hi_row, ct.hi_lane, ct.tw_row, ct.tw_lane, w))
    return tuple(sig), tuple(scal), tuple(vmem), tuple(map_fns)


def _fused_cuda(x: torch.Tensor, fs: FusedStage, t: int, *,
                batched: bool = False) -> torch.Tensor:
    """Run one cluster as one K4b pass: the first tiled pass carries every
    fused compute as an on-chip epilogue; a second plain pass (general
    BMMCs only, §5.2) finishes the permutation."""
    plans, entries = _fused_plan_cached(fs, t)
    plan = plans[0]
    sig, scal, vmem, _ = _fused_kernel_args(entries, x.dtype)
    if x.device.type == "cuda":
        dev = x.device
        tabs = device_tables(plan, dev)
        scal, vmem = device_cached(entries, "epilogue", dev, lambda: tuple(
            tuple(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in grp) for grp in part)
            for part in (scal, vmem)))
    else:
        tabs = (plan.in_rows, plan.out_rows, plan.xor_low, plan.src0)
    x = tiled_permute_tables(x.contiguous(), *tabs,
                             geometry=plan_geometry(plan), epilogue=sig,
                             epi_scalar=scal, epi_vmem=vmem, batched=batched)
    for plan in plans[1:]:
        x = tiled_permute(x, plan, batched=batched)
    return x


def _planar_view(x: torch.Tensor, fs: FusedStage,
                 batched: bool) -> torch.Tensor:
    """A complex64 ``x`` seen as its planar (re, im) float32 layout, with
    no copy, when every fused compute is a butterfly; else ``x``."""
    lead = 1 if batched else 0
    if (x.dtype == torch.complex64 and x.dim() == 1 + lead
            and all(isinstance(c, Bfly) for c, _ in fs.computes)):
        return torch.view_as_real(x.resolve_conj())
    return x


def _fused_forward(x, fs, engine, batched):
    if engine == "cuda":
        xk = _planar_view(x, fs, batched)
        t = _fused_tile(xk, fs, batched)
        if t is not None:
            if _otrace._state.enabled:
                plans, _ = _fused_plan_cached(fs, t)
                _ometrics.inc("dispatch.kernel", kernel="fused")
                _ometrics.inc("model.round_trips", len(plans))
                _ometrics.inc("dma.descriptors",
                              sum(p.dma_descriptors() for p in plans))
                with _otrace.span("kernel.fused", stages=len(fs.stages),
                                  passes=len(plans), t=t):
                    y = _fused_cuda(xk, fs, t, batched=batched)
            else:
                y = _fused_cuda(xk, fs, t, batched=batched)
            return y if xk is x else torch.view_as_complex(y)
        # cluster validated at plan time but rejected for this input
        # (dtype/shape/tile mismatch, or a Map): the honest count the
        # model lacks
        _ometrics.inc("dispatch.fused_fallback")
    return run_program(fs.stages, x, engine, batched=batched)


def fused_apply(x: torch.Tensor, fs: FusedStage,
                engine: Union[str, EngineFn, None] = None,
                batched: bool = False) -> torch.Tensor:
    """Fused-cluster execution: ONE K4b pass on the ``"cuda"`` engine,
    per-stage otherwise. Forward only (see the module docstring)."""
    check_no_grad(x, "fused_apply")
    return _fused_forward(x, fs, engine, batched)


# ---------------------------------------------------------------------------
# perm_apply — the permutation primitive
# ---------------------------------------------------------------------------

_BATCHED_SIG = weakref.WeakKeyDictionary()  # doesn't pin injected engines


def _accepts_batched(fn: Callable) -> bool:
    # only an explicit ``batched`` parameter proves support — a bare
    # ``**kwargs`` would swallow the flag and permute the wrong axis
    try:
        return _BATCHED_SIG[fn]
    except (KeyError, TypeError):
        pass
    try:
        got = "batched" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins, odd callables
        got = False
    try:
        _BATCHED_SIG[fn] = got
    except TypeError:  # not weakref-able; just re-probe next time
        pass
    return got


def _call_engine(fn: EngineFn, x: torch.Tensor, bmmc: Bmmc,
                 batched: bool) -> torch.Tensor:
    """Invoke an engine, once per batch row if it only speaks the
    unbatched ``(x, bmmc) -> x`` protocol."""
    if not batched:
        return fn(x, bmmc)
    if _accepts_batched(fn):
        return fn(x, bmmc, batched=True)
    return torch.stack([fn(xb, bmmc) for xb in x.unbind(0)])


def perm_apply(x: torch.Tensor, bmmc: Bmmc,
               engine: Union[str, EngineFn, None] = None,
               batched: bool = False) -> torch.Tensor:
    """BMMC permutation through any engine (forward only)."""
    check_no_grad(x, "perm_apply")
    return _call_engine(get_engine(engine), x, bmmc, batched)


# ---------------------------------------------------------------------------
# Program execution
# ---------------------------------------------------------------------------

def _bfly_twiddles(twiddles: tuple, x: torch.Tensor) -> tuple:
    """The butterfly's (re, im) twiddles in ``x``'s dtype on its device,
    kept beside the stage (each Python float rounded once, as the
    reference does)."""
    def make():
        w = np.array(twiddles, dtype=np.complex128)
        return tuple(torch.from_numpy(p.copy()).to(device=x.device,
                                                   dtype=x.dtype)
                     for p in (w.real, w.imag))
    return device_cached(twiddles, ("bfly", str(x.dtype)), x.device, make)


def _apply_bfly(x: torch.Tensor, twiddles: tuple,
                axis: int = 0) -> torch.Tensor:
    """(lo, hi) -> (lo + w·hi, lo - w·hi) along ``axis``. Complex arrays, or
    float arrays with a trailing dim of 2 holding (re, im) channels. A
    complex array is computed on its planar (re, im) view, so it rounds
    as the planar layout and the fused kernel do, on every device (a
    complex128 array's twiddles are rounded to float64, where the
    reference rounds them to complex64)."""
    if x.is_complex():
        xr = torch.view_as_real(x.resolve_conj())
        return torch.view_as_complex(_bfly_planar(xr, twiddles, axis))
    if x.dim() != axis + 2 or x.shape[-1] != 2:
        raise BadInput("real-typed Bfly input must have a trailing "
                       f"(re, im) dim of 2; got shape {tuple(x.shape)}")
    return _bfly_planar(x, twiddles, axis)


def _bfly_planar(x: torch.Tensor, twiddles: tuple, axis: int) -> torch.Tensor:
    """The butterfly on a (..., 2) (re, im) array, each product and sum
    rounded on its own."""
    h = x.shape[axis] // 2
    lo = x.narrow(axis, 0, h)
    hi = x.narrow(axis, h, h)
    wshape = (1,) * axis + (h,) + (1,) * (x.dim() - axis - 2)
    wr, wi = (w.reshape(wshape) for w in _bfly_twiddles(twiddles, x))
    t = torch.empty_like(hi)
    torch.sub(wr * hi[..., 0], wi * hi[..., 1], out=t[..., 0])
    torch.add(wr * hi[..., 1], wi * hi[..., 0], out=t[..., 1])
    out = torch.empty_like(x)
    torch.add(lo, t, out=out.narrow(axis, 0, h))
    torch.sub(lo, t, out=out.narrow(axis, h, h))
    return out


def _exec_stage(s: Expr, x: torch.Tensor, engine, batched: bool,
                axis: int) -> torch.Tensor:
    """Dispatch ONE primitive/fused stage (the run_program loop body)."""
    if isinstance(s, Perm):
        return perm_apply(x, s.bmmc, engine, batched)
    if isinstance(s, FusedStage):
        return fused_apply(x, s, engine, batched)
    if isinstance(s, CmpHalves):
        h = x.shape[axis] // 2
        lo = x.narrow(axis, 0, h)
        hi = x.narrow(axis, h, h)
        out = torch.empty_like(x)   # each half written in place, no cat
        cmp_min(lo, hi, out=out.narrow(axis, 0, h))
        cmp_max(lo, hi, out=out.narrow(axis, h, h))
        return out
    if isinstance(s, Bfly):
        return _apply_bfly(x, s.twiddles, axis)
    if isinstance(s, Map):
        return s.fn(x)
    raise BadStage(f"non-primitive stage {type(s).__name__}; "
                   "lower() the expression first")


def run_program(program: Sequence[Expr], x: torch.Tensor,
                engine: Union[str, EngineFn, None] = None,
                *, batched: bool = False) -> torch.Tensor:
    """Execute a lowered (primitive-only) stage program, eagerly, stage
    by stage. ``batched=True`` moves the permuted axis to axis 1, with a
    leading batch dim. Standalone computes are plain torch ops.

    When telemetry is enabled each stage records a ``stage.*`` span and
    standalone computes count as ``sweep`` kernel dispatches (matching
    :func:`repro_torch.combinators.optimize.program_cost`)."""
    get_engine(engine)  # validate the name up front, even for Perm-free
    check_no_grad(x, "run_program")
    axis = 1 if batched else 0
    if not _otrace._state.enabled:
        for s in program:
            x = _exec_stage(s, x, engine, batched, axis)
        return x
    for s in program:
        kind = type(s).__name__.lower()
        with _otrace.span("stage." + kind):
            x = _exec_stage(s, x, engine, batched, axis)
        if isinstance(s, COMPUTES):
            # a standalone compute pays one full elementwise HBM sweep —
            # the same unit program_cost charges it
            _ometrics.inc("dispatch.kernel", kernel="sweep")
            _ometrics.inc("model.round_trips", 1)
    return x


# ---------------------------------------------------------------------------
# compile_expr — the compiled-plan cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _lowered_cached(expr: Expr, n: int, optimized: bool) -> Program:
    prog = lower(expr, n)
    return fuse(prog) if optimized else prog


@functools.lru_cache(maxsize=1024)
def _clustered_cached(expr: Expr, n: int, optimized: bool,
                      t: int) -> tuple:
    prog = cluster(_lowered_cached(expr, n, optimized), n, t)
    return fold_free(prog, n, t)


def _has_map(prog: Program) -> bool:
    """Does the program carry a user ``Map`` callable (top-level or
    inside a cluster's replay stages)?"""
    return any(isinstance(s, Map)
               or (isinstance(s, FusedStage)
                   and any(isinstance(ss, Map) for ss in s.stages))
               for s in prog)


@contextlib.contextmanager
def _telemetry_off():
    """No spans or counters inside: a capture re-runs what the warm-up
    already counted."""
    was = _otrace._state.enabled
    _otrace._state.enabled = False
    try:
        yield
    finally:
        _otrace._state.enabled = was


class _CapturedProgram:
    """One resolved program as a CUDA graph at one input shape, dtype and
    device. The first call runs the program eagerly on its input (that
    run uploads every table, pinned for the graph, and records the
    telemetry) and returns that result; then it captures the program
    reading a static input buffer. Later calls copy their input into
    that buffer, replay the graph, and return a copy of its output
    buffer, so no two results share memory."""

    def __init__(self, prog: Program, engine: str, batched: bool):
        self.prog, self.engine, self.batched = prog, engine, batched
        self.graph = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return self._capture(x)
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out.clone()

    def _capture(self, x: torch.Tensor) -> torch.Tensor:
        with pin_device_tables() as pinned:
            out = run_program(self.prog, x, self.engine,
                              batched=self.batched)
            static_in = torch.empty_like(x)
            graph = torch.cuda.CUDAGraph()
            with _telemetry_off(), torch.cuda.graph(graph):
                static_out = run_program(self.prog, static_in, self.engine,
                                         batched=self.batched)
        self.tables = pinned   # the graph reads these; keep them alive
        self.static_in, self.static_out = static_in, static_out
        self.graph = graph
        return out


@functools.lru_cache(maxsize=64)
def _program_executable(prog: Program, engine: str, batched: bool,
                        shape: tuple, dtype: torch.dtype, device: str):
    """ONE callable per (program, engine, batched) and input shape, dtype
    and device: a CUDA graph of the whole program for a CUDA tensor
    (:class:`_CapturedProgram`), the eager program otherwise."""
    if torch.device(device).type == "cuda" and prog:
        return _CapturedProgram(prog, engine, batched)
    return functools.partial(run_program, prog, engine=engine,
                             batched=batched)


def _executable_for(prog: Program, engine: str, batched: bool,
                    x: torch.Tensor):
    return _program_executable(prog, engine, batched, tuple(x.shape),
                               x.dtype, str(x.device))


@functools.lru_cache(maxsize=512)
def _program_round_trips(prog: Program, t: Optional[int]) -> Optional[int]:
    """Modeled HBM round trips of a resolved program — the per-call
    model-vs-measured accounting unit (telemetry only)."""
    if t is None:
        return None
    from .optimize import program_cost
    return program_cost(prog, t)["round_trips"]


def _observed_program_call(prog: Program, t: Optional[int], x: torch.Tensor,
                           engine, batched: bool,
                           use_exec: bool) -> torch.Tensor:
    """The telemetry-enabled whole-program call path: one
    ``program.call`` span + latency histogram per invocation, warm/cold
    labeled by whether a new executable was made (and, on the card,
    captured), and the modeled round trips accumulated so
    ``obs.model_vs_measured()`` can hold the transaction model against
    the wall clock. Synchronises on the result only when
    ``obs.enable(sync=True)`` asked for end-to-end timings."""
    eng = engine if isinstance(engine, str) else "injected"
    with _otrace.span("program.call", engine=eng, stages=len(prog),
                      path="executable" if use_exec else "per-stage",
                      batched=batched) as sargs:
        t0 = time.perf_counter_ns()
        if use_exec:
            misses0 = _program_executable.cache_info().misses
            out = _executable_for(prog, engine, batched, x)(x)
            cold = _program_executable.cache_info().misses > misses0
        else:
            out = run_program(prog, x, engine, batched=batched)
            cold = False
        if _otrace._state.sync and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        dur_us = (time.perf_counter_ns() - t0) / 1e3
        rt = _program_round_trips(prog, t)
        sargs["dur_us"] = round(dur_us, 1)
        sargs["cache"] = "cold" if cold else "warm"
        if rt is not None:
            sargs["model_round_trips"] = rt
    _ometrics.observe("program.call_us", dur_us, engine=eng,
                      cache="cold" if cold else "warm")
    if rt is not None:
        _ometrics.inc("program.model_round_trips", rt)
        if not cold:
            _ometrics.observe("program.us_per_round_trip",
                              dur_us / max(rt, 1), engine=eng)
    return out


def _dispatch_program(prog: Program, t: Optional[int], x: torch.Tensor,
                      engine, batched: bool) -> torch.Tensor:
    """Run a resolved program: whole-program executable when the engine
    is named and the program carries no user ``Map`` (one graph replay
    per call on the card), eager per-stage otherwise; observed when
    telemetry is on."""
    use_exec = isinstance(engine, str) and not _has_map(prog)
    if not _otrace._state.enabled:
        if use_exec:
            return _executable_for(prog, engine, batched, x)(x)
        return run_program(prog, x, engine, batched=batched)
    return _observed_program_call(prog, t, x, engine, batched, use_exec)


def program_apply(x: torch.Tensor, prog: Program, t: Optional[int],
                  engine: Union[str, EngineFn, None] = None,
                  batched: bool = False) -> torch.Tensor:
    """Whole-program execution of a resolved program (forward only: the
    reference's custom-VJP boundary arrives with the backward slice)."""
    check_no_grad(x, "program_apply")
    return _dispatch_program(prog, t, x, engine, batched)


CacheStats = collections.namedtuple(
    "CacheStats", ["hits", "misses", "maxsize", "currsize"])


def cache_stats() -> Dict[str, CacheStats]:
    """Aggregate stats for every executor/ops cache, by name: the
    whole-program executables (``program``), the plan/table caches
    (``fused_plan`` / ``w_planar`` / ``lowered`` / ``clustered`` /
    ``model_round_trips``, the ops ``plans`` / ``class_plan``), the
    tables kept on the device (``device_tables``), the guard's ring-1
    caches and the ``compiled_exprs`` memo."""
    from ..kernels import bmmc_permute as K

    out = {
        "program": _program_executable,
        "fused_plan": _fused_plan_cached,
        "w_planar": _w_planar_cached,
        "lowered": _lowered_cached,
        "clustered": _clustered_cached,
        "model_round_trips": _program_round_trips,
        "plans": ops._plans_cached,
        "class_plan": ops._class_plan_cached,
        "device_tables": K._DEV_CACHE,
    }
    stats = {name: CacheStats(*fn.cache_info()) for name, fn in out.items()}
    stats["compiled_exprs"] = CacheStats(
        hits=_compiled_stats["hits"], misses=_compiled_stats["misses"],
        maxsize=None, currsize=len(_COMPILED))
    from ..guard.validate import guard_cache_stats
    for name, info in guard_cache_stats().items():
        stats[name] = CacheStats(*info)
    return stats


class CompiledExpr:
    """A callable compiled combinator expression.

    Calling it executes the (fused) stage program through the chosen
    engine, on the device of its input; ``batched=True`` takes a leading
    batch dim sharing one tile plan. ``program(n)`` exposes the stage
    program for inspection; ``cost(n, t)`` the modeled transaction
    report.
    """

    def __init__(self, expr: Expr, engine: Union[str, EngineFn],
                 optimized: bool):
        self.expr = expr
        self.engine = engine
        self.optimized = optimized

    def program(self, n: int) -> Program:
        return _lowered_cached(self.expr, n, self.optimized)

    def clustered_program(self, n: int, t: int) -> tuple:
        """The program with ``Perm → compute → Perm`` runs grouped into
        :class:`FusedStage`\\ s for tile parameter ``t`` — what the
        ``"cuda"`` engine actually executes."""
        return _clustered_cached(self.expr, n, self.optimized, t)

    def cost(self, n: int, t: int, itemsize: int = 4, *,
             clustered: bool = False) -> dict:
        from .optimize import program_cost
        prog = (self.clustered_program(n, t) if clustered
                else self.program(n))
        return program_cost(prog, t, itemsize)

    def is_permutation(self, n: int) -> bool:
        """True if the program is pure ``Perm`` stages (hence invertible)."""
        return all(isinstance(s, Perm) for s in self.program(n))

    def _resolve(self, x: torch.Tensor, batched: bool) -> tuple:
        """(program, tile parameter) the executor will run on ``x``."""
        axis = 1 if batched else 0
        if x.dim() <= axis:
            what = ("a leading batch dim plus the permuted axis" if batched
                    else "a permutable leading axis")
            raise BadInput(f"input needs {what}, got shape "
                           f"{tuple(x.shape)}")
        n = int(x.shape[axis]).bit_length() - 1
        if (1 << n) != x.shape[axis]:
            raise BadInput(
                f"array length {x.shape[axis]} is not a power of 2")
        d = x.shape[axis + 1] if x.dim() == axis + 2 else 1
        t = ops.choose_tile(n, x.element_size(), d)
        prog = self.program(n)
        if self.engine == "cuda" and self.optimized and t is not None:
            # fused clustering + free-stage folding; the ref oracle and
            # injected engines stay stage-at-a-time
            prog = self.clustered_program(n, t)
        from .. import guard as _g
        if _g.enabled():
            # ring 1: prove the resolved program's invariants (BMMC
            # invertibility, class-predicate consistency, descriptor
            # bounds) before its tables are trusted; cached per
            # (program, t)
            from ..guard.validate import validate_program_fast
            validate_program_fast(tuple(prog), t)
        return prog, t

    def __call__(self, x: torch.Tensor, *,
                 batched: bool = False) -> torch.Tensor:
        check_no_grad(x, "CompiledExpr")
        prog, t = self._resolve(x, batched)
        # Programs carrying user Map callables stay on the eager
        # per-stage path (inside _dispatch_program)
        return program_apply(x, prog, t, self.engine, batched)

    def call_per_stage(self, x: torch.Tensor, *,
                       batched: bool = False) -> torch.Tensor:
        """Execute stage-at-a-time through the Python dispatcher, eagerly
        — the path without the whole-program executable, kept for the
        host-side dispatch-overhead measurement and as a debugging aid."""
        check_no_grad(x, "CompiledExpr.call_per_stage")
        prog, _ = self._resolve(x, batched)
        return run_program(prog, x, self.engine, batched=batched)


_COMPILED: Dict[tuple, CompiledExpr] = {}
_compiled_stats = {"hits": 0, "misses": 0}


def clear_caches() -> None:
    """Drop every compiled artifact the executor pins (plans, tables on
    the device, captured graphs), and reset the telemetry
    counters/spans with them."""
    from ..kernels import bmmc_permute as K
    from .. import obs
    from ..guard.validate import clear_guard_caches

    _program_executable.cache_clear()
    _fused_plan_cached.cache_clear()
    _w_planar_cached.cache_clear()
    _lowered_cached.cache_clear()
    _clustered_cached.cache_clear()
    _program_round_trips.cache_clear()
    _COMPILED.clear()
    _compiled_stats["hits"] = _compiled_stats["misses"] = 0
    ops._plans_cached.cache_clear()
    ops._class_plan_cached.cache_clear()
    K.clear_device_tables()
    clear_guard_caches()
    obs.reset()


def compile_expr(expr: Expr, *, engine: Union[str, EngineFn] = "cuda",
                 optimize: bool = True) -> CompiledExpr:
    """Compile ``expr`` to a function running minimal tiled passes.

    Lowered/fused programs, kernel plans, device tables and captured
    graphs are all cached, so repeated calls (and repeated
    ``compile_expr`` of the same expression) share everything expensive.
    """
    key = (expr, engine if isinstance(engine, str) else id(engine), optimize)
    got = _COMPILED.get(key)
    if got is None:
        _compiled_stats["misses"] += 1
        got = _COMPILED[key] = CompiledExpr(expr, engine, optimize)
    else:
        _compiled_stats["hits"] += 1
    return got
