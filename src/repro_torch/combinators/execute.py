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
for the whole run, with the interior ``CmpHalves``/``Bfly``/``Map``
stages applied to each tile on chip. A ``Map``'s torch function runs in
the kernel as the tape :mod:`repro_torch.kernels.map_lower` lowers it to
(the reference's kernel called the function on the tile). Every other
engine executes the cluster's original stages one at a time. A complex64
array's butterfly clusters run on its planar (re, im) float32 view.
The kernel takes every element type the reference's fused kernel takes
but complex: integers of 8, 16, 32 and 64 bits, bool, float32, bfloat16,
float16 and float64; butterflies on a planar (re, im) tail of 2 in any of
the four float types, a ``Map`` beside them on both planar values.
Clusters the kernel cannot take fall back to stage-at-a-time execution
and count ``dispatch.fused_fallback``: complex types, butterflies off the
planar layout, arrays too small to tile and a ``Map`` whose function is
not lowered (outside the tape's op list for the type, or its trace
fails).

Whole-program executable: the reference jit-compiles each resolved
program once per ``(program, engine, batched)``. Here that is a CUDA
graph, captured once per ``(program, engine, batched)`` and input
shape, dtype and device (a graph is shape-specific): the first call runs
the program eagerly (uploading every table, and counting telemetry as
the reference's trace does), then captures it; later calls copy the
input into the graph's input buffer, replay, and return a copy of the
graph's output buffer. A capture that fails raises. CPU tensors run the
program eagerly.

Autodiff (DESIGN.md §9, §13): the reference's ``custom_vjp`` rules are
``torch.autograd.Function``\\ s here, taken whenever the input requires
grad with grad mode on (the kernels write through raw pointers, which
autograd cannot see, so every gradient runs through these rules):

* :func:`perm_apply` — the backward applies the offline-inverted BMMC
  through the same engine; no residual.
* :func:`fused_apply` — a permutation-only cluster saves nothing and runs
  its inverse cluster; a compute-bearing cluster saves its input, and on
  the ``"cuda"`` engine its backward is ONE pass of the gradient kernel
  K5 (``tile_bwd.cu``, its plain version for a CPU tensor), which
  replays the epilogues on the saved input and applies their transposes
  to the cotangent on chip.
* :func:`program_apply` — the whole program as one rule. A
  permutation-only program runs its offline-inverted program through its
  own executable (a CUDA graph, captured in the forward). A
  compute-bearing program saves the inputs of its compute-bearing stages
  and, with ``BWD_MEGAKERNEL`` on the ``"cuda"`` engine, walks its stages
  in reverse: K5 per compute cluster, the inverse pass per permutation,
  the hand-written pairwise VJP per standalone compute — as many round
  trips as the forward. The ``"ref"`` engine (and ``"cuda"`` with
  ``BWD_MEGAKERNEL`` off) runs the reference's COLLAPSED backward: every
  transposed compute conjugated into forward-output coordinates, then one
  composed inverse pass.

A program that holds a ``Map`` runs eagerly, stage by stage (as the
reference keeps it off its executable), each stage through its own rule:
on the ``"cuda"`` engine a Map-bearing cluster's backward is one K5 pass
(the map's VJP by reverse mode over its tape), a standalone ``Map``'s is
autograd through the user's torch function, one sweep.

Backward rules count ``dispatch.vjp{kind}`` and ``model.vjp_round_trips``
(:func:`_vjp_observed`), so a cold backward's counter delta can be held
against :meth:`CompiledExpr.vjp_round_trips`. A complex64 input that
requires grad runs on its planar (re, im) float32 view; torch's
gradient of a complex input is the conjugate of JAX's.

Guards (:mod:`repro_torch.guard`): ring 1 validates every resolved
program when the guard is on; ring 2 then runs the call through
:func:`repro_torch.guard.runtime.guarded_call` — the program with the
guarded kernel variants and its probes, one CUDA graph on the card, a
device flag word read once, the ``cuda`` → ``ref`` fallback on a trap.
Plans load through the durable plan store when one is configured
(:mod:`repro_torch.store`).

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
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core.bmmc import Bmmc
from ..core.tiling import (compute_tables, pairing_vector, plan_bmmc,
                           plan_general)
from ..guard.errors import BadInput, BadStage, UnknownEngine
from ..kernels import ops
from ..kernels import ref as _ref
from ..kernels import map_lower
from ..kernels.bmmc_permute import (_ELEM_TYPE, active_guard_flags,
                                    bfly_transpose, cmp_max,
                                    cmp_min, device_cached, device_tables,
                                    pin_device_tables, plan_geometry,
                                    tie_masks, tiled_permute,
                                    tiled_permute_bwd_tables,
                                    tiled_permute_tables)
from ..obs import metrics as _ometrics
from ..obs import trace as _otrace
from .ir import Bfly, CmpHalves, Expr, Map, Perm
from .optimize import (COMPUTES, FusedStage, Program, _run_fused, cluster,
                       fold_free, fuse, inverse_program, inverse_stage,
                       is_perm_program, lower)

EngineFn = Callable[[torch.Tensor, Bmmc], torch.Tensor]

_ENGINES: Dict[str, EngineFn] = {}


def _needs_grad(x) -> bool:
    """Does this call build an autograd graph (the input requires grad
    and grad mode is on)?"""
    return (isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled())


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
    are pulled back to input space, where pass 1 reads). Backed by the
    durable plan store when one is configured (:mod:`repro_torch.store`;
    an unplannable cluster is stored as a negative entry)."""
    from .. import store as _store

    return _store.fused_plan_through(fs, t,
                                     lambda: _build_fused_plan(fs, t))


def _rounded(a: np.ndarray, dtype) -> torch.Tensor:
    """A float64 table as a CPU tensor of ``dtype``, each value rounded as
    the reference's numpy types round it: float16 once (torch rounds a
    double to float16 through float32), bfloat16 through float32."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    if dtype == torch.float16:
        return torch.from_numpy(a.astype(np.float16))
    return torch.from_numpy(a).to(dtype)


@functools.lru_cache(maxsize=64)
def _w_planar_cached(bfly: Bfly, dtype: str) -> np.ndarray:
    """The (2^(n-1), 2) (re, im) twiddle-value table of a butterfly stage.
    Each value is the Python complex's double rounded to ``dtype`` as the
    reference's table is (:func:`_rounded`), kept as float32 (a half
    value is exact there; the kernels read float32 twiddles), or as
    float64 for float64 (the kernels read float64 twiddles there). Keyed
    by the stage, whose hash is kept, not by its twiddle tuple, which
    would be hashed anew (2^21 complex numbers at 2^22 points) on every
    lookup."""
    w = np.array(bfly.twiddles, dtype=np.complex128)
    out = _rounded(np.stack([w.real, w.imag], axis=-1), getattr(torch, dtype))
    return (out if dtype == "float64" else out.float()).numpy()


def _maps_lowered(fs: FusedStage, dtype) -> bool:
    """Does every ``Map`` of the cluster lower to a tape for ``dtype`` (the
    fused kernels run it: an untyped tape in the base kernels, a typed
    one in the ext map kernels, beside butterflies too)?"""
    return all(map_lower.lower_map(c.name, c.fn, dtype).lowered
               for c, _ in fs.computes if isinstance(c, Map))


def _fused_tile(x: torch.Tensor, fs: FusedStage,
                batched: bool) -> Optional[int]:
    """The tile parameter the fused kernel would use on ``x``, or None
    when the fused path cannot take this input (falls back per-stage)."""
    lead = 1 if batched else 0
    if x.dim() not in (1 + lead, 2 + lead) or x.dtype not in _ELEM_TYPE:
        return None
    if not _maps_lowered(fs, x.dtype):
        return None  # a Map the tape cannot run
    d = x.shape[1 + lead] if x.dim() == 2 + lead else 1
    if any(isinstance(c, Bfly) for c, _ in fs.computes):
        if x.dim() != 2 + lead or d != 2 or not x.is_floating_point():
            return None  # butterflies need a planar (re, im) float layout
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


def _pass_tables(plan, entries, x: torch.Tensor) -> tuple:
    """(index tables, the epilogue keywords of the kernel wrappers) of a
    cluster's fused pass, on ``x``'s device — uploaded once per element
    type (a butterfly's twiddles are rounded to it) and kept there for a
    CUDA tensor. K4b and K5 share them."""
    sig, scal, vmem, map_fns = _fused_kernel_args(entries, x.dtype)
    kw = dict(epilogue=sig, map_fns=map_fns)
    if x.device.type != "cuda":
        return (plan.in_rows, plan.out_rows, plan.xor_low, plan.src0), \
            dict(kw, epi_scalar=scal, epi_vmem=vmem)
    dev = x.device

    def upload():
        return tuple(tuple(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in grp) for grp in part)
                     for part in (scal, vmem))
    scal, vmem = device_cached(entries, ("epilogue", str(x.dtype)), dev,
                               upload)
    return device_tables(plan, dev), dict(kw, epi_scalar=scal,
                                          epi_vmem=vmem)


def _fused_cuda(x: torch.Tensor, fs: FusedStage, t: int, *,
                batched: bool = False) -> torch.Tensor:
    """Run one cluster as one K4b pass: the first tiled pass carries every
    fused compute as an on-chip epilogue; a second plain pass (general
    BMMCs only, §5.2) finishes the permutation."""
    plans, entries = _fused_plan_cached(fs, t)
    plan = plans[0]
    tabs, epi = _pass_tables(plan, entries, x)
    x = tiled_permute_tables(x.contiguous(), *tabs,
                             geometry=plan_geometry(plan), batched=batched,
                             **epi)
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
        # (dtype/shape/tile mismatch, or a Map the tape cannot run): the
        # honest count the model lacks
        _ometrics.inc("dispatch.fused_fallback")
    return run_program(fs.stages, x, engine, batched=batched)


class _FusedApply(torch.autograd.Function):
    """:func:`fused_apply` under autograd (the reference's custom VJP):
    a permutation-only cluster saves nothing, a compute-bearing one its
    input."""

    @staticmethod
    def forward(ctx, x, fs, engine, batched):
        ctx.fs, ctx.engine, ctx.batched = fs, engine, batched
        if fs.computes:
            ctx.save_for_backward(x)
        return _fused_forward(x, fs, engine, batched)

    @staticmethod
    def backward(ctx, ct):
        fs, engine, batched = ctx.fs, ctx.engine, ctx.batched
        x = ctx.saved_tensors[0] if fs.computes else None
        ct = ct.contiguous()
        return (_vjp_observed("fused", lambda: _fused_bwd_impl(
            fs, engine, batched, x, ct)), None, None, None)


def fused_apply(x: torch.Tensor, fs: FusedStage,
                engine: Union[str, EngineFn, None] = None,
                batched: bool = False) -> torch.Tensor:
    """Differentiable fused-cluster execution. Forward: ONE K4b pass on
    the ``"cuda"`` engine, per-stage otherwise. Backward: the inverse
    cluster for a permutation-only cluster; for a compute-bearing one ONE
    K5 pass on the ``"cuda"`` engine, the collapsed plan of the cluster
    otherwise (see :func:`_fused_bwd_impl`)."""
    if _needs_grad(x):
        return _FusedApply.apply(x, fs, engine, batched)
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


class _PermApply(torch.autograd.Function):
    """:func:`perm_apply` under autograd: a BMMC permutation is orthogonal,
    so its VJP is the offline-inverted BMMC through the same engine; no
    residual."""

    @staticmethod
    def forward(ctx, x, bmmc, engine, batched):
        ctx.bmmc, ctx.engine, ctx.batched = bmmc, engine, batched
        return _call_engine(get_engine(engine), x, bmmc, batched)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous()
        return (_vjp_observed("stage", lambda: perm_apply(
            ct, ctx.bmmc.inverse(), ctx.engine, ctx.batched)),
            None, None, None)


def perm_apply(x: torch.Tensor, bmmc: Bmmc,
               engine: Union[str, EngineFn, None] = None,
               batched: bool = False) -> torch.Tensor:
    """Differentiable BMMC permutation through any engine: the VJP applies
    ``bmmc.inverse()`` through the same engine."""
    if _needs_grad(x):
        return _PermApply.apply(x, bmmc, engine, batched)
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
        return tuple(_rounded(p, x.dtype).to(x.device)
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


def _compute_forward(s: Expr, x: torch.Tensor, axis: int) -> torch.Tensor:
    """A standalone ``CmpHalves`` or ``Bfly`` stage, as torch ops."""
    if isinstance(s, CmpHalves):
        h = x.shape[axis] // 2
        lo = x.narrow(axis, 0, h)
        hi = x.narrow(axis, h, h)
        out = torch.empty_like(x)   # each half written in place, no cat
        cmp_min(lo, hi, out=out.narrow(axis, 0, h))
        cmp_max(lo, hi, out=out.narrow(axis, h, h))
        return out
    return _apply_bfly(x, s.twiddles, axis)


class _ComputeApply(torch.autograd.Function):
    """A standalone compute stage under autograd: saves its input; the
    backward is the hand-written pairwise VJP (:func:`_compute_bwd`), so
    compare ties split as jax's balanced rule splits them and the
    partner gather's transpose stays a gather."""

    @staticmethod
    def forward(ctx, x, s, batched):
        ctx.s, ctx.batched = s, batched
        ctx.save_for_backward(x)
        return _compute_forward(s, x, 1 if batched else 0)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        ct = ct.contiguous()
        return (_vjp_observed("stage", lambda: _compute_bwd(
            ctx.s, x, ct, ctx.batched)), None, None)


class _MapApply(torch.autograd.Function):
    """A standalone ``Map`` stage under autograd: saves its input; the
    backward is autograd through the user's function at it, counted as
    the one element-wise sweep ``program_cost`` charges the stage."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        ctx.save_for_backward(x)
        return s.fn(x)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors

        def vjp():
            _ometrics.inc("dispatch.kernel", kernel="sweep")
            _ometrics.inc("model.round_trips", 1)
            with torch.enable_grad():
                v = x.detach().requires_grad_(True)
                return torch.autograd.grad(ctx.s.fn(v), v, ct)[0]
        return _vjp_observed("stage", vjp), None


def _exec_stage(s: Expr, x: torch.Tensor, engine, batched: bool,
                axis: int) -> torch.Tensor:
    """Dispatch ONE primitive/fused stage (the run_program loop body)."""
    if isinstance(s, Perm):
        return perm_apply(x, s.bmmc, engine, batched)
    if isinstance(s, FusedStage):
        return fused_apply(x, s, engine, batched)
    if isinstance(s, (CmpHalves, Bfly)):
        if _needs_grad(x):
            return _ComputeApply.apply(x, s, batched)
        return _compute_forward(s, x, axis)
    if isinstance(s, Map):
        if _needs_grad(x):
            return _MapApply.apply(x, s)
        return s.fn(x)
    raise BadStage(f"non-primitive stage {type(s).__name__}; "
                   "lower() the expression first")


def run_program(program: Sequence[Expr], x: torch.Tensor,
                engine: Union[str, EngineFn, None] = None,
                *, batched: bool = False) -> torch.Tensor:
    """Execute a lowered (primitive-only) stage program, eagerly, stage
    by stage. ``batched=True`` moves the permuted axis to axis 1, with a
    leading batch dim. Standalone computes are plain torch ops.
    Differentiable: every stage runs through its autograd rule when the
    input requires grad.

    When telemetry is enabled each stage records a ``stage.*`` span and
    standalone computes count as ``sweep`` kernel dispatches (matching
    :func:`repro_torch.combinators.optimize.program_cost`)."""
    get_engine(engine)  # validate the name up front, even for Perm-free
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
# Compiled backward pass (DESIGN.md §13)
#
# Every backward rule runs under _vjp_observed, which opens a
# "<kind>.vjp" span and credits the modeled round trips the rule
# dispatches to ``model.vjp_round_trips`` — the backward twin of the
# forward ``model.round_trips`` accounting, so one cold backward call's
# counter delta can be held against CompiledExpr.vjp_round_trips.
# ---------------------------------------------------------------------------

_VJP_STATE = threading.local()


def _vjp_observed(kind: str, fn: Callable):
    """Run one backward-rule body under a ``<kind>.vjp`` span.

    Counters fire as the backward runs (every call here is eager), so the
    delta of ``model.round_trips`` across the rule IS the modeled cost of
    the backward it dispatched. Nested rules — e.g. per-stage ``Perm``
    VJPs inside a replay — fold into the outermost rule's span via the
    reentrancy depth guard, never double-counting
    ``model.vjp_round_trips``.
    """
    if not _otrace._state.enabled or getattr(_VJP_STATE, "depth", 0):
        return fn()
    _VJP_STATE.depth = 1
    try:
        rt0 = _ometrics.counter_total("model.round_trips")
        with _otrace.span(kind + ".vjp") as sargs:
            out = fn()
            delta = _ometrics.counter_total("model.round_trips") - rt0
            sargs["model_round_trips"] = delta
        _ometrics.inc("dispatch.vjp", kind=kind)
        if delta:
            _ometrics.inc("model.vjp_round_trips", delta)
    finally:
        _VJP_STATE.depth = 0
    return out


@functools.lru_cache(maxsize=512)
def _fused_inverse_cached(fs: FusedStage) -> FusedStage:
    """The offline inverse of a permutation-only cluster — itself a
    cluster (per-class closure, DESIGN.md §13)."""
    return inverse_stage(fs)


def _bmmc_table(b: Bmmc) -> np.ndarray:
    """``tab[i] = b.apply(i)`` over all ``2^n`` indices, built by doubling
    (the map is affine over GF(2): ``tab[2^j + i] = tab[i] ^ A e_j``)."""
    tab = np.empty(1 << b.n, dtype=np.int64)
    tab[0] = b.c
    for j in range(b.n):
        tab[1 << j:2 << j] = tab[:1 << j] ^ (b.apply(1 << j) ^ b.c)
    return tab


@functools.lru_cache(maxsize=256)
def _pulled_back_tables(prefix: Bmmc, kind: str) -> tuple:
    """Offline numpy tables for one pulled-back compute ``C̃ = M⁻¹CM``.

    ``partner[i] = i ^ v`` with ``v = A_M⁻¹ e_{n-1}`` the pairing
    vector; ``side0[i]`` marks the "lo" role (bit n-1 of ``M(i)`` clear);
    ``w_idx[i]`` (bfly only) the twiddle slot = ``M(i)`` with the pair bit
    dropped, shared by both partners since ``M(v) = e_{n-1}``.
    """
    n = prefix.n
    m = _bmmc_table(prefix)
    partner = (np.arange(1 << n, dtype=np.int64)
               ^ pairing_vector(prefix)).astype(np.int32)
    side0 = ((m >> (n - 1)) & 1) == 0
    w_idx = None
    if kind == "bfly":
        w_idx = (m & ((1 << (n - 1)) - 1)).astype(np.int32)
    return partner, side0, w_idx


def _on(tab: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """An offline numpy table on ``like``'s device (kept there for a CUDA
    tensor; a CPU tensor shares the numpy memory when no cast is asked)."""
    def make():
        if dtype is not None and tab.dtype == np.float64:
            return _rounded(tab, dtype).to(like.device)
        t = torch.from_numpy(np.ascontiguousarray(tab))
        return t.to(device=like.device, dtype=dtype or t.dtype)
    if like.device.type == "cpu":
        return make()
    return device_cached(tab, ("table", str(dtype)), like.device, make)


def _along(tbl: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A per-index table shaped to broadcast along ``axis`` of an
    ``ndim``-dimensional array."""
    return tbl.reshape((1,) * axis + (-1,) + (1,) * (ndim - axis - 1))


@functools.lru_cache(maxsize=256)
def _pulled_back_fn(comp: Expr, prefix: Bmmc, batched: bool) -> tuple:
    """The compute conjugated into the cluster's input space, as an
    explicit ``(fwd, bwd)`` pair of plain torch functions.

    ``fwd(u)`` recomputes the conjugated stage — an XOR-partner gather
    plus the pairwise compute, bitwise-matching the per-stage replay: the
    (lo, hi) argument ORDER of the min/max (and the ``lo ± w·hi``
    butterfly terms) is canonicalized by the side predicate. ``bwd(u,
    ct)`` is the VJP, written by hand so that the gather's transpose stays
    a gather (``Pᵀ = P`` for an involution): a compare's is ``ct * m1 +
    P(ct * m2)`` with jax's balanced tie masks, a butterfly's (linear)
    ``ct + P(ct)`` on its "lo" member and ``Wᵀ(P(ct) - ct)`` on its "hi"
    member — the arithmetic of the collapsed sweep and of K5, so the
    three routes agree bit for bit. When the pairing vector is the top
    bit (a standalone compute) the partner gather is a swap of the
    halves. (A ``Map`` has no pair: its backward is autograd through the
    user's function, :func:`_replay_vjp`.)
    """
    axis = 1 if batched else 0
    n = prefix.n
    kind = "cmp" if isinstance(comp, CmpHalves) else "bfly"
    partner_np, side0_np, w_idx = _pulled_back_tables(prefix, kind)
    if pairing_vector(prefix) == 1 << (n - 1):
        def partner(v):   # i ^ 2^(n-1): the two halves swapped
            return torch.roll(v, 1 << (n - 1), axis)
    else:
        def partner(v):
            return v.index_select(axis, _on(partner_np, v))

    if kind == "cmp":
        def fwd(u):
            s0 = _along(_on(side0_np, u), u.dim(), axis)
            up = partner(u)
            lo = torch.where(s0, u, up)
            hi = torch.where(s0, up, u)
            return torch.where(s0, cmp_min(lo, hi), cmp_max(lo, hi))

        def bwd(u, ct):
            o = fwd(u)
            m1, m2 = tie_masks(u == o, partner(u) == o, ct.dtype)
            return ct * m1 + partner(ct * m2)
        return fwd, bwd

    w = np.asarray(comp.twiddles, dtype=np.complex128)[w_idx]
    w_re = np.ascontiguousarray(w.real)
    w_im = np.ascontiguousarray(w.imag)

    def tables(u):   # side0 and (wr, wi) over the index axis
        return (_on(side0_np, u), _on(w_re, u, u.dtype),
                _on(w_im, u, u.dtype))

    def fwd(u):      # planar layout: (..., 2^n, 2)
        s0, wr, wi = tables(u)
        s0b = s0[:, None]   # broadcasts over the (re, im) dim
        up = partner(u)
        lo = torch.where(s0b, u, up)
        hi = torch.where(s0b, up, u)
        tre = wr * hi[..., 0] - wi * hi[..., 1]
        tim = wr * hi[..., 1] + wi * hi[..., 0]
        t = torch.stack([tre, tim], dim=-1)
        return torch.where(s0b, lo + t, lo - t)

    def bwd(u, ct):
        s0, wr, wi = tables(ct)
        return bfly_transpose(ct, partner(ct), s0, wr, wi)

    return fwd, bwd


def _compute_bwd(s: Expr, x: torch.Tensor, ct: torch.Tensor,
                 batched: bool) -> torch.Tensor:
    """The VJP of a standalone compute stage at its saved input ``x``:
    the pulled-back pair with the identity prefix. It reads and writes the
    array once, as the forward does, so it counts one ``sweep``."""
    if x.is_complex():
        return torch.view_as_complex(_compute_bwd(
            s, torch.view_as_real(x.resolve_conj()),
            torch.view_as_real(ct.resolve_conj()), batched))
    n = int(x.shape[1 if batched else 0]).bit_length() - 1
    _ometrics.inc("dispatch.kernel", kernel="sweep")
    _ometrics.inc("model.round_trips", 1)
    return _pulled_back_fn(s, Bmmc.identity(n), batched)[1](x, ct)


def _bwd_plan_n(prog: Program) -> Optional[int]:
    """n of a program the collapsed backward can take, or None when a
    stage falls outside the pairwise algebra (``Map``)."""
    n = None
    for st in prog:
        if isinstance(st, FusedStage):
            if any(isinstance(c, Map) for c, _ in st.computes):
                return None
            n = st.bmmc.n
        elif isinstance(st, Perm):
            n = st.bmmc.n
        elif not isinstance(st, (CmpHalves, Bfly)):
            return None
    return n


def _collapsed_final(prog: Program, n: int) -> Optional[FusedStage]:
    """The composed inverse pass that ends the collapsed backward: every
    permutation of the program bubbled to the end (source map ``σ``), as a
    compute-free cluster, or None when it is the identity."""
    sigma = Bmmc.identity(n)
    for st in reversed(prog):
        if isinstance(st, (Perm, FusedStage)):
            sigma = sigma @ st.bmmc
    if sigma.is_identity_perm():
        return None
    # Perm(g) gathers from g⁻¹, so realizing the bubbled op (source map σ)
    # takes the stage whose BMMC is σ⁻¹
    return _run_fused((Perm(sigma.inverse()),), n)


_BwdPlan = collections.namedtuple(
    "_BwdPlan", ["n", "recs", "links", "final", "has_bfly"])


@functools.lru_cache(maxsize=16)
def _program_bwd_plan(prog: Program, batched: bool):
    """The collapsed whole-program backward plan (DESIGN.md §13), or
    None when a stage falls outside the pairwise algebra (``Map``).

    Every transposed compute in the backward chain is a PAIRWISE op
    (XOR-partner gather plus elementwise math), so it can be conjugated
    through the BMMC passes that follow it in backward time: with ``Π``
    the accumulated permutation, ``Lᵀ`` becomes ``Π⁻¹ Lᵀ Π`` — still
    pairwise, with pairing vector and per-element tables permuted
    OFFLINE. Bubbling every perm to the end collapses the entire backward
    to: all transposed computes in forward-OUTPUT coordinates, then ONE
    composed inverse BMMC pass.

    The reference runs same-kind link runs as ``lax.scan``\\ s over
    stacked tables, to keep XLA on the CPU from fusing across links; torch
    runs eagerly, so the links run in a plain loop, each with its own
    masks. The tables hold ``2^n`` entries per link, so the plan suits
    moderate ``n``; the ``"cuda"`` engine's gradient kernel route needs
    none of it.

    Returns ``(n, recs, links, final, has_bfly)``:

    - ``recs[k] = (res_index, fwd_fns | None)`` — one per compute-bearing
      stage in BACKWARD order; ``fwd_fns`` recomputes the pulled-back
      intermediate chain from the saved stage input (None when no link
      needs intermediates, e.g. all-butterfly: linear, residual-free).
    - ``links`` — transposed computes in backward-time order, conjugated
      into output coordinates: ``("cmp", rec, j, gu, gup, pY)`` with
      ``gu``/``gup`` the u/partner gather tables and ``pY`` the
      conjugated pairing; ``("bfly", pY, side0, w_re, w_im)``.
    - ``final`` — the composed inverse BMMC as a compute-free
      :class:`FusedStage`, or None if it collapses to the identity.
    """
    n = _bwd_plan_n(prog)
    if n is None:
        return None
    ident = Bmmc.identity(n)
    # residual slots: res[0] is the program input (kept for the replay
    # fallback), then one entry per compute-bearing stage in forward
    # order — permutation stages and perm-only clusters save NOTHING
    res_of, ri = {}, 1
    for si, st in enumerate(prog):
        if isinstance(st, (CmpHalves, Bfly)) or (
                isinstance(st, FusedStage) and st.computes):
            res_of[si] = ri
            ri += 1
    sigma = ident  # X-coords -> Y-coords map of the perms bubbled so far
    links, recs = [], []
    has_bfly = False
    for si in range(len(prog) - 1, -1, -1):
        st = prog[si]
        if isinstance(st, Perm):
            sigma = sigma @ st.bmmc
            continue
        if isinstance(st, FusedStage):
            # FSᵀ = c̃1ᵀ ∘ … ∘ c̃mᵀ ∘ B⁻¹: the B⁻¹ factor bubbles first,
            # so the cluster's own links are conjugated through it too
            sigma = sigma @ st.bmmc
            comps = st.computes
        else:
            comps = ((st, ident),)
        if not comps:
            continue
        rec_id = len(recs)
        fwds = tuple(_pulled_back_fn(c, p, batched)[0] for c, p in comps)
        recs.append([res_of[si], fwds, False])
        tau_tab = _bmmc_table(sigma.inverse())  # Y index -> link-space index
        a_off = sigma.apply(0)
        for j in range(len(comps) - 1, -1, -1):
            comp, prefix = comps[j]
            kind = "cmp" if isinstance(comp, CmpHalves) else "bfly"
            partner, side0, w_idx = _pulled_back_tables(prefix, kind)
            pv = int(pairing_vector(prefix))
            # conjugated pairing: partner'(y) = σ(σ⁻¹(y) ^ v) = y ^ A_σ v
            p_y = (np.arange(1 << n, dtype=np.int64)
                   ^ (sigma.apply(pv) ^ a_off)).astype(np.int32)
            if kind == "cmp":
                recs[rec_id][2] = True  # masks need the recomputed chain
                links.append(("cmp", rec_id, j, tau_tab.astype(np.int32),
                              (tau_tab ^ pv).astype(np.int32), p_y))
            else:
                has_bfly = True
                w = np.asarray(comp.twiddles, np.complex128)[w_idx]
                links.append(("bfly", p_y, side0[tau_tab],
                              np.ascontiguousarray(w.real)[tau_tab],
                              np.ascontiguousarray(w.imag)[tau_tab]))
    recs = tuple((r[0], r[1] if r[2] else None) for r in recs)
    return _BwdPlan(n, recs, tuple(links), _collapsed_final(prog, n),
                    has_bfly)


def _collapsed_bwd(plan, res, ct, engine, batched):
    """Execute a collapsed backward plan: recompute the pulled-back
    intermediate chains from the saved stage inputs, sweep every
    transposed compute in forward-output coordinates (a compare ``m1 * c
    + take(m2 * c, p)``, its masks from the recomputed chain; a butterfly
    the transposed pair), then run the ONE composed inverse pass through
    the fused engine."""
    axis = 1 if batched else 0
    us = []
    for res_i, fwds in plan.recs:
        if fwds is None:
            us.append(None)
            continue
        chain = [res[res_i]]
        for f in fwds:
            chain.append(f(chain[-1]))
        us.append(chain)

    def take(v, tab):
        return v.index_select(axis, _on(tab, v))

    for link in plan.links:
        if link[0] == "cmp":
            _, rec, j, gu, gup, p_y = link
            u, o = us[rec][j], us[rec][j + 1]
            og = take(o, gu)
            m1, m2 = tie_masks(take(u, gu) == og, take(u, gup) == og,
                                ct.dtype)
            ct = m1 * ct + take(m2 * ct, p_y)
        else:
            _, p_y, side0, w_re, w_im = link
            ct = bfly_transpose(ct, take(ct, p_y), _on(side0, ct),
                                 _on(w_re, ct, ct.dtype),
                                 _on(w_im, ct, ct.dtype))
    if plan.final is not None:
        ct = fused_apply(ct, plan.final, engine, batched)
    return ct


@functools.lru_cache(maxsize=256)
def _fused_bwd_kernel_plan(fs: FusedStage, t: int):
    """Offline artifacts of the gradient kernel for one cluster, or None
    when it can't run at this tile parameter (any number of maps: K5
    keeps the inputs of those that fit its shared memory and recomputes
    the others'): the forward plan + epilogue
    entries (shared tables), the inverse ``src0`` gather table
    (``inv[src0[j]] = j``; the per-tile XOR folds into the lookup at
    kernel time), and the inverse plans of any trailing plain passes
    (§5.2 two-pass factorizations — undone pass by pass before the
    gradient kernel, keeping the backward round-trip count equal to the
    forward's; unreachable for ``0 < t <= n/2``, kept for parity)."""
    got = _fused_plan_cached(fs, t)
    if got is None:
        return None
    plans, entries = got
    p = plans[0].src0.reshape(-1)
    inv_src0 = np.empty_like(p)
    inv_src0[p] = np.arange(p.size, dtype=p.dtype)
    inv_src0 = inv_src0.reshape(plans[0].src0.shape)
    extra = []
    for pass_plan in plans[1:]:
        try:
            extra.append(tuple(plan_bmmc(pass_plan.bmmc.inverse(), t)))
        except ValueError:
            return None
        if len(extra[-1]) != 1:
            return None  # inverse pass count must mirror the forward's
    return plans, entries, inv_src0, tuple(extra)


def _fused_bwd_cuda(fs, t, batched, x, ct):
    """One-kernel cluster backward: undo the trailing plain passes, then
    run the gradient kernel K5 over the forward's own plan (its plain
    version for a CPU tensor)."""
    plans, entries, inv_src0, extra = _fused_bwd_kernel_plan(fs, t)
    for inv_plans in reversed(extra):
        for p in inv_plans:
            ct = tiled_permute(ct, p, batched=batched)
    plan = plans[0]
    tabs, epi = _pass_tables(plan, entries, x)
    inv = inv_src0
    if x.device.type == "cuda":
        dev = x.device
        inv = device_cached(plan, "inv_src0", dev,
                            lambda: torch.from_numpy(inv_src0).to(dev))
    return tiled_permute_bwd_tables(
        x.contiguous(), ct.contiguous(), tabs[0], tabs[1], tabs[2], inv,
        geometry=plan_geometry(plan), batched=batched, **epi)


# The gradient kernel (K5, `tile_bwd.cu`) is the hardware-shaped backward:
# ONE pass per compute cluster, streaming the saved input beside the
# cotangent and replaying / transposing every epilogue on chip. The
# reference leaves it off (`BWD_MEGAKERNEL = False`) because its Pallas
# kernel runs slowly in interpret mode, and asks for it on a compiled
# backend; the card is one. It also bounds the memory: the collapsed
# backward keeps every recomputed intermediate (about 370 arrays for the
# 2^24 sort, some 23 GiB of float32) and the reference stacks its
# per-link masks on top, which does not fit the card; this route keeps
# only the inputs of the compute-bearing stages (70 arrays, 4.4 GiB).
# False runs the collapsed backward on the "cuda" engine too.
BWD_MEGAKERNEL = True


def _replay_vjp(stages, x, ct, engine, batched):
    """The backward of ``stages`` at ``x`` by autograd through their
    per-stage rules (``Map`` stages through the user's function)."""
    with torch.enable_grad():
        v = x.detach().requires_grad_(True)
        y = run_program(stages, v, engine, batched=batched)
        return torch.autograd.grad(y, v, ct)[0]


def _fused_bwd_impl(fs, engine, batched, x, ct):
    if not fs.computes:
        # permutation-only: dispatch the precompiled inverse cluster —
        # same kernels, zero residuals (x is None)
        return fused_apply(ct, _fused_inverse_cached(fs), engine, batched)
    lead = 1 if batched else 0
    planar = ct.dim() == 2 + lead and ct.shape[-1] == 2
    if ct.is_complex() or (not planar and any(
            isinstance(c, Bfly) for c, _ in fs.computes)):
        # layouts the pulled-back tables don't model (complex / non-planar
        # butterflies): replay the stage program under autograd
        return _replay_vjp(fs.stages, x, ct, engine, batched)
    if engine == "cuda" and BWD_MEGAKERNEL:
        t = _fused_tile(x, fs, batched)
        if (t is not None and _fused_bwd_kernel_plan(fs, t) is not None
                and not any(map_lower.lower_map(c.name, c.fn, x.dtype).nodiff
                            for c, _ in fs.computes if isinstance(c, Map))):
            if _otrace._state.enabled:
                plans, _, _, extra = _fused_bwd_kernel_plan(fs, t)
                rt = 1 + sum(len(ip) for ip in extra)
                _ometrics.inc("dispatch.kernel", kernel="fused")
                _ometrics.inc("model.round_trips", rt)
                # the gradient kernel streams x in ADDITION to ct: its
                # descriptor count is the forward's plus one extra read
                # stream per tile
                p0 = plans[0]
                _ometrics.inc(
                    "dma.descriptors",
                    p0.dma_descriptors()
                    + p0.n_tiles * (p0.rows_per_tile // p0.in_run)
                    + sum(p.dma_descriptors() for ip in extra for p in ip))
                with _otrace.span("kernel.fused_bwd", stages=len(fs.stages),
                                  passes=rt, t=t):
                    return _fused_bwd_cuda(fs, t, batched, x, ct)
            return _fused_bwd_cuda(fs, t, batched, x, ct)
        # a layout the kernel does not take (dtype, tail, a Map the tape
        # cannot run or autograd cannot differentiate): the honest count
        # the model lacks, as in the forward
        _ometrics.inc("dispatch.fused_fallback")
    plan = _program_bwd_plan((fs,), batched)
    if plan is None:
        # Map-bearing cluster: autograd through the per-stage rules
        return _replay_vjp(fs.stages, x, ct, engine, batched)
    return _collapsed_bwd(plan, (x, x), ct, engine, batched)


def _kernel_route_bwd(prog, res, ct, engine, batched):
    """The backward of a compute-bearing program on the gradient kernel
    route: its stages in reverse, each by its own rule — K5 per compute
    cluster, the inverse pass per permutation or compute-free cluster,
    the pairwise VJP per standalone compute (``res`` holds the program's
    input, then the input of every compute-bearing stage in order)."""
    ri = len(res) - 1
    for st in reversed(prog):
        if isinstance(st, Perm):
            ct = perm_apply(ct, st.bmmc.inverse(), engine, batched)
        elif isinstance(st, FusedStage) and not st.computes:
            ct = fused_apply(ct, _fused_inverse_cached(st), engine, batched)
        else:
            x, ri = res[ri], ri - 1
            if isinstance(st, FusedStage):
                ct = _fused_bwd_impl(st, engine, batched, x, ct)
            elif isinstance(st, Map):
                ct = _replay_vjp((st,), x, ct, engine, batched)
            else:
                ct = _compute_bwd(st, x, ct, batched)
    return ct


def _program_bwd(prog, res, ct, engine, batched):
    """The backward of a compute-bearing program: the gradient kernel
    route on the ``"cuda"`` engine with ``BWD_MEGAKERNEL``, else the
    collapsed plan, else (``Map``, complex, non-planar butterflies) the
    per-stage replay."""
    if engine == "cuda" and BWD_MEGAKERNEL:
        return _kernel_route_bwd(prog, res, ct, engine, batched)
    lead = 1 if batched else 0
    planar = ct.dim() == 2 + lead and ct.shape[-1] == 2
    plan = _program_bwd_plan(prog, batched)
    if plan is None or ct.is_complex() or (plan.has_bfly and not planar):
        return _replay_vjp(prog, res[0], ct, engine, batched)
    return _collapsed_bwd(plan, res, ct, engine, batched)


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
    buffer, so no two results share memory.

    :meth:`warm` captures ahead of the first call (an eager run with the
    telemetry off, on zeros): the backward of a permutation-only program
    is warmed in its forward, so no capture starts on autograd's backward
    thread. The first call after a warm-up still runs eagerly, so a cold
    call counts as it would have."""

    def __init__(self, prog: Program, engine: str, batched: bool):
        self.prog, self.engine, self.batched = prog, engine, batched
        self.graph = None
        self.fresh = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return self._capture(x)
        if self.fresh:
            self.fresh = False
            return run_program(self.prog, x, self.engine,
                               batched=self.batched)
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out.clone()

    def warm(self, like: torch.Tensor) -> None:
        if self.graph is None:
            with _telemetry_off():
                self._capture(torch.zeros_like(like))
            self.fresh = True

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


@functools.lru_cache(maxsize=512)
def _inverse_program_cached(prog: Program) -> Program:
    """The offline-inverted program (clusters invert to clusters) — what
    :func:`program_apply`'s backward runs for a permutation-only
    program."""
    return inverse_program(prog)


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
    is named, the program carries no user ``Map`` and no autograd graph
    is being built (one graph replay per call on the card), eager
    per-stage otherwise; observed when telemetry is on."""
    use_exec = (isinstance(engine, str) and not _has_map(prog)
                and not _needs_grad(x) and active_guard_flags() is None)
    if not _otrace._state.enabled:
        if use_exec:
            return _executable_for(prog, engine, batched, x)(x)
        return run_program(prog, x, engine, batched=batched)
    return _observed_program_call(prog, t, x, engine, batched, use_exec)


def _guarded_forward(prog: Program, t: Optional[int], x: torch.Tensor,
                     engine, batched: bool) -> torch.Tensor:
    """The forward of a guarded call that builds an autograd graph (run
    eagerly by ring 2 under its flag word): the program's own autograd
    rule, as an unguarded call would take it."""
    if is_perm_program(prog) or _bwd_plan_n(prog) is not None:
        return program_apply(x, prog, t, engine, batched)
    return run_program(prog, x, engine, batched=batched)


def _compute_bearing(st: Expr) -> bool:
    """Does the backward of this stage need its input?"""
    return isinstance(st, COMPUTES) or (
        isinstance(st, FusedStage) and bool(st.computes))


class _ProgramApply(torch.autograd.Function):
    """:func:`program_apply` under autograd: the whole program as ONE
    rule (the per-stage rules do not fire under it)."""

    @staticmethod
    def forward(ctx, x, prog, t, engine, batched):
        ctx.prog, ctx.t, ctx.engine, ctx.batched = prog, t, engine, batched
        if is_perm_program(prog):
            return _dispatch_program(prog, t, x, engine, batched)
        # eager, stage by stage, keeping the input of every compute-
        # bearing stage (res[0] is the program input)
        res, v = [x], x
        for st in prog:
            if _compute_bearing(st):
                res.append(v)
            v = run_program((st,), v, engine, batched=batched)
        ctx.save_for_backward(*res)
        return v

    @staticmethod
    def backward(ctx, ct):
        prog, t, engine, batched = ctx.prog, ctx.t, ctx.engine, ctx.batched
        ct = ct.contiguous()
        if is_perm_program(prog):
            inv = _inverse_program_cached(prog)
            g = _vjp_observed("program", lambda: _dispatch_program(
                inv, t, ct, engine, batched))
        else:
            res = ctx.saved_tensors
            g = _vjp_observed("program", lambda: _program_bwd(
                prog, res, ct, engine, batched))
        return g, None, None, None, None


def program_apply(x: torch.Tensor, prog: Program, t: Optional[int],
                  engine: Union[str, EngineFn, None] = None,
                  batched: bool = False) -> torch.Tensor:
    """Differentiable whole-program execution of a resolved program.

    Forward and backward are compiled programs, and the whole call is ONE
    autograd rule:

    - a permutation-only program runs its offline-inverted program — the
      *clustered* inverse of a clustered forward, so every stage keeps its
      kernel class — through its own executable; NO residuals are saved.
    - a compute-bearing program saves the inputs of its compute-bearing
      stages (a permutation needs none) and runs eagerly when it records a
      graph; its backward is the gradient kernel route on the ``"cuda"``
      engine (``BWD_MEGAKERNEL``), the COLLAPSED plan otherwise.
    - anything else (``Map`` stages, complex dtypes, non-planar
      butterflies) falls back to autograd through the per-stage rules.
    """
    if _needs_grad(x):
        return _ProgramApply.apply(x, prog, t, engine, batched)
    return _dispatch_program(prog, t, x, engine, batched)


CacheStats = collections.namedtuple(
    "CacheStats", ["hits", "misses", "maxsize", "currsize"])


def cache_stats() -> Dict[str, CacheStats]:
    """Aggregate stats for every executor/ops cache, by name: the
    whole-program executables (``program``), the plan/table caches
    (``fused_plan`` / ``w_planar`` / ``lowered`` / ``clustered`` /
    ``model_round_trips``, the ops ``plans`` / ``class_plan``), the
    backward's (``inverse_program`` / ``fused_inverse`` /
    ``program_bwd_plan`` / ``fused_bwd_kernel_plan`` / ``pulled_back``),
    the maps' tapes (``map_tapes``), the tables kept on the device
    (``device_tables``), the guard's
    ring-1 caches and ring-2 executables, the ``compiled_exprs`` memo, and
    the durable plan store (``store``: session hits / misses, entries on
    disk)."""
    from ..kernels import bmmc_permute as K

    out = {
        "program": _program_executable,
        "fused_plan": _fused_plan_cached,
        "w_planar": _w_planar_cached,
        "lowered": _lowered_cached,
        "clustered": _clustered_cached,
        "model_round_trips": _program_round_trips,
        "inverse_program": _inverse_program_cached,
        "fused_inverse": _fused_inverse_cached,
        "program_bwd_plan": _program_bwd_plan,
        "fused_bwd_kernel_plan": _fused_bwd_kernel_plan,
        "pulled_back": _pulled_back_fn,
        "map_tapes": map_lower,
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
    from .. import store as _store
    ss = _store.stats()
    st = _store.active()
    stats["store"] = CacheStats(
        hits=ss["hit"], misses=ss["miss"], maxsize=None,
        currsize=st.entry_count() if st is not None else 0)
    return stats


class CompiledExpr:
    """A callable compiled combinator expression.

    Calling it executes the (fused) stage program through the chosen
    engine, on the device of its input; the result is differentiable
    (``loss.backward()`` runs the compiled backward, see
    :func:`program_apply`), and ``batched=True`` takes a leading batch
    dim sharing one tile plan. ``program(n)`` exposes the stage program
    for inspection; ``cost(n, t)`` the modeled transaction report;
    ``vjp_program(n)`` the program the backward pass of a
    permutation-only expression executes, ``vjp_round_trips(n, t)`` the
    round trips of one backward.
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

    def vjp_program(self, n: int, t: Optional[int] = None) -> Program:
        """The offline-inverted program (reversed stages, each BMMC
        inverted) — what the cotangent flows through. With ``t`` the
        CLUSTERED inverse — clusters invert to clusters (§13), which is
        exactly what the ``"cuda"`` backward executes. Permutation-only."""
        prog = self.program(n) if t is None else self.clustered_program(n, t)
        return inverse_program(prog)

    def vjp_round_trips(self, n: int, t: Optional[int],
                        dtype: torch.dtype = torch.float32,
                        batched: bool = False) -> Optional[int]:
        """Modeled HBM round trips of ONE backward (cotangent) pass — what
        a cold backward call's ``model.vjp_round_trips`` counter delta
        should equal (the backward honesty gate, DESIGN.md §13).

        A permutation-only program runs the clustered inverse program. A
        compute-bearing program on the ``"cuda"`` engine with
        ``BWD_MEGAKERNEL`` takes the gradient kernel route, which costs
        what its forward costs: each compute cluster one K5 pass (plus the
        inverse of any trailing plain pass), each permutation its inverse
        pass, each standalone compute one sweep (on the layouts the
        kernel takes; a cluster that falls back counts otherwise). A
        program that holds a ``Map`` runs stage by stage, each stage's
        backward by its own rule, and counts the same on this route: a
        standalone ``Map`` one sweep, a Map-bearing cluster one K5 pass
        when its maps lower for the element type ``dtype`` (a map may
        lower for one type and not for another: then the cluster runs
        stage by stage on that type, and the model is None there). With a
        collapsed plan it pays exactly the final composed pass. None when
        the backward is the per-stage replay (no compiled model to hold it
        against)."""
        from .optimize import program_cost
        prog = (self.clustered_program(n, t)
                if self.engine == "cuda" and self.optimized
                and t is not None else self.program(n))
        if t is None:
            return None
        if is_perm_program(prog):
            return program_cost(inverse_program(prog), t)["round_trips"]
        if self.engine == "cuda" and BWD_MEGAKERNEL:
            total = 0
            for s in prog:
                if isinstance(s, FusedStage) and s.computes:
                    kp = _fused_bwd_kernel_plan(s, t)
                    if kp is None or not _maps_lowered(s, dtype):
                        return None
                    total += 1 + sum(len(ip) for ip in kp[3])
                elif isinstance(s, (Perm, FusedStage)):
                    total += program_cost((inverse_stage(s),),
                                          t)["round_trips"]
                else:
                    total += 1
            return total
        if _bwd_plan_n(prog) is None:
            return None
        final = _collapsed_final(prog, _bwd_plan_n(prog))
        if final is None:
            return 0
        return program_cost((final,), t)["round_trips"]

    def inverse(self, n: int) -> "CompiledExpr":
        """The compiled inverse of a permutation-only expression."""
        from .ir import seq
        inv = seq(*self.vjp_program(n))
        return compile_expr(inv, engine=self.engine, optimize=self.optimized)

    def __call__(self, x: torch.Tensor, *,
                 batched: bool = False) -> torch.Tensor:
        prog, t = self._resolve(x, batched)
        from ..guard import runtime as _grt
        if _grt.ring2_active():
            # ring 2: the program and its probes with a device flag word
            # (one CUDA graph on the card), read once here, with the
            # cuda → ref fallback machine on a trap
            return _grt.guarded_call(prog, t, x, self.engine, batched)
        if is_perm_program(prog):
            # permutation-only: ONE autograd rule whose backward runs the
            # precompiled inverse program. Capture the inverse's graph
            # now, on this thread, so a training step's first backward
            # starts no capture on autograd's backward thread.
            if (isinstance(self.engine, str) and _needs_grad(x)
                    and x.device.type == "cuda"):
                exe = _executable_for(_inverse_program_cached(prog),
                                      self.engine, batched, x)
                if isinstance(exe, _CapturedProgram):
                    exe.warm(x)
            return program_apply(x, prog, t, self.engine, batched)
        lead = 1 if batched else 0
        if (_needs_grad(x) and x.dtype == torch.complex64
                and x.dim() == 1 + lead and not _has_map(prog)):
            # a complex array is differentiated on its planar (re, im)
            # view, which runs the same kernels (and the same program:
            # the tile parameter depends on the element's bytes only)
            return torch.view_as_complex(
                self(torch.view_as_real(x.resolve_conj()), batched=batched))
        # Programs carrying user Map callables stay on the eager per-stage
        # path (inside _dispatch_program), differentiated stage by stage
        if not _has_map(prog) and _bwd_plan_n(prog) is not None:
            # compute-bearing program: one autograd rule; the backward is
            # the gradient kernel route or the collapsed plan
            return program_apply(x, prog, t, self.engine, batched)
        return _dispatch_program(prog, t, x, self.engine, batched)

    def call_per_stage(self, x: torch.Tensor, *,
                       batched: bool = False) -> torch.Tensor:
        """Execute stage-at-a-time through the Python dispatcher, eagerly
        — the path without the whole-program executable, kept for the
        host-side dispatch-overhead measurement and as a debugging aid;
        differentiable through the per-stage rules."""
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
    _inverse_program_cached.cache_clear()
    _fused_inverse_cached.cache_clear()
    _program_bwd_plan.cache_clear()
    _fused_bwd_kernel_plan.cache_clear()
    _pulled_back_fn.cache_clear()
    _pulled_back_tables.cache_clear()
    map_lower.clear_cache()
    _COMPILED.clear()
    _compiled_stats["hits"] = _compiled_stats["misses"] = 0
    ops._plans_cached.cache_clear()
    ops._class_plan_cached.cache_clear()
    K.clear_device_tables()
    clear_guard_caches()
    from .. import guard, resilience, store
    guard.reset_stats()
    store.reset_stats()
    resilience.reset()
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
