"""Train step: loss + grads + (optionally 8-bit) AdamW update.

The counterpart of :mod:`repro.train.step`. PyTorch runs eagerly, so the
step is a plain function of ``(params, opt_state, batch)``. It overwrites
the parameters and the optimizer state it is given and returns them with
the step's metrics: the reference's launcher jits its step with both
donated, which is the same contract (hold a copy to keep the old ones).
Gradient accumulation is a Python loop over microbatches with a float32
gradient accumulator, so the peak activation footprint is one microbatch
regardless of global batch.

``loss_fn`` may override the model loss with any ``(params, batch) ->
(loss, parts_dict)`` — e.g. a loss routed through a
:class:`repro_torch.models.permute.PermuteLayer`, so autograd runs the
permutation kernels' backward (K4a for a permutation, K5 for a cluster
with computes) inside a full (grads + AdamW) training step.

Telemetry (:mod:`repro_torch.obs`, when enabled): each step records a
``train.step`` span, a ``train.step_us`` latency histogram entry, and
the permute share of the step — the permutation round trips dispatched
inside it (``train.permute_round_trips``, and those of backward rules,
``train.permute_vjp_round_trips``) plus the fraction of the step's wall
clock spent in ``program.call`` permute executions
(``train.permute_share``). With ``obs.enable(sync=True)`` the step waits
for the device before its clock stops.

``make_train_step(..., validate=True)`` returns the guarded variant: the
gradient phase runs under :mod:`repro_torch.guard`, and a nonfinite loss
or gradient norm raises a typed ``GuardTrap`` before the update touches
the parameters or the optimizer state.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import torch

from .. import obs
from ..configs.base import ArchConfig
from ..launch.op_analysis import is_fake
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update, state_shapes
from ..tree import tree_leaves, tree_map, tree_unflatten


def _program_call_us() -> float:
    return sum(s["sum"] for (nm, _), s in obs.histograms().items()
               if nm == "program.call_us")


def _observe_step(t0: int, sargs: dict, rt0, vjp0, perm0) -> None:
    dur_us = (time.perf_counter_ns() - t0) / 1e3
    sargs["dur_us"] = round(dur_us, 1)
    obs.observe("train.step_us", dur_us)
    rt = obs.counter_total("model.round_trips") - rt0
    if rt:  # permute stages dispatched inside this step
        obs.inc("train.permute_round_trips", rt)
    vjp = obs.counter_total("model.vjp_round_trips") - vjp0
    if vjp:  # backward-rule passes dispatched inside this step
        obs.inc("train.permute_vjp_round_trips", vjp)
    perm_us = _program_call_us() - perm0
    if perm_us and dur_us > 0:
        # CompiledExpr permute calls inside the step: their measured
        # share of the step wall clock
        obs.observe("train.permute_share", perm_us / dur_us)


def _instrument_step(train_step: Callable) -> Callable:
    """Wrap a step fn with per-step telemetry; transparent when obs is
    disabled (one attribute check)."""
    from ..guard import GuardTrap

    @functools.wraps(train_step)
    def observed(params, opt_state, batch):
        if not obs.enabled():
            return train_step(params, opt_state, batch)
        rt0 = obs.counter_total("model.round_trips")
        vjp0 = obs.counter_total("model.vjp_round_trips")
        perm0 = _program_call_us()
        with obs.span("train.step") as sargs:
            t0 = time.perf_counter_ns()
            try:
                out = train_step(params, opt_state, batch)
            except GuardTrap:
                # the reference's guard raises after its instrumented
                # step has recorded; any other error records no time
                _observe_step(t0, sargs, rt0, vjp0, perm0)
                raise
            if obs.sync_enabled():
                loss = out[2]["loss"]
                if loss.device.type == "cuda" and not is_fake(loss):
                    torch.cuda.synchronize(loss.device)
            _observe_step(t0, sargs, rt0, vjp0, perm0)
        return out

    return observed


def _guard_step(grads_fn: Callable, trap_retries: int = 1) -> Callable:
    """Guarded gradient phase (the reference's ``_guard_step``): it runs
    with :mod:`repro_torch.guard` rings active — plan validation plus
    guarded permute dispatch inside the loss — and resolves a step-level
    health check: a nonfinite loss or gradient norm raises the typed
    :class:`repro_torch.guard.GuardTrap` instead of poisoning the
    optimizer state (the update has not run yet).

    Transient traps retry: a *retryable* :class:`~repro_torch.guard.
    GuardError` escaping the gradient phase — e.g. a poisoned plan cache
    that quarantine + replan clears — is retried up to ``trap_retries``
    times (counted as ``resilience.retry``) before it propagates. The
    phase writes nothing it reads, so a retry is safe; the nonfinite
    check is deliberately OUTSIDE the retry loop — a nonfinite loss
    recomputes deterministically on the same batch, so retrying it would
    just re-prove the trap."""
    from .. import guard
    from ..resilience import policy as _rp

    @functools.wraps(grads_fn)
    def validated(params, batch):
        attempt = 0
        while True:
            try:
                with guard.guarded():
                    grads, metrics = grads_fn(params, batch)
                break
            except guard.GuardError as e:
                if (_rp.classify(e) != _rp.RETRYABLE
                        or attempt >= trap_retries):
                    raise
                attempt += 1
                _rp._record("retries", obs_name="resilience.retry")
        bad = [k for k in ("loss", "grad_norm")
               if k in metrics and not bool(torch.isfinite(metrics[k]))]
        if bad:
            err = guard.GuardTrap(("nonfinite",), "train")
            err.args = (f"guarded train step: nonfinite {bad} — the "
                        f"update would poison the optimizer state",)
            guard._record_trap("nonfinite", "train")
            guard._record_raised(err)
            raise err
        return grads, metrics

    return validated


def make_train_step(cfg: ArchConfig, mesh=None,
                    opt_cfg: Optional[AdamWConfig] = None,
                    grad_accum: int = 1,
                    loss_fn: Optional[Callable] = None,
                    validate: bool = False,
                    trap_retries: int = 1):
    """Returns ``(step, opt_cfg)``; ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` updates ``params`` and ``opt_state``
    in place (see the module docstring)."""
    opt_cfg = opt_cfg or AdamWConfig(state_bits=cfg.opt_bits)

    def loss_of(params, batch):
        if loss_fn is not None:
            return loss_fn(params, batch)
        return M.loss_fn(cfg, params, batch, mesh=mesh)

    def grads_of(leaves, params, batch):
        loss, parts = loss_of(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), tree_map(torch.Tensor.detach, parts), grads

    def grads_fn(params, batch):
        # the step differentiates aliases of the leaves: the caller's
        # tensors need not require grad, and autograd never sees the
        # in-place update
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        if grad_accum > 1:
            b = tree_leaves(batch)[0].shape[0]     # custom losses may
            if b % grad_accum:                     # not carry "tokens"
                raise ValueError(
                    f"a batch of {b} rows does not split into "
                    f"grad_accum={grad_accum} equal microbatches")
            mb = b // grad_accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            parts = None
            for i in range(grad_accum):
                micro = tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
                l, pt, g = grads_of(leaves, live, micro)
                grads = [a + gi for a, gi in zip(grads, g)]
                loss = loss + l
                if parts is None:
                    parts = tree_map(torch.zeros_like, pt)
                parts = tree_map(torch.add, parts, pt)
            grads = [g / grad_accum for g in grads]
            loss = loss / grad_accum
            # same metric keys as grad_accum=1: parts averaged over
            # microbatches
            parts = tree_map(lambda v: v / grad_accum, parts)
        else:
            loss, parts, grads = grads_of(leaves, live, batch)
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
        metrics = {"loss": loss, **parts, "grad_norm": grad_norm}
        return tree_unflatten(params, grads), metrics

    if validate:
        grads_fn = _guard_step(grads_fn, trap_retries=trap_retries)

    def train_step(params, opt_state, batch):
        grads, metrics = grads_fn(params, batch)
        params, new_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, new_state, metrics

    return _instrument_step(train_step), opt_cfg


def init_opt(cfg: ArchConfig, params, opt_cfg: Optional[AdamWConfig] = None):
    opt_cfg = opt_cfg or AdamWConfig(state_bits=cfg.opt_bits)
    return adamw_init(params, opt_cfg)


def opt_state_shapes(cfg: ArchConfig, param_shapes,
                     opt_cfg: Optional[AdamWConfig] = None):
    opt_cfg = opt_cfg or AdamWConfig(state_bits=cfg.opt_bits)
    return state_shapes(param_shapes, opt_cfg)
