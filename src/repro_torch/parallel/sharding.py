"""Logical-axis -> mesh-axis sharding rules (DP+FSDP / TP / EP / SP).

The counterpart of :mod:`repro.parallel.sharding`, rule for rule. Mesh
axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod. Rules:

* ``batch``                    -> (pod,) data       (DP)
* ``vocab, heads, kv_heads,
  mlp, experts``               -> model             (TP / EP)
* ``embed``                    -> (pod,) data       (FSDP parameter sharding;
                                  optimizer states follow parameters)
* everything else              -> replicated

A **divisibility guard** drops a rule when the dimension is not divisible by
the mesh-axis product (e.g. 36 heads or vocab 50280 on a 16-wide model axis
fall back to replicated). Each mesh axis is used at most once per tensor
(first dim wins).

A spec is a plain tuple with one entry a tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names. It equals
``tuple(PartitionSpec(...))`` of the reference's spec. These functions
read only ``mesh.axis_names`` and ``mesh.shape`` (a dict from name to
size), so a duck-typed mesh drives them at any shape with no process
group.

**Layouts in the port.** The reference's program under GSPMD holds one
global value per tensor, and outside ``shard_map`` a layout is a hint to
XLA. The port keeps activations and parameters **replicated on every
rank outside the all-to-all MoE body**, and cuts each rank's slice only
where the reference's ``shard_map`` does
(:func:`repro_torch.models.moe_a2a.moe_ffn_a2a`, its ``in_specs``). So
the constrainers return their input unchanged; each computes the spec
the reference would apply, and returns it on request (``.spec(x)``).
Sharding parameters or activations across ranks (FSDP, tensor or
sequence parallelism) is memory and speed work the port has not done:
a difference kept on purpose, not a fault.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

Spec = Tuple


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def logical_rules(mesh, *, fsdp: bool = True):
    dp = dp_axes(mesh)
    rules = {
        "batch": dp,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "seq_kv": ("model",),            # decode-cache sequence sharding (SP)
        "mlp": ("model",),
        "experts": ("model",),
        "embed": dp if fsdp else (),
        "state": (),
        "head_dim": (),
        "layers": (),
        # 8-bit optimizer moments: flat blocks sharded over every axis
        "opt_shard": (("pod",) if "pod" in mesh.axis_names else ()) + ("data", "model"),
    }
    return rules


def _axis_size(mesh, names: Tuple[str, ...]) -> int:
    return int(math.prod(mesh.shape[n] for n in names))


def spec_for(mesh, axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...], *, fsdp: bool = True,
             min_shard: int = 2) -> Spec:
    """The spec of a tensor with logical ``axes`` and ``shape``."""
    rules = logical_rules(mesh, fsdp=fsdp)
    used: set = set()
    parts = []
    for ax, dim in zip(axes, shape):
        names = rules.get(ax, ()) if ax else ()
        names = tuple(n for n in names if n not in used)
        sz = _axis_size(mesh, names)
        if names and sz > 1 and dim % sz == 0 and dim // sz >= min_shard:
            parts.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            parts.append(None)
    return tuple(parts)


def param_shardings(mesh, shapes_tree, axes_tree, *, fsdp: bool = True):
    """The spec tree of a parameter tree: ``shapes_tree`` has leaves with a
    ``.shape`` (tensors, ``meta`` tensors of
    :func:`repro_torch.models.model.param_shapes`), ``axes_tree`` the
    logical-axes tuples at the same positions. Where the reference gives
    a ``NamedSharding`` the port gives its spec."""
    def rec(s, a):
        if isinstance(s, dict):
            return {k: rec(s[k], a[k]) for k in s}
        return spec_for(mesh, a, tuple(s.shape), fsdp=fsdp)
    return rec(shapes_tree, axes_tree)


def batch_spec(mesh, batch_size: int, ndim: int) -> Spec:
    dp = dp_axes(mesh)
    sz = _axis_size(mesh, dp)
    if sz > 1 and batch_size % sz == 0:
        first = dp if len(dp) > 1 else dp[0]
        return (first,) + (None,) * (ndim - 1)
    return (None,) * ndim


def dp_size(mesh) -> int:
    if mesh is None:
        return 1
    return _axis_size(mesh, dp_axes(mesh))


class _Constrainer:
    """Returns its input unchanged (the port's layouts stay replicated
    outside the all-to-all MoE body); ``.spec(x)`` is the spec the
    reference's ``with_sharding_constraint`` applies to ``x``."""

    def __init__(self, spec_fn):
        self.spec = spec_fn

    def __call__(self, x):
        return x


def moe_buffer_constrainer(mesh):
    """(G, X, C, E) MoE buffers: the reference constrains them to
    (dp, model, None, None)."""
    if mesh is None:
        return None
    dp = dp_axes(mesh)
    first = dp if len(dp) > 1 else dp[0]

    def spec(buf) -> Spec:
        g, xn = buf.shape[0], buf.shape[1]
        gspec = first if g % _axis_size(mesh, dp) == 0 else None
        xspec = "model" if xn % mesh.shape["model"] == 0 else None
        return (gspec, xspec) + (None,) * (buf.ndim - 2)
    return _Constrainer(spec)


def activation_constrainer(mesh, seq_parallel: bool = False):
    """(B, S, E) activations at block boundaries: the reference constrains
    the batch over the DP axes, and with ``seq_parallel`` the sequence
    over ``model`` (Megatron-SP style) where it divides into slices of at
    least 128."""
    if mesh is None:
        return lambda x: x

    def spec(x) -> Optional[Spec]:
        if x.ndim < 1:
            return None
        sp = batch_spec(mesh, x.shape[0], x.ndim)
        if (seq_parallel and x.ndim == 3 and
                x.shape[1] % mesh.shape["model"] == 0 and
                x.shape[1] // mesh.shape["model"] >= 128):
            sp = (sp[0], "model", None)
        return sp
    return _Constrainer(spec)
