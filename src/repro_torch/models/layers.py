"""Shared layer primitives + parameter-definition infrastructure.

The counterpart of :mod:`repro.models.layers`. Parameters are plain
nested dicts of tensors; shapes and logical axes are declared through
``ParamDef`` trees, so one definition serves initialization, the cache
layout and the parameter paths the reference uses.

Numerics keep the reference's order of casts: normalisations and
activations run in float32 and cast back to the input's type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names, len == ndim
    dtype: Any = torch.bfloat16
    init: str = "normal"                      # normal | zeros | ones | small
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def tree_map_defs(fn, tree):
    """Map over ParamDef leaves of a nested dict."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    return {k: tree_map_defs(fn, v) for k, v in tree.items()}


def init_params(defs, generator: torch.Generator) -> Dict:
    """Materialize a ParamDef tree on ``generator``'s device.

    Leaves are drawn in the tree's order from the one generator, each as
    float32 normals times its scale, cast to the leaf's type (the
    reference draws ``jax.random.normal`` per leaf the same way; the two
    generators give different numbers, so tests carry the reference's
    weights across with :func:`repro_torch.models.convert.params_from_numpy`).
    Nothing is built on the host: the largest transient is one leaf in
    float32.
    """
    device = generator.device

    def make(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        std = d.scale
        if d.init == "small":
            std = d.scale / math.sqrt(max(d.shape[0], 1))
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(std).to(d.dtype)

    return tree_map_defs(make, defs)


def shape_tree(defs):
    """The tree as ``meta`` tensors: shapes and types, no storage (the
    reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def axes_tree(defs):
    return tree_map_defs(lambda d: d.axes, defs)


def stack_defs(defs, n: int, axis_name: Optional[str] = None):
    """Prepend a stacked (layer) axis to every leaf."""
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.dtype,
                           d.init, d.scale),
        defs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    h = x @ w_up + b_up
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_down + b_down


def matmul_f32(a, b):
    """``a @ b`` with float32 output and no rounding of the products to the
    inputs' type: the reference's ``preferred_element_type=jnp.float32``.
    The operands are widened to float32 first (a product of two bfloat16
    values is exact in float32), which costs a float32 copy of each
    operand; the sums run in float32."""
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, rotary_dim: Optional[int] = None,
               device=None):
    rd = rotary_dim or head_dim
    inv = 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
    return torch.as_tensor(inv.astype(np.float32), device=device)  # (rd//2,)


def apply_rope(x, positions, theta: float = 10000.0,
               rotary_dim: Optional[int] = None):
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    ``rotary_dim < D`` rotates only the first ``rotary_dim`` features
    (ChatGLM-style "2d" partial rotary); the rest pass through.
    """
    d = x.shape[-1]
    rd = rotary_dim or d
    inv = rope_freqs(d, theta, rd, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, rd//2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype), xp], dim=-1)


def causal_mask_bias(q_pos, k_pos, window: Optional[int] = None):
    """Additive mask bias (0 / -inf) for causal (+ optional local window)."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))
