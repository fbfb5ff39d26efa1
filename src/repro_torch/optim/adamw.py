"""AdamW with float32 or 8-bit block-quantized moments: the counterpart of
:mod:`repro.optim.adamw`.

With ``state_bits=8`` the first and second moments are stored as int8
with per-block float32 scales (block = trailing 256 elements along the
last axis, so the quantized moments keep the parameter's leading dims),
cutting optimizer memory 8x against float32.

:func:`adamw_update` computes what the reference computes, leaf by leaf
and rounding step by rounding step (``gf``, the moments, ``mhat``,
``vhat``, then ``pf - lr * (mhat / (sqrt(vhat) + eps) + wd * pf)``; no
fused multiply-add stands in for a product and a sum), but in place: the
parameters and moments it is given are overwritten and returned, as the
reference's launcher gets by donating them to its jitted step. The
arithmetic is element-wise, so each leaf is updated in slices of rows of
at most ``_CHUNK`` elements: the float32 temporaries stay a few hundred
MiB for any leaf (a 131072 x 5120 embedding would need 2.7 GB each
otherwise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_map, tree_zip

_BLOCK = 256
_CHUNK = 1 << 26       # elements of one leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_bits: int = 32          # 32 (f32 moments) or 8 (quantized)


class ShapeDtype(NamedTuple):
    """A leaf's shape and type without its data (``state_shapes``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# -- int8 block quantization -------------------------------------------------
#
# Blocks run along the LAST axis only: q keeps the parameter's leading
# dims (in the reference, so that the quantized moments inherit the
# parameter's sharding unchanged).

def _q_shape(shape):
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    blk = min(_BLOCK, last)
    nb = -(-last // blk)
    return shape[:-1] + (nb, blk), blk, nb * blk - last


def quantize8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-block int8 codes and float32 scales; codes round half to even,
    as ``jnp.round`` does."""
    if x.dim() == 0:
        x = x[None]
    qshape, blk, pad = _q_shape(x.shape)
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(qshape)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-20)).to(torch.int8)
    return {"q": q, "s": scale.to(torch.float32)}


def dequantize8(qt: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    shape = tuple(shape) or (1,)
    blocks = qt["q"].to(torch.float32) * qt["s"]
    flatlast = blocks.reshape(shape[:-1] + (-1,))
    return flatlast[..., :shape[-1]].reshape(shape)


def _q8_zeros(shape, device) -> Dict[str, torch.Tensor]:
    qshape, _, _ = _q_shape(tuple(shape) or (1,))
    return {"q": torch.zeros(qshape, dtype=torch.int8, device=device),
            "s": torch.zeros(qshape[:-1] + (1,), dtype=torch.float32,
                             device=device)}


# -- optimizer ----------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor     # int32, 0-d, on the parameters' device
    m: Any
    v: Any


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments beside each parameter leaf, step 0."""
    if cfg.state_bits == 8:
        m = tree_map(lambda p: _q8_zeros(p.shape, p.device), params)
        v = tree_map(lambda p: _q8_zeros(p.shape, p.device), params)
    else:
        m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        v = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    first = next(tree_zip(params))[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device), m=m, v=v)


def _update_rows(p, g, m, v, c1, c2, lr, cfg: AdamWConfig):
    """One slice of rows of one leaf, in place. ``m`` and ``v`` are float32
    views, or ``[q, s]`` pairs of views for 8-bit moments."""
    gf = g.float()
    if cfg.state_bits == 8:
        mf = dequantize8({"q": m[0], "s": m[1]}, p.shape)
        vf = dequantize8({"q": v[0], "s": v[1]}, p.shape)
    else:
        mf, vf = m, v
    mf.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    t = gf * (1 - cfg.b2)
    vf.mul_(cfg.b2).add_(t.mul_(gf))
    del gf, t
    mhat = mf / c1
    denom = (vf / c2).sqrt_().add_(cfg.eps)
    mhat.div_(denom)
    pf = p.float()                           # p itself for a float32 leaf
    mhat.add_(torch.mul(pf, cfg.weight_decay, out=denom)).mul_(lr)
    del denom
    pf.sub_(mhat)
    if pf is not p:
        p.copy_(pf)                          # round to nearest even
    if cfg.state_bits == 8:
        for (q, s), x in ((m, mf), (v, vf)):
            qt = quantize8(x)
            q.copy_(qt["q"])
            s.copy_(qt["s"])


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step, in place: returns ``(params, new state)`` with the
    given parameter tensors and moments overwritten."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    for p, g, m, v in tree_zip(params, grads, state.m, state.v):
        shape = tuple(p.shape) or (1,)
        lead = math.prod(shape[:-1])
        pr = p.view(lead, shape[-1])
        gr = g.reshape(lead, shape[-1])
        if cfg.state_bits == 8:
            mr = [x.view((lead,) + x.shape[-2:]) for x in (m["q"], m["s"])]
            vr = [x.view((lead,) + x.shape[-2:]) for x in (v["q"], v["s"])]
        else:
            mr, vr = m.view(lead, shape[-1]), v.view(lead, shape[-1])
        rows = max(1, _CHUNK // shape[-1])
        for r0 in range(0, lead, rows):
            sl = slice(r0, r0 + rows)
            if cfg.state_bits == 8:
                ms, vs = [x[sl] for x in mr], [x[sl] for x in vr]
            else:
                ms, vs = mr[sl], vr[sl]
            _update_rows(pr[sl], gr[sl], ms, vs, c1, c2, lr, cfg)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def state_shapes(param_shapes, cfg: AdamWConfig) -> AdamWState:
    """The optimizer state's shapes and types (``ShapeDtype`` leaves) for
    a tree of leaves that have ``.shape`` (tensors or ``ShapeDtype``)."""
    def q8_shape(p):
        qshape, _, _ = _q_shape(tuple(p.shape) or (1,))
        return {"q": ShapeDtype(qshape, torch.int8),
                "s": ShapeDtype(qshape[:-1] + (1,), torch.float32)}
    if cfg.state_bits == 8:
        m = tree_map(q8_shape, param_shapes)
    else:
        m = tree_map(lambda p: ShapeDtype(tuple(p.shape), torch.float32),
                     param_shapes)
    v = tree_map(lambda x: x, m)
    return AdamWState(step=ShapeDtype((), torch.int32), m=m, v=v)
