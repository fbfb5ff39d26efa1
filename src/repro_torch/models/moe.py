"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

The counterpart of :mod:`repro.models.moe` (its group-local dispatch:
one group with no mesh, ``dp_size(mesh)`` groups with one). Tokens
arrive as ``(groups, T_local, d_model)``; routing, sorting and the capacity
scatter run per group along a leading group axis where the reference
``vmap``s them. Plain PyTorch: the data-dependent relayout is a stable
sort, not a BMMC, so no kernel of this port applies.

Ties and orders follow the reference's ``jnp.argsort`` (stable) and
``lax.top_k`` (the lower expert index first on a tie): both are stable
sorts here.

Every sum over a token's routed copies is deterministic on the card:
the reference adds them with ``.at[tok_sorted].add`` (XLA's scatter adds
the updates in order), where ``index_add_`` / ``scatter_add_`` would add
with atomics in a different order on each run. Here each token gathers
its ``top_k`` copies by their sorted positions and adds them in ascending
sorted position (ascending expert id), from zero, in the tensor's type:
the combine does so, and so does the backward of the dispatch's gather
(:class:`_TakeTokens`). Every other scatter or gather on the path writes
each element once.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _softmax(x):
    """``jax.nn.softmax``: ``exp(x - max) / sum``, divided (not scaled by a
    reciprocal)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def router_topk(logits, k: int):
    """logits: (..., T, X). Returns (weights (..., T, k) float32, ids
    (..., T, k) int64, aux_loss)."""
    probs = _softmax(logits.float())
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :k], ids[..., :k]
    weights = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss: X * mean_x(frac_tokens_x * mean_prob_x)
    x = logits.shape[-1]
    frac = _expert_counts(ids, x)
    frac = frac / torch.clamp_min(frac.sum(-1, keepdim=True), 1.0)
    aux = x * torch.sum(frac * probs.mean(-2), dim=-1)
    return weights.float(), ids, aux


def _expert_counts(ids, x: int):
    """Float32 count of each expert id over the last two axes of ``ids``
    (the reference's ``zeros(x).at[ids].add(1.0)``: whole numbers, exact
    in any order)."""
    lead = ids.shape[:-2]
    flat = ids.reshape(-1, ids.shape[-2] * ids.shape[-1])
    off = torch.arange(flat.shape[0], device=ids.device)[:, None] * x
    idx = (flat + off).reshape(-1)
    # a fixed-size count (bincount's output length depends on the data,
    # which a trace on fake tensors cannot follow)
    counts = torch.zeros(flat.shape[0] * x, dtype=torch.int64,
                         device=ids.device).scatter_add_(
                             0, idx, torch.ones_like(idx))
    return counts.reshape(lead + (x,)).float()


def _rows(src, idx):
    """``src[g, idx[g, i]]``: src (G, R, E), idx (G, N) -> (G, N, E)."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def _token_sum(rows, pos):
    """Each token's rows added in order: rows (G, R, E), pos (G, T, k)
    ascending row indices -> (G, T, E), ``((0 + r_0) + r_1) + ...``."""
    out = torch.zeros(pos.shape[:2] + rows.shape[-1:], dtype=rows.dtype,
                      device=rows.device)
    for j in range(pos.shape[-1]):
        out = out + _rows(rows, pos[..., j])
    return out


class _TakeTokens(torch.autograd.Function):
    """``x[g, tok_sorted[g, p]]`` for each sorted position ``p``; the
    backward adds each token's copies in ascending sorted position
    (:func:`_token_sum`), not with atomics."""

    @staticmethod
    def forward(ctx, x, tok_sorted, pos):
        ctx.save_for_backward(pos)
        return _rows(x, tok_sorted)

    @staticmethod
    def backward(ctx, grad):
        pos, = ctx.saved_tensors
        return _token_sum(grad, pos), None, None


def _dispatch_group(x, router_w, *, top_k: int, cap: int, xn: int):
    """Routing + capacity pack of each group. x: (G, T_local, E).

    Returns (buf (G, X*C, E), slot, pos, w_sorted, aux (G,)): ``slot``
    (G, T*k) the buffer row of each sorted position (``X*C``: dropped),
    ``pos`` (G, T, k) each token's sorted positions, ascending.
    """
    g, t, e = x.shape
    logits = x.float() @ router_w.float()
    weights, ids, aux = router_topk(logits, top_k)

    flat_ids = ids.reshape(g, -1)                        # (G, T*k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    eid_sorted = torch.gather(flat_ids, 1, order)
    tok_sorted = order // top_k                          # token per slot
    w_sorted = torch.gather(weights.reshape(g, -1), 1, order)
    # each token's sorted positions: the inverse of ``order``, ascending
    inv = torch.argsort(order, dim=-1)
    pos = torch.sort(inv.reshape(g, t, top_k), dim=-1).values

    experts = torch.arange(xn, device=x.device).expand(g, xn).contiguous()
    starts = torch.searchsorted(eid_sorted.contiguous(), experts,
                                side="left")
    rank = (torch.arange(t * top_k, device=x.device)
            - torch.gather(starts, 1, eid_sorted))
    keep = rank < cap
    slot = torch.where(keep, eid_sorted * cap + rank, xn * cap)

    rows = _TakeTokens.apply(x, tok_sorted, pos)
    buf = torch.zeros((g, xn * cap + 1, e), dtype=x.dtype, device=x.device)
    # slots are unique but for the drop row, which is cut off
    buf = buf.scatter(1, slot[..., None].expand(-1, -1, e), rows)[:, :-1]
    return buf, slot, pos, w_sorted, aux


def _combine_group(yexp, slot, pos, w_sorted):
    """Un-permute + weighted sum of each group. yexp: (G, X*C, E)."""
    # a zero row for the dropped positions (the reference's keep mask)
    padded = F.pad(yexp, (0, 0, 0, 1))
    y_sorted = _rows(padded, slot)
    y_sorted = y_sorted * w_sorted[..., None].to(yexp.dtype)
    return _token_sum(y_sorted, pos)


def moe_capacity(t: int, xn: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert and group: the reference's formula."""
    cap = int(np.ceil(top_k * t * capacity_factor / xn))
    cap = max(8, int(np.ceil(cap / 8)) * 8)
    return min(cap, t * top_k)


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25,
            constrain_buf: Optional[Callable] = None):
    """x: (G, T_local, E) grouped tokens. Expert weights: (X, E, F) etc.

    Returns (out (G, T_local, E), aux_loss). Tokens beyond per-group expert
    capacity are dropped (standard capacity-based MoE semantics).
    ``constrain_buf`` is applied to the (G, X, C, E) buffers where the
    reference constrains their layout (the port's constrainers return
    the buffer unchanged: :mod:`repro_torch.parallel.sharding`).
    """
    g, t, e = x.shape
    xn = router_w.shape[1]
    cap = moe_capacity(t, xn, top_k, capacity_factor)

    buf, slot, pos, w_sorted, aux = _dispatch_group(
        x, router_w, top_k=top_k, cap=cap, xn=xn)
    buf = buf.reshape(g, xn, cap, e)
    if constrain_buf is not None:
        buf = constrain_buf(buf)

    gate = buf @ w_gate                                   # (G, X, C, F)
    up = buf @ w_up
    h = F.silu(gate.float()).to(x.dtype) * up
    yexp = h @ w_down                                     # (G, X, C, E)
    if constrain_buf is not None:
        yexp = constrain_buf(yexp)
    yexp = yexp.reshape(g, xn * cap, e)

    out = _combine_group(yexp, slot, pos, w_sorted)
    return out, aux.mean()
