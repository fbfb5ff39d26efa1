"""Blockwise (flash-style) attention in plain PyTorch + decode-step attention.

The counterpart of :mod:`repro.models.attention`. Never materializes the
full (Sq, Skv) score matrix: a loop over KV blocks carries an online
softmax. Supports GQA (q heads grouped over kv heads), causal,
causal+sliding-window, and full (cross) attention.

The products keep the reference's types: scores and ``p @ v`` are float32
sums of the inputs' products (:func:`.layers.matmul_f32`, the reference's
``preferred_element_type=jnp.float32``), the probabilities are rounded to
the input's type before ``p @ v``, and the output is cast to the input's
type last. No fused attention operator stands in for this loop: it would
sum in another order.

Head shuffling (``head_perm``): an optional BMMC permutation of the kv-head
axis, applied consistently to k/v, to q at kv-head granularity (each kv
head drags its GQA group along), and inverted on the output heads (in
float32, before the cast) — so the result is bit-identical to the
unshuffled call while the layout travelling through the products is
permuted. On the ``"cuda"`` engine each of the four shuffles is one
tiled-permutation kernel launch (K4a) for a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.bmmc import Bmmc
from .layers import matmul_f32
from .permute import permute_axis

NEG_INF = -1e30


def default_head_perm(n_kv_heads: int) -> Optional[Bmmc]:
    """The canonical head shuffle: bit-reversal of the kv-head index.

    Returns None when there is nothing to shuffle (fewer than 2 kv heads
    or a non-power-of-two head count).
    """
    if n_kv_heads < 2 or n_kv_heads & (n_kv_heads - 1):
        return None
    return Bmmc.bit_reverse(n_kv_heads.bit_length() - 1)


def _block_bias(q_pos, k_pos, kind: str, window: Optional[int]):
    if kind == "full":
        return None
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def attention(q, k, v, *, kind: str = "causal", window: Optional[int] = None,
              q_offset: int = 0, kv_block: int = 1024,
              softmax_scale: Optional[float] = None,
              head_perm: Optional[Bmmc] = None, head_perm_engine="ref"):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H = G * KV.

    Returns (B, Sq, H, D). ``q_offset`` shifts query positions (prefill
    continuation). Loops over KV blocks with an online-softmax carry.
    ``head_perm`` (a BMMC on log2(KV) bits) shuffles the kv-head layout
    through the products and un-shuffles the output — semantically
    neutral.
    """
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    if g * kvh != h:
        raise ValueError(f"{h} q heads do not group over {kvh} kv heads")
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(d)

    kv_block = min(kv_block, skv)
    while skv % kv_block:  # largest divisor of skv <= requested block
        kv_block -= 1
    nkv = skv // kv_block

    if head_perm is not None:
        if head_perm.size != kvh:
            raise ValueError(f"head_perm on 2^{head_perm.n} heads, "
                             f"{kvh} kv heads")
        k = permute_axis(k, head_perm, axis=2, engine=head_perm_engine)
        v = permute_axis(v, head_perm, axis=2, engine=head_perm_engine)

    qg = q.reshape(b, sq, kvh, g, d)
    if head_perm is not None:
        qg = permute_axis(qg, head_perm, axis=2, engine=head_perm_engine)
    # (b, kvh, g*sq, d): one product per (batch, kv head) for the group
    qm = qg.permute(0, 2, 3, 1, 4).reshape(b, kvh, g * sq, d)

    q_pos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    for bi in range(nkv):
        kblk = k[:, bi * kv_block:(bi + 1) * kv_block].permute(0, 2, 3, 1)
        vblk = v[:, bi * kv_block:(bi + 1) * kv_block].permute(0, 2, 1, 3)
        k_pos = bi * kv_block + torch.arange(kv_block, device=q.device)
        s = matmul_f32(qm, kblk).reshape(b, kvh, g, sq, kv_block) * scale
        bias = _block_bias(q_pos, k_pos, kind, window)
        if bias is not None:
            s = s + bias  # (Sq, kvb) broadcast over (b, kv, g)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = matmul_f32(p.to(q.dtype).reshape(b, kvh, g * sq, kv_block),
                        vblk).reshape(b, kvh, g, sq, d)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)  # (b, sq, kvh, g, d)
    if head_perm is not None:
        out = permute_axis(out, head_perm.inverse(), axis=2,
                           engine=head_perm_engine)
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length, *,
                     window: Optional[int] = None,
                     softmax_scale: Optional[float] = None,
                     head_perm: Optional[Bmmc] = None, head_perm_engine="ref"):
    """Single-token attention over a KV cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, KV, D); ``length``: number of
    valid cache entries (the new token's k/v must already be inserted).
    ``head_perm`` shuffles the kv-head layout exactly as in :func:`attention`.
    """
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(d)
    if head_perm is not None:
        if head_perm.size != kvh:
            raise ValueError(f"head_perm on 2^{head_perm.n} heads, "
                             f"{kvh} kv heads")
        k_cache = permute_axis(k_cache, head_perm, axis=2,
                               engine=head_perm_engine)
        v_cache = permute_axis(v_cache, head_perm, axis=2,
                               engine=head_perm_engine)
    qg = q.reshape(b, kvh, g, d)
    if head_perm is not None:
        qg = permute_axis(qg, head_perm, axis=1, engine=head_perm_engine)
    sc = matmul_f32(qg, k_cache.permute(0, 2, 3, 1)) * scale  # (b,kv,g,s)
    pos = torch.arange(s, device=q.device)
    ok = pos[None, :] < length
    if window is not None:
        ok &= pos[None, :] > (length - 1 - window)
    sc = torch.where(ok[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    out = matmul_f32(p, v_cache.permute(0, 2, 1, 3))  # (b, kv, g, d)
    if head_perm is not None:
        out = permute_axis(out, head_perm.inverse(), axis=1,
                           engine=head_perm_engine)
    return out.reshape(b, 1, h, d).to(q.dtype)
