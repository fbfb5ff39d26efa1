"""State-space blocks: Mamba-2 SSD (state-space duality) and RG-LRU.

The counterpart of :mod:`repro.models.ssm`, in plain PyTorch as the
reference is plain JAX: the recurrences are not permutations, so no
kernel of this port applies.

Mamba-2 (arXiv:2405.21060): chunked SSD — an intra-chunk quadratic,
attention-like term plus an inter-chunk linear recurrence over chunk
states (a loop over chunks where the reference runs ``lax.scan``). The
products the reference asks in float32 (``preferred_element_type``) widen
their operands first, as :func:`.layers.matmul_f32` does: a product of
two or three bfloat16 values is exact in float32.

RG-LRU (RecurrentGemma, arXiv:2402.19427): a gated linear recurrence
computed with JAX's ``lax.associative_scan`` recursion (odd/even
reduction, log2 L levels), so the products associate as the reference's
do; a loop of :func:`rglru_step` gives the same values in another order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def _segsum(a):
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} a[..., k]."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt_a, b, c, *, chunk: int = 256,
                return_final_state: bool = False):
    """Chunked state-space duality forward pass.

    x: (B, L, H, P) head inputs (already dt-weighted by the caller)
    dt_a: (B, L, H) per-step log decay (A * dt, <= 0), float32
    b, c: (B, L, G, N) input/output projections (G groups, heads share)
    Returns y: (B, L, H, P) [and the final SSM state (B, H, P, N), float32,
    if asked — the decode-continuation carry].
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    dt = x.dtype
    chunk = min(chunk, l)
    pad = (-l) % chunk
    if pad:
        # no-op padding: x/b/c = 0 contribute nothing to states, and
        # dt_a = 0 => decay exp(0) = 1 passes state through unchanged.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_a = F.pad(dt_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc = lp // chunk

    # heads split as (G, H/G): head j of group gi is head gi * hg + j
    xc = x.reshape(bsz, nc, chunk, g, hg, p).float()
    ac = dt_a.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, g, n).float()
    cc = c.reshape(bsz, nc, chunk, g, n).float()

    # intra-chunk ("diagonal") term: attention-like with decay kernel L
    lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))        # (B,nc,H,q,q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)        # (B,nc,G,q,k)
    w = (scores[:, :, :, None] * lmat.reshape(bsz, nc, g, hg, chunk, chunk))
    w = w.to(dt).float()                                       # (B,nc,G,hg,q,k)
    y_diag = torch.einsum("bcgjqk,bckgjp->bcqgjp", w, xc)

    # chunk-final states: S_c = sum_j exp(cum_last - cum_j) B_j (x) x_j
    cum = torch.cumsum(ac, dim=2)                              # (B,nc,q,H)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,q,H)
    dx = decay_states.to(dt).float().reshape(
        bsz, nc, chunk, g, hg)[..., None] * xc                 # exact
    states = torch.einsum("bcqgn,bcqgjp->bcgjpn", bc, dx).reshape(
        bsz, nc, h, p, n)

    # inter-chunk recurrence over chunk states (the reference's lax.scan)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    s_prevs = torch.stack(s_prevs, dim=1)                      # (B,nc,H,P,N)

    # off-diagonal contribution: y_i += C_i . (decay_i * S_prev)
    state_decay = torch.exp(cum).to(dt).float()                # (B,nc,q,H)
    sp = s_prevs.to(dt).float().reshape(bsz, nc, g, hg, p, n)
    y_off = torch.einsum("bcqgn,bcgjpn->bcqgjp", cc, sp) * state_decay.reshape(
        bsz, nc, chunk, g, hg)[..., None]
    y = (y_diag + y_off).reshape(bsz, lp, h, p)[:, :l]
    if return_final_state:
        return y.to(dt), s
    return y.to(dt)


def ssd_decode_step(state, x_t, dt_a_t, b_t, c_t):
    """One-token SSD update. state: (B,H,P,N) float32.

    x_t: (B,H,P); dt_a_t: (B,H); b_t, c_t: (B,G,N).
    Returns (new_state, y_t (B,H,P)).
    """
    bsz, h, p, n = state.shape
    g = b_t.shape[1]
    hg = h // g
    bh = b_t.repeat_interleave(hg, dim=1) if g != h else b_t   # (B,H,N)
    ch = c_t.repeat_interleave(hg, dim=1) if g != h else c_t
    dec = torch.exp(dt_a_t)[..., None, None]                   # (B,H,1,1)
    # the outer product in the inputs' type, as the reference's einsum
    new_state = state * dec + (x_t[..., :, None] * bh[..., None, :]).float()
    y = (new_state.to(x_t.dtype) @ ch[..., None])[..., 0]
    return new_state, y


def causal_conv1d(x, w, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, L, C); w: (K, C); prev: (B, K-1, C).

    Returns (out (B, L, C), the last K-1 inputs (the decode carry))."""
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    out = xp[:, 0:x.shape[1], :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    new_prev = xp[:, -(k - 1):, :] if k > 1 else prev
    return out, new_prev


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def _gates(x, gate_a, gate_x, a_param):
    """(a, sqrt(1 - a^2) * sigmoid(gate_x) * x), float32."""
    log_a = -_RGLRU_C * softplus(a_param.float()) * torch.sigmoid(
        gate_a.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(gate_x.float()) * x.float()
    floor = torch.tensor(1e-12, dtype=torch.float32, device=a.device)
    return a, torch.sqrt(torch.maximum(1.0 - a * a, floor)) * gated


def _interleave(a, b, axis: int):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (a may be one longer)."""
    n = b.shape[axis]
    ab = torch.stack([a.narrow(axis, 0, n), b], dim=axis + 1).flatten(
        axis, axis + 1)
    if a.shape[axis] > n:
        ab = torch.cat([ab, a.narrow(axis, n, 1)], dim=axis)
    return ab


def _every_other(x, start: int, stop: Optional[int], axis: int):
    """``x[start:stop:2]`` along ``axis``."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, 2)
    return x[tuple(idx)]


def _linear_scan(a, b, axis: int):
    """Prefix combination of ``h_t = a_t * h_{t-1} + b_t`` along ``axis``:
    JAX's ``associative_scan`` recursion with ``comb(l, r) = (al * ar,
    bl * ar + br)``, level by level."""
    def comb(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    def scan(elems):
        num = elems[0].shape[axis]
        if num < 2:
            return elems
        reduced = comb([_every_other(e, 0, -1, axis) for e in elems],
                       [_every_other(e, 1, None, axis) for e in elems])
        odd = scan(reduced)
        rest = [_every_other(e, 2, None, axis) for e in elems]
        if num % 2 == 0:
            even = comb([o.narrow(axis, 0, o.shape[axis] - 1) for o in odd],
                        rest)
        else:
            even = comb(odd, rest)
        even = [torch.cat([e.narrow(axis, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return scan([a, b])[1]


def rglru(x, gate_a, gate_x, a_param, h0: Optional[torch.Tensor] = None):
    """Real-gated LRU scan. x, gate_a, gate_x: (B, L, D); a_param: (D,).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    with a_t = exp(-c * softplus(a_param) * sigmoid(gate_a)).
    ``h0`` carries decode state. Returns (h in x's type, h_L float32).
    """
    a, b = _gates(x, gate_a, gate_x, a_param)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = _linear_scan(a, b, axis=1)
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(state, x_t, gate_a_t, gate_x_t, a_param):
    """One-token RG-LRU update. state: (B, D) float32."""
    a, b = _gates(x_t, gate_a_t, gate_x_t, a_param)
    h = a * state + b
    return h, h.to(x_t.dtype)
