"""Block definitions + the layer-stack executor for all arch families.

The counterpart of :mod:`repro.models.transformer`. Block kinds:

  dense  — self-attn (GQA, RoPE) + MLP
  local  — sliding-window self-attn + MLP
  moe    — self-attn + mixture-of-experts FFN (+ optional shared experts)
  cross  — gated cross-attention to stub patch/frame embeddings + MLP (VLM)
  enc    — bidirectional self-attn + MLP (encoder)
  dec    — causal self-attn + cross-attn + MLP (enc-dec decoder)
  rec    — RG-LRU recurrent block + MLP (RecurrentGemma)
  mamba  — Mamba-2 SSD block

Every self-attention (``dense``, ``local``, ``moe``, ``enc``, ``dec``)
runs the kv-head shuffle when ``cfg.head_shuffle`` is set; cross-attention
runs none, as in the reference.

The stack is ``prefix + pattern * n_periods + tail``; the repeated
pattern keeps its parameters (and caches) stacked on a leading layer
axis, as the reference's ``lax.scan`` does, and runs as a Python loop over
that axis. Each stacked leaf is unbound into its layers once per call, so
a backward stacks each leaf's gradient once (a ``select`` per layer would
allocate a zero gradient of the whole stack for every layer). Decode
writes every cache it advances (k/v at the new position, the conv tails,
the SSD state, the RG-LRU state) into the given caches in place.

``cfg.remat`` checkpoints each period's body while a gradient is being
recorded (``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` around its scan body: policy ``nothing`` keeps only the
body's inputs and recomputes the rest in the backward; policy ``dots``
(JAX's ``dots_with_no_batch_dims_saveable``) also keeps the outputs of the
products without batch dims (``aten.mm`` / ``addmm``: the projections, the
MLP and the router) and recomputes the batched ones (attention's scores
and values, the experts' products).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..configs.base import ArchConfig
from ..obs import metrics as _ometrics
from .attention import attention, decode_attention, default_head_perm
from .layers import (ParamDef, apply_rope, layer_norm, rms_norm, stack_defs)
from .moe import moe_ffn
from .moe_a2a import moe_ffn_a2a
from .ssm import (causal_conv1d, rglru, rglru_step, softplus, ssd_chunked,
                  ssd_decode_step)


# ---------------------------------------------------------------------------
# Parameter definitions per block kind
# ---------------------------------------------------------------------------


def _norm_defs(cfg, name):
    if cfg.norm == "ln":
        return {f"{name}_scale": ParamDef((cfg.d_model,), ("embed",), cfg.dtype, "ones"),
                f"{name}_bias": ParamDef((cfg.d_model,), ("embed",), cfg.dtype, "zeros")}
    return {f"{name}_scale": ParamDef((cfg.d_model,), ("embed",), cfg.dtype, "zeros")}


def _apply_norm(cfg, p, name, x):
    if cfg.norm == "ln":
        return layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"])
    return rms_norm(x, p[f"{name}_scale"])


def _attn_defs(cfg: ArchConfig, prefix: str = "") -> Dict[str, ParamDef]:
    e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    defs = {
        f"{prefix}wq": ParamDef((e, h, d), ("embed", "heads", "head_dim"), dt),
        f"{prefix}wk": ParamDef((e, kv, d), ("embed", "kv_heads", "head_dim"), dt),
        f"{prefix}wv": ParamDef((e, kv, d), ("embed", "kv_heads", "head_dim"), dt),
        f"{prefix}wo": ParamDef((h, d, e), ("heads", "head_dim", "embed"), dt, "small"),
    }
    if cfg.qkv_bias:
        defs[f"{prefix}bq"] = ParamDef((h, d), ("heads", "head_dim"), dt, "zeros")
        defs[f"{prefix}bk"] = ParamDef((kv, d), ("kv_heads", "head_dim"), dt, "zeros")
        defs[f"{prefix}bv"] = ParamDef((kv, d), ("kv_heads", "head_dim"), dt, "zeros")
    return defs


def _mlp_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    e, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    if cfg.mlp == "gelu":
        return {
            "w_up": ParamDef((e, f), ("embed", "mlp"), dt),
            "b_up": ParamDef((f,), ("mlp",), dt, "zeros"),
            "w_down": ParamDef((f, e), ("mlp", "embed"), dt, "small"),
            "b_down": ParamDef((e,), ("embed",), dt, "zeros"),
        }
    return {
        "w_gate": ParamDef((e, f), ("embed", "mlp"), dt),
        "w_up": ParamDef((e, f), ("embed", "mlp"), dt),
        "w_down": ParamDef((f, e), ("mlp", "embed"), dt, "small"),
    }


def _moe_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    e, f, x, dt = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.dtype
    defs = {
        "router": ParamDef((e, x), ("embed", None), torch.float32, "normal",
                           0.006),
        "we_gate": ParamDef((x, e, f), ("experts", "embed", None), dt),
        "we_up": ParamDef((x, e, f), ("experts", "embed", None), dt),
        "we_down": ParamDef((x, f, e), ("experts", None, "embed"), dt, "small"),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs.update({
            "ws_gate": ParamDef((e, fs), ("embed", "mlp"), dt),
            "ws_up": ParamDef((e, fs), ("embed", "mlp"), dt),
            "ws_down": ParamDef((fs, e), ("mlp", "embed"), dt, "small"),
        })
    return defs


def _mamba_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    e, dt = cfg.d_model, cfg.dtype
    di = cfg.ssm_expand * e
    n = cfg.ssm_state
    nh = di // cfg.ssm_headdim
    k = cfg.ssm_conv
    conv_ch = di + 2 * n
    f32 = torch.float32
    return {
        "w_z": ParamDef((e, di), ("embed", "mlp"), dt),
        "w_x": ParamDef((e, di), ("embed", "mlp"), dt),
        "w_b": ParamDef((e, n), ("embed", "state"), dt),
        "w_c": ParamDef((e, n), ("embed", "state"), dt),
        "w_dt": ParamDef((e, nh), ("embed", None), dt),
        "dt_bias": ParamDef((nh,), (None,), f32, "zeros"),
        "a_log": ParamDef((nh,), (None,), f32, "ones"),
        "d_skip": ParamDef((nh,), (None,), f32, "ones"),
        "conv_w": ParamDef((k, conv_ch), (None, "mlp"), dt, "normal", 0.1),
        "norm_y": ParamDef((di,), ("mlp",), dt, "zeros"),
        "w_out": ParamDef((di, e), ("mlp", "embed"), dt, "small"),
    }


def _rec_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    e, dt = cfg.d_model, cfg.dtype
    w = cfg.lru_width or e
    k = cfg.ssm_conv
    return {
        "w_xb": ParamDef((e, w), ("embed", "mlp"), dt),
        "w_gateb": ParamDef((e, w), ("embed", "mlp"), dt),
        "conv_w": ParamDef((k, w), (None, "mlp"), dt, "normal", 0.1),
        "w_gate_a": ParamDef((w, w), ("mlp", None), dt, "small"),
        "w_gate_x": ParamDef((w, w), ("mlp", None), dt, "small"),
        "a_param": ParamDef((w,), ("mlp",), torch.float32, "ones"),
        "w_out": ParamDef((w, e), ("mlp", "embed"), dt, "small"),
    }


def block_defs(cfg: ArchConfig, kind: str) -> Dict[str, ParamDef]:
    d: Dict[str, ParamDef] = {}
    if kind in ("dense", "local", "moe", "enc", "dec"):
        d.update(_norm_defs(cfg, "ln_attn"))
        d.update(_attn_defs(cfg))
    if kind == "dec":
        d.update(_norm_defs(cfg, "ln_cross"))
        d.update(_attn_defs(cfg, prefix="c_"))
    if kind == "cross":
        d.update(_norm_defs(cfg, "ln_attn"))
        d.update(_attn_defs(cfg))
        d["attn_gate"] = ParamDef((1,), (None,), torch.float32, "zeros")
        d["mlp_gate"] = ParamDef((1,), (None,), torch.float32, "zeros")
    if kind in ("dense", "local", "cross", "enc", "dec"):
        d.update(_norm_defs(cfg, "ln_mlp"))
        d.update(_mlp_defs(cfg))
    if kind == "moe":
        d.update(_norm_defs(cfg, "ln_mlp"))
        d.update(_moe_defs(cfg))
    if kind == "mamba":
        d.update(_norm_defs(cfg, "ln_attn"))
        d.update(_mamba_defs(cfg))
    if kind == "rec":
        d.update(_norm_defs(cfg, "ln_attn"))
        d.update(_rec_defs(cfg))
        d.update(_norm_defs(cfg, "ln_mlp"))
        d.update(_mlp_defs(cfg))
    return d


# ---------------------------------------------------------------------------
# Cache definitions (decode/prefill state per block)
# ---------------------------------------------------------------------------

def cache_defs(cfg: ArchConfig, kind: str, batch: int, cache_len: int) -> Dict:
    kv, dd, dt = cfg.n_kv_heads, cfg.hd, cfg.dtype
    kvax = ("batch", "seq_kv", "kv_heads", None)
    if kind == "enc":
        return {}
    if kind in ("dense", "local", "moe"):
        return {"k": ParamDef((batch, cache_len, kv, dd), kvax, dt, "zeros"),
                "v": ParamDef((batch, cache_len, kv, dd), kvax, dt, "zeros")}
    if kind == "dec":
        src = max(cfg.src_len, 1)
        return {"k": ParamDef((batch, cache_len, kv, dd), kvax, dt, "zeros"),
                "v": ParamDef((batch, cache_len, kv, dd), kvax, dt, "zeros"),
                "ck": ParamDef((batch, src, kv, dd), kvax, dt, "zeros"),
                "cv": ParamDef((batch, src, kv, dd), kvax, dt, "zeros")}
    if kind == "cross":
        src = max(cfg.src_len, 1)
        return {"ck": ParamDef((batch, src, kv, dd), kvax, dt, "zeros"),
                "cv": ParamDef((batch, src, kv, dd), kvax, dt, "zeros")}
    if kind == "mamba":
        di = cfg.ssm_expand * cfg.d_model
        nh = di // cfg.ssm_headdim
        conv_ch = di + 2 * cfg.ssm_state
        return {"conv": ParamDef((batch, cfg.ssm_conv - 1, conv_ch),
                                 ("batch", None, "mlp"), dt, "zeros"),
                "state": ParamDef((batch, nh, cfg.ssm_headdim, cfg.ssm_state),
                                  ("batch", None, None, "state"),
                                  torch.float32, "zeros")}
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return {"conv": ParamDef((batch, cfg.ssm_conv - 1, w),
                                 ("batch", None, "mlp"), dt, "zeros"),
                "h": ParamDef((batch, w), ("batch", "mlp"), torch.float32,
                              "zeros")}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _proj(x, w):
    """``einsum("bse,e...->bs...", x, w)``: one product over the flattened
    trailing axes of ``w``, in the input's type."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_qkv(cfg, p, x, prefix=""):
    q = _proj(x, p[f"{prefix}wq"])
    k = _proj(x, p[f"{prefix}wk"])
    v = _proj(x, p[f"{prefix}wv"])
    if cfg.qkv_bias:
        q = q + p[f"{prefix}bq"]
        k = k + p[f"{prefix}bk"]
        v = v + p[f"{prefix}bv"]
    return q, k, v


def _self_attn(cfg, p, x, ctx, *, window=None, kind_attn="causal", cache=None):
    """Returns (attn_out, new_cache_kv).

    Decode writes the new token's k/v into ``cache`` in place (the
    reference's jitted step gets the same effect by donating the cache)."""
    mode = ctx["mode"]
    q, k, v = _project_qkv(cfg, p, x)
    rd = int(cfg.hd * cfg.rotary_frac) if cfg.rotary_frac < 1.0 else None
    if kind_attn != "full":  # positional only for causal self-attn
        pos = ctx["pos"] + torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta, rd)
        k = apply_rope(k, pos, cfg.rope_theta, rd)
    hp = default_head_perm(cfg.n_kv_heads) if cfg.head_shuffle else None
    if cfg.head_shuffle and hp is None:
        raise ValueError(
            f"head_shuffle={cfg.head_shuffle!r} needs a power-of-two "
            f"kv-head count >= 2, got n_kv_heads={cfg.n_kv_heads}")
    hp_kw = ({"head_perm": hp, "head_perm_engine": cfg.head_shuffle}
             if hp is not None else {})
    if mode == "decode":
        at = ctx["pos"]
        kc, vc = cache["k"], cache["v"]
        kc[:, at:at + k.shape[1]] = k
        vc[:, at:at + v.shape[1]] = v
        # the shuffle is output-neutral, so decode skips it: re-permuting
        # the whole KV cache every token would be O(S^2) over a decode
        out = decode_attention(q, kc, vc, at + 1, window=window)
        new_cache = {"k": kc, "v": vc}
    else:
        out = attention(q, k, v, kind=kind_attn, window=window,
                        kv_block=cfg.kv_block, **hp_kw)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    wo = p["wo"]
    y = out.flatten(2) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache


def _mlp(cfg, p, x):
    if cfg.mlp == "gelu":
        h = x @ p["w_up"] + p["b_up"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ p["w_down"] + p["b_down"]
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    gf = g.float()
    act = (F.gelu(gf, approximate="tanh") if cfg.mlp == "geglu"
           else F.silu(gf))
    h = act.to(x.dtype) * u
    return h @ p["w_down"]


def _cross_attn(cfg, p, x, ctx, prefix="", cache=None):
    """Cross-attention to ``ctx["enc"]`` (prefill, train) or to the
    ``ck``/``cv`` caches prefill made (decode); no RoPE, no shuffle."""
    mode = ctx["mode"]
    q = _proj(x, p[f"{prefix}wq"])
    if cfg.qkv_bias:
        q = q + p[f"{prefix}bq"]
    if mode == "decode":
        k, v = cache["ck"], cache["cv"]
        new_cache = {"ck": k, "cv": v}
    else:
        enc = ctx["enc"]
        k = _proj(enc, p[f"{prefix}wk"])
        v = _proj(enc, p[f"{prefix}wv"])
        if cfg.qkv_bias:
            k = k + p[f"{prefix}bk"]
            v = v + p[f"{prefix}bv"]
        new_cache = {"ck": k, "cv": v} if mode == "prefill" else None
    out = attention(q, k, v, kind="full", kv_block=cfg.kv_block)
    wo = p[f"{prefix}wo"]
    y = out.flatten(2) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache


def _moe_block_ffn(cfg, p, x, ctx):
    """The routed experts plus the shared ones. ``moe_impl="a2a"`` with a
    mesh whose model axis divides the sequence and the experts runs the
    all-to-all dispatch (:func:`.moe_a2a.moe_ffn_a2a`); otherwise
    ``moe_ffn`` routes ``dp_groups`` groups (one for ``"naive"`` or a
    ragged ``b*s``), as the reference."""
    b, s, e = x.shape
    mesh = ctx.get("mesh")
    if (cfg.moe_impl == "a2a" and mesh is not None
            and s % mesh.shape["model"] == 0
            and cfg.n_experts % mesh.shape["model"] == 0):
        _ometrics.inc("model.moe_a2a")
        out, aux = moe_ffn_a2a(x, p["router"], p["we_gate"], p["we_up"],
                               p["we_down"], top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor, mesh=mesh)
    else:
        # "naive" = historical baseline: one global group
        groups = 1 if cfg.moe_impl == "naive" else ctx.get("dp_groups", 1)
        if (b * s) % max(groups, 1):
            groups = 1
        grouped = x.reshape(groups, (b * s) // groups, e)
        out, aux = moe_ffn(grouped, p["router"], p["we_gate"], p["we_up"],
                           p["we_down"], top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           constrain_buf=ctx.get("constrain_moe"))
        out = out.reshape(b, s, e)
    if cfg.n_shared_experts:
        g = x @ p["ws_gate"]
        u = x @ p["ws_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        out = out + h @ p["ws_down"]
    return out, aux


def _advance(cache, new):
    """Decode: write each advanced state into the layer's cache (a view of
    the stacked caches) and return the cache."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def _mamba_block(cfg, p, x, ctx, cache=None):
    b, s, e = x.shape
    di = cfg.ssm_expand * e
    n = cfg.ssm_state
    nh = di // cfg.ssm_headdim
    pdim = cfg.ssm_headdim
    z = x @ p["w_z"]
    xi = x @ p["w_x"]
    bb = x @ p["w_b"]
    cc = x @ p["w_c"]
    dt = x @ p["w_dt"]

    conv_in = torch.cat([xi, bb, cc], dim=-1)
    prev = cache["conv"] if ctx["mode"] == "decode" else None
    conv_out, conv_state = causal_conv1d(conv_in, p["conv_w"], prev)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xi, bb, cc = (conv_out[..., :di], conv_out[..., di:di + n],
                  conv_out[..., di + n:])

    dt = softplus(dt.float() + p["dt_bias"])                       # (b,s,nh)
    a = -torch.exp(p["a_log"])                                     # (nh,)
    dt_a = dt * a                                                  # (b,s,nh)
    xh = xi.reshape(b, s, nh, pdim) * dt[..., None].to(x.dtype)
    bg = bb[:, :, None, :]                                         # (b,s,1,n)
    cg = cc[:, :, None, :]

    if ctx["mode"] == "decode":
        new_state, y = ssd_decode_step(cache["state"], xh[:, 0],
                                       dt_a[:, 0].float(), bg[:, 0], cg[:, 0])
        y = y[:, None]                                             # (b,1,nh,p)
        new_cache = _advance(cache, {"conv": conv_state, "state": new_state})
    elif ctx["mode"] == "prefill":
        y, state = ssd_chunked(xh, dt_a, bg, cg, chunk=cfg.ssm_chunk,
                               return_final_state=True)
        new_cache = {"conv": conv_state, "state": state}
    else:
        y = ssd_chunked(xh, dt_a, bg, cg, chunk=cfg.ssm_chunk)
        new_cache = None
    y = y + xh * p["d_skip"][:, None].to(x.dtype)
    y = y.reshape(b, -1, di)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_y"])
    return y @ p["w_out"], new_cache


def _rec_block(cfg, p, x, ctx, cache=None):
    xb = x @ p["w_xb"]
    gate_b = x @ p["w_gateb"]
    prev = cache["conv"] if ctx["mode"] == "decode" else None
    xc, conv_state = causal_conv1d(xb, p["conv_w"], prev)
    ga = xc @ p["w_gate_a"]
    gx = xc @ p["w_gate_x"]
    if ctx["mode"] == "decode":
        h_new, y = rglru_step(cache["h"], xc[:, 0], ga[:, 0], gx[:, 0],
                              p["a_param"])
        y = y[:, None]
        new_cache = _advance(cache, {"conv": conv_state, "h": h_new})
    else:
        y, h_last = rglru(xc, ga, gx, p["a_param"])
        new_cache = ({"conv": conv_state, "h": h_last.float()}
                     if ctx["mode"] == "prefill" else None)
    y = y * F.gelu(gate_b.float(), approximate="tanh").to(x.dtype)
    return y @ p["w_out"], new_cache


def block_apply(cfg: ArchConfig, kind: str, p: Dict, x, ctx,
                cache: Optional[Dict] = None) -> Tuple[Any, Optional[Dict], Any]:
    """Returns (x_out, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = ctx["constrain"](x)
    if kind in ("dense", "local", "moe"):
        h = _apply_norm(cfg, p, "ln_attn", x)
        window = cfg.window if kind == "local" else None
        a, kv_cache = _self_attn(cfg, p, h, ctx, window=window, cache=cache)
        x = x + a
        h = _apply_norm(cfg, p, "ln_mlp", x)
        if kind == "moe":
            m, aux = _moe_block_ffn(cfg, p, h, ctx)
        else:
            m = _mlp(cfg, p, h)
        x = x + m
        return x, kv_cache, aux
    if kind == "enc":
        h = _apply_norm(cfg, p, "ln_attn", x)
        a, _ = _self_attn(cfg, p, h, ctx, kind_attn="full")
        x = x + a
        x = x + _mlp(cfg, p, _apply_norm(cfg, p, "ln_mlp", x))
        return x, None, aux
    if kind == "dec":
        h = _apply_norm(cfg, p, "ln_attn", x)
        a, kv_cache = _self_attn(cfg, p, h, ctx, cache=cache)
        x = x + a
        h = _apply_norm(cfg, p, "ln_cross", x)
        ca, c_cache = _cross_attn(cfg, p, h, ctx, prefix="c_", cache=cache)
        x = x + ca
        x = x + _mlp(cfg, p, _apply_norm(cfg, p, "ln_mlp", x))
        new_cache = None
        if kv_cache is not None or c_cache is not None:
            new_cache = {**(kv_cache or {}), **(c_cache or {})}
        return x, new_cache, aux
    if kind == "cross":
        h = _apply_norm(cfg, p, "ln_attn", x)
        ca, c_cache = _cross_attn(cfg, p, h, ctx, cache=cache)
        x = x + torch.tanh(p["attn_gate"]).to(x.dtype) * ca
        m = _mlp(cfg, p, _apply_norm(cfg, p, "ln_mlp", x))
        x = x + torch.tanh(p["mlp_gate"]).to(x.dtype) * m
        return x, c_cache, aux
    if kind == "mamba":
        h = _apply_norm(cfg, p, "ln_attn", x)
        y, new_cache = _mamba_block(cfg, p, h, ctx, cache)
        return x + y, new_cache, aux
    if kind == "rec":
        h = _apply_norm(cfg, p, "ln_attn", x)
        y, new_cache = _rec_block(cfg, p, h, ctx, cache)
        x = x + y
        x = x + _mlp(cfg, p, _apply_norm(cfg, p, "ln_mlp", x))
        return x, new_cache, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack: prefix (unrolled) + pattern x n_periods (stacked) + tail (unrolled)
# ---------------------------------------------------------------------------

def _stack_names(cfg, pattern, n_periods, prefix, tail):
    return (cfg.pattern if pattern is None else pattern,
            cfg.n_periods if n_periods is None else n_periods,
            cfg.prefix if prefix is None else prefix,
            cfg.tail if tail is None else tail)


def stack_defs_tree(cfg: ArchConfig, pattern=None, n_periods=None,
                    prefix=None, tail=None) -> Dict:
    pattern, n_periods, prefix, tail = _stack_names(cfg, pattern, n_periods,
                                                    prefix, tail)
    period = {f"{j}_{k}": block_defs(cfg, k) for j, k in enumerate(pattern)}
    tree = {"prefix": {f"{j}_{k}": block_defs(cfg, k) for j, k in enumerate(prefix)},
            "tail": {f"{j}_{k}": block_defs(cfg, k) for j, k in enumerate(tail)}}
    if n_periods:
        tree["scan"] = stack_defs(period, n_periods, "layers")
    return tree


def stack_cache_defs(cfg: ArchConfig, batch: int, cache_len: int,
                     pattern=None, n_periods=None, prefix=None, tail=None) -> Dict:
    pattern, n_periods, prefix, tail = _stack_names(cfg, pattern, n_periods,
                                                    prefix, tail)
    period = {f"{j}_{k}": cache_defs(cfg, k, batch, cache_len)
              for j, k in enumerate(pattern)}
    tree = {"prefix": {f"{j}_{k}": cache_defs(cfg, k, batch, cache_len)
                       for j, k in enumerate(prefix)},
            "tail": {f"{j}_{k}": cache_defs(cfg, k, batch, cache_len)
                     for j, k in enumerate(tail)}}
    if n_periods:
        tree["scan"] = stack_defs(period, n_periods, "layers")
    return tree


def _layers(tree: Optional[Dict], n: int) -> List[Optional[Dict]]:
    """The ``n`` layers of a stacked tree (views, no copies): each leaf
    unbound once."""
    if tree is None:
        return [None] * n
    per_key = {k: (_layers(v, n) if isinstance(v, dict) else v.unbind(0))
               for k, v in tree.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, body):
    """``body`` checkpointed under ``cfg.remat_policy``."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: "
                         f"'nothing' or 'dots'")
    return functools.partial(_ckpt.checkpoint, body, use_reentrant=False,
                             **kw)


def _stack(trees: list) -> Dict:
    """Stack per-layer trees on a new leading layer axis."""
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in first}


def run_stack(cfg: ArchConfig, params: Dict, x, ctx,
              caches: Optional[Dict] = None,
              pattern=None, n_periods=None, prefix=None, tail=None):
    """Returns (x, new_caches (or None), aux).

    Decode updates the given caches in place and returns them; prefill
    returns fresh caches, the stacked group's stacked on a layer axis."""
    pattern, n_periods, prefix, tail = _stack_names(cfg, pattern, n_periods,
                                                    prefix, tail)
    mode = ctx["mode"]
    want_cache = mode in ("prefill", "decode")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {"prefix": {}, "tail": {}}

    def seq_blocks(x, aux, names, pgroup, cgroup, out_group):
        for name in names:
            kind = name.split("_", 1)[1]
            cache = cgroup.get(name) if cgroup else None
            x, nc, a = block_apply(cfg, kind, pgroup[name], x, ctx, cache)
            if want_cache:
                out_group[name] = nc if nc is not None else {}
            aux = aux + a
        return x, aux

    pre_names = [f"{j}_{k}" for j, k in enumerate(prefix)]
    x, aux = seq_blocks(x, aux, pre_names, params.get("prefix", {}),
                        (caches or {}).get("prefix"), new_caches["prefix"])

    if n_periods:
        period_names = [f"{j}_{k}" for j, k in enumerate(pattern)]
        scan_caches = (caches or {}).get("scan")

        def body(x, aux, pparams, pcaches):
            out = {}
            for name in period_names:
                kind = name.split("_", 1)[1]
                cache = pcaches.get(name) if pcaches is not None else None
                x, nc, a = block_apply(cfg, kind, pparams[name], x, ctx,
                                       cache)
                out[name] = nc if nc is not None else {}
                aux = aux + a
            return x, aux, out

        if cfg.remat and not want_cache and torch.is_grad_enabled():
            body = _remat(cfg, body)
        outs = []
        for pparams, pcaches in zip(_layers(params["scan"], n_periods),
                                    _layers(scan_caches, n_periods)):
            x, aux, out = body(x, aux, pparams, pcaches)
            outs.append(out)
        if mode == "decode":
            new_caches["scan"] = scan_caches    # updated in place
        elif want_cache:
            new_caches["scan"] = _stack(outs)

    tail_names = [f"{j}_{k}" for j, k in enumerate(tail)]
    x, aux = seq_blocks(x, aux, tail_names, params.get("tail", {}),
                        (caches or {}).get("tail"), new_caches["tail"])
    return x, (new_caches if want_cache else None), aux
