"""Model facade: ArchConfig -> parameter defs, loss, prefill, decode.

The counterpart of :mod:`repro.models.model`. The entry points
are functions of ``(cfg, params, inputs)`` over a nested dict of tensors
(the reference's parameter tree, path for path); :class:`LM` holds such a
tree as an ``nn.Module``, so ``named_parameters()`` gives the reference's
paths (``stack.scan.0_dense.wq``). Everything runs on the device of the
parameters. With a ``mesh`` (:mod:`repro_torch.launch.mesh`) every rank
holds the parameters and activations whole (replicated) and runs the
same program; the all-to-all MoE body alone works on each rank's slice
(:mod:`repro_torch.parallel.sharding`, :mod:`.moe_a2a`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..parallel.sharding import (activation_constrainer, dp_size,
                                 moe_buffer_constrainer)
from .layers import (ParamDef, axes_tree, init_params, layer_norm,
                     matmul_f32, rms_norm, shape_tree)
from .transformer import run_stack, stack_cache_defs, stack_defs_tree


def _make_ctx(cfg: ArchConfig, mode: str, mesh, pos: int) -> Dict:
    return {"mode": mode, "pos": int(pos), "mesh": mesh,
            "constrain": activation_constrainer(
                mesh, seq_parallel=getattr(cfg, "seq_parallel", False)),
            "constrain_moe": moe_buffer_constrainer(mesh),
            "dp_groups": dp_size(mesh)}


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def model_defs(cfg: ArchConfig) -> Dict:
    dt = cfg.dtype
    defs: Dict = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), dt),
        "stack": stack_defs_tree(cfg),
    }
    if cfg.norm == "ln":
        defs["final_scale"] = ParamDef((cfg.d_model,), ("embed",), dt, "ones")
        defs["final_bias"] = ParamDef((cfg.d_model,), ("embed",), dt, "zeros")
    else:
        defs["final_scale"] = ParamDef((cfg.d_model,), ("embed",), dt, "zeros")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), dt)
    if cfg.is_encdec:
        defs["enc_stack"] = stack_defs_tree(
            cfg, pattern=cfg.enc_pattern, n_periods=cfg.n_enc_periods,
            prefix=(), tail=())
        defs["enc_final_scale"] = ParamDef((cfg.d_model,), ("embed",), dt, "zeros")
    return defs


def model_cache_defs(cfg: ArchConfig, batch: int, cache_len: int) -> Dict:
    return stack_cache_defs(cfg, batch, cache_len)


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Random parameters on ``generator``'s device (see
    :func:`.layers.init_params`)."""
    return init_params(model_defs(cfg), generator)


def param_shapes(cfg: ArchConfig):
    """The parameter tree as ``meta`` tensors (shapes and types, nothing
    allocated)."""
    return shape_tree(model_defs(cfg))


def param_axes(cfg: ArchConfig):
    return axes_tree(model_defs(cfg))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _final_norm(cfg, params, x, prefix=""):
    if cfg.norm == "ln":
        return layer_norm(x, params[f"{prefix}final_scale"], params[f"{prefix}final_bias"])
    return rms_norm(x, params[f"{prefix}final_scale"])


def _head(cfg, params, x):
    """Float32 logits. The table is widened to float32 for the product:
    a vocab x d_model float32 copy while it runs (2.7 GB for
    Mistral-NeMo-12B's 131072 x 5120)."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return matmul_f32(x, table.t())


def _encode(cfg, params, src, ctx):
    """Run the encoder stack over stub source embeddings (audio). The
    final norm is ``rms_norm`` for every ``cfg.norm``, as the
    reference's."""
    x, _, _ = run_stack(cfg, params["enc_stack"], src,
                        {**ctx, "mode": "train", "pos": 0},
                        pattern=cfg.enc_pattern, n_periods=cfg.n_enc_periods,
                        prefix=(), tail=())
    return rms_norm(x, params["enc_final_scale"])


def _enc_states(cfg, params, batch: Dict, ctx):
    """Cross-attention memory: encoder output (audio) or raw patch embeds (vlm)."""
    if cfg.is_encdec:
        return _encode(cfg, params, batch["src"], ctx)
    if cfg.family == "vlm":
        return batch["src"]
    return None


def forward(cfg: ArchConfig, params: Dict, batch: Dict, *, mode: str = "train",
            mesh=None):
    """batch: {"tokens": (B,S) int64 or int32 tensor, optional "src": (B,Ssrc,E)
    source embeddings (encoder-decoder and VLM configurations)}.

    Returns (logits (B,S,V) f32, caches-or-None, aux).
    """
    ctx = _make_ctx(cfg, mode, mesh, 0)
    ctx["enc"] = _enc_states(cfg, params, batch, ctx)
    x = F.embedding(batch["tokens"], params["embed"])
    x, caches, aux = run_stack(cfg, params["stack"], x, ctx)
    x = _final_norm(cfg, params, x)
    logits = _head(cfg, params, x)
    return logits, caches, aux


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, *, mesh=None):
    """Causal-LM cross entropy (+ MoE aux). batch needs "labels" (B,S),
    int64 or int32 (the reference's type, widened here for the gather).
    Returns ``(loss, {"ce": ..., "aux": ...})``, float32 0-d."""
    logits, _, aux = forward(cfg, params, batch, mode="train", mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    loss = -torch.mean(ll)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def prefill(cfg: ArchConfig, params: Dict, batch: Dict, *, mesh=None):
    """Full-sequence forward emitting decode caches + last-position logits."""
    logits, caches, _ = forward(cfg, params, batch, mode="prefill", mesh=mesh)
    return logits[:, -1:], caches


def grow_caches(caches: Dict, old_len: int, new_len: int) -> Dict:
    """Extend KV caches from ``old_len`` to ``new_len`` positions.

    Stacked caches carry a leading layer axis (layers, B, S, ...): their
    sequence axis is 2; prefix/tail caches use axis 1. Only the
    self-attention caches ``k`` and ``v`` whose sequence axis equals
    ``old_len`` are padded (with zeros): SSM/RG-LRU state and conv leaves
    and the cross-attention ``ck``/``cv`` are length-independent and pass
    through. (The reference tests the length alone, so a state whose head
    or source axis happens to equal ``old_len`` would be padded too.)
    """
    pad = new_len - old_len
    if pad <= 0:
        return caches

    def pad_tree(tree, axis, key=None):
        if isinstance(tree, dict):
            return {k: pad_tree(v, axis, k) for k, v in tree.items()}
        if (key in ("k", "v") and tree.dim() > axis
                and tree.shape[axis] == old_len):
            widths = [0, 0] * (tree.dim() - 1 - axis) + [0, pad]
            return F.pad(tree, widths)
        return tree

    return {group: pad_tree(sub, 2 if group == "scan" else 1)
            for group, sub in caches.items()}


def decode_step(cfg: ArchConfig, params: Dict, caches: Dict, tokens, pos,
                *, mesh=None):
    """One-token decode. tokens: (B,1) int64; pos: the number of valid
    tokens. The new token's k/v and every advanced state (conv tails, SSD
    and RG-LRU states) are written into ``caches`` in place.

    Returns (logits (B,1,V) f32, new_caches).
    """
    ctx = _make_ctx(cfg, "decode", mesh, pos)
    ctx["enc"] = None
    x = F.embedding(tokens, params["embed"])
    x, new_caches, _ = run_stack(cfg, params["stack"], x, ctx, caches)
    x = _final_norm(cfg, params, x)
    return _head(cfg, params, x), new_caches


# ---------------------------------------------------------------------------
# The parameter tree as a module
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict a submodule, each
    leaf a trainable parameter under its own name (sharing the leaf's
    storage), so the module's parameter paths are the tree's. Serving
    runs under ``torch.no_grad()`` and builds no autograd graph."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Dict:
        """The nested dict of parameter tensors (no copies)."""
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LM(ParamTree):
    """A language model of configuration ``cfg`` over the parameter tree
    ``params`` (as :func:`init` or
    :func:`repro_torch.models.convert.params_from_numpy` return it)."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch: Dict, *, mode: str = "train"):
        return forward(self.cfg, self.tree(), batch, mode=mode)

    def prefill(self, batch: Dict):
        return prefill(self.cfg, self.tree(), batch)

    def decode_step(self, caches: Dict, tokens, pos):
        return decode_step(self.cfg, self.tree(), caches, tokens, pos)
