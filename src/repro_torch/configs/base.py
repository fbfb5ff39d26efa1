"""ArchConfig: declarative architecture description + shape registry.

The counterpart of :mod:`repro.configs.base`, with ``dtype`` a torch
dtype and ``head_shuffle`` naming the port's engines.

Layer stacking is declared as ``prefix + pattern * n_periods + tail`` where
each entry is a block kind: "dense", "moe", "cross", "rec", "local",
"mamba", "enc", "dec". The repeating ``pattern`` keeps its parameters
stacked on a leading layer axis, and the stack runs it as a loop over
that axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # stack structure
    pattern: Tuple[str, ...] = ("dense",)
    n_periods: int = 0
    prefix: Tuple[str, ...] = ()
    tail: Tuple[str, ...] = ()
    # attention details
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rotary_frac: float = 1.0          # fraction of head_dim rotated (chatglm: 0.5)
    window: Optional[int] = None      # sliding-window size for "local" blocks
    head_shuffle: Optional[str] = None  # BMMC kv-head shuffle engine
    #   (None = off; "ref" | "cuda" route the shuffle through that
    #   combinator engine — semantically neutral, see models/attention.py)
    # mlp
    mlp: str = "swiglu"               # swiglu | gelu
    norm: str = "rms"                 # rms | ln
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"           # gspmd (capacity+all-reduce) | a2a (shard_map)
    # ssm
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # rg-lru
    lru_width: Optional[int] = None
    # enc-dec / multimodal stubs
    n_enc_periods: int = 0
    enc_pattern: Tuple[str, ...] = ("enc",)
    src_len: int = 0                  # audio frames / vision patches (stub frontend)
    # numerics
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"     # nothing | dots (save matmul outputs)
    seq_parallel: bool = False        # Megatron-SP activation sharding
    kv_block: int = 1024
    opt_bits: int = 32                # 8 => block-quantized AdamW moments
    # misc metadata
    source: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.prefix + self.pattern * self.n_periods + self.tail

    @property
    def n_layers(self) -> int:
        return len(self.layer_kinds)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_periods > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if decode memory is o(seq): pure SSM / windowed hybrid."""
        kinds = set(self.layer_kinds)
        full_attn = {"dense", "moe", "cross", "dec", "enc"} & kinds
        return not full_attn

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        e, h = self.d_model, self.hd
        total = self.vocab_size * e * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            if kind in ("dense", "local", "enc"):
                total += self._attn_params() + self._mlp_params()
            elif kind == "moe":
                total += self._attn_params() + self._moe_params()
            elif kind in ("cross", "dec"):
                total += self._attn_params() * (2 if kind == "dec" else 1) + self._mlp_params()
                if kind == "cross":
                    total += self._attn_params()
            elif kind == "rec":
                w = self.lru_width or self.d_model
                total += 2 * e * w + 2 * w * w // 1 + w * e + self._mlp_params()
            elif kind == "mamba":
                di = self.ssm_expand * e
                g_n = self.ssm_state
                nh = di // self.ssm_headdim
                total += e * (2 * di + 2 * g_n + nh) + di * e
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top_k + shared)."""
        if self.n_experts == 0:
            return self.n_params()
        e = self.d_model
        per_expert = 3 * e * self.moe_d_ff
        routed_total = self.n_experts * per_expert * self._n_moe_layers()
        routed_active = (self.top_k + self.n_shared_experts) * per_expert * self._n_moe_layers()
        return self.n_params() - routed_total + routed_active

    def _n_moe_layers(self) -> int:
        return sum(k == "moe" for k in self.layer_kinds)

    def _attn_params(self) -> int:
        e, h = self.d_model, self.hd
        return e * self.n_heads * h + 2 * e * self.n_kv_heads * h + self.n_heads * h * e

    def _mlp_params(self) -> int:
        mult = 3 if self.mlp == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def _moe_params(self) -> int:
        per = 3 * self.d_model * self.moe_d_ff
        return (self.n_experts + self.n_shared_experts) * per + self.d_model * self.n_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Same family, tiny dims — for CPU smoke tests (one step, no NaNs)."""
    return dataclasses.replace(
        cfg,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_periods=min(cfg.n_periods, 2),
        prefix=cfg.prefix[:1],
        tail=cfg.tail[:1],
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=8 if cfg.ssm_state else 64,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else None,
        window=min(cfg.window, 8) if cfg.window else None,
        n_enc_periods=min(cfg.n_enc_periods, 2),
        src_len=16 if cfg.src_len else 0,
        dtype=torch.float32,
        remat=False,
        kv_block=8,
    )
