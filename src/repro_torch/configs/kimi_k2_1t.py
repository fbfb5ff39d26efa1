"""Kimi-K2 1T-A32B [arXiv:2501 (kimi2); unverified] — trillion-param MoE.

61 layers: 1 dense prefix layer + 60 MoE layers, 384 experts top-8 with one
shared expert, expert d_ff=2048 (assignment), dense-layer d_ff=18432.
Requires EP over model axis + FSDP over (pod, data) + 8-bit optimizer
states to fit 512 x 16 GB (see parallel/sharding.py, optim/adamw.py).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    d_model=7168, n_heads=64, n_kv_heads=8, d_ff=18432, vocab_size=163840,
    prefix=("dense",), pattern=("moe",), n_periods=60,
    head_dim=128, rope_theta=5e4,
    mlp="swiglu", norm="rms",
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    opt_bits=8,  # 1.03T params: int8 AdamW moments to fit 512 x 16 GB
    moe_impl="a2a",     # explicit all-to-all dispatch (EXPERIMENTS §Perf h.5)
    seq_parallel=True,  # matches the a2a token layout
    source="arXiv:2501.kimi2 (paper-table)",
)
