"""Phi-3.5-MoE 42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct] — 16e top-2 MoE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    pattern=("moe",), n_periods=32,
    head_dim=128, rope_theta=1e4,
    mlp="swiglu", norm="ln",
    n_experts=16, top_k=2, moe_d_ff=6400,
    moe_impl="a2a",     # explicit all-to-all dispatch (EXPERIMENTS §Perf h.5)
    seq_parallel=True,  # matches the a2a token layout
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
