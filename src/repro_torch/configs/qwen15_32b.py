"""Qwen1.5-32B [hf:Qwen] — dense, GQA kv=40 (MHA-width kv), QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064,
    pattern=("dense",), n_periods=64,
    head_dim=128, qkv_bias=True, rope_theta=1e6,
    mlp="swiglu", norm="rms",
    seq_parallel=True,  # Megatron-SP: see EXPERIMENTS.md §Perf hillclimb 4
    source="hf:Qwen/Qwen1.5-32B",
)
