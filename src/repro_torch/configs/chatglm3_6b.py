"""ChatGLM3-6B [arXiv:2406.12793; hf] — dense, GQA kv=2, 2d (partial) RoPE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=65024,
    pattern=("dense",), n_periods=28,
    head_dim=128, qkv_bias=True, rope_theta=1e4, rotary_frac=0.5,
    mlp="swiglu", norm="rms",
    seq_parallel=True,  # Megatron-SP: see EXPERIMENTS.md §Perf hillclimb 4
    source="arXiv:2406.12793",
)
