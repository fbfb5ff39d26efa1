"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE, GELU MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432, vocab_size=49152,
    pattern=("dense",), n_periods=32,
    head_dim=128, qkv_bias=True, rope_theta=1e5,
    mlp="gelu", norm="ln", tie_embeddings=True,
    seq_parallel=True,  # Megatron-SP: see EXPERIMENTS.md §Perf hillclimb 4
    source="arXiv:2402.19173",
)
