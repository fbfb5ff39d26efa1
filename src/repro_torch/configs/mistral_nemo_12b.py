"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA kv=8, 128k ctx."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
    pattern=("dense",), n_periods=40,
    head_dim=128, rope_theta=1e6,
    mlp="swiglu", norm="rms",
    seq_parallel=True,  # Megatron-SP: see EXPERIMENTS.md §Perf hillclimb 4
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
