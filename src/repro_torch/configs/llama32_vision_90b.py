"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision scaled] — VLM.

100-layer decoder; every 5th layer is a gated cross-attention layer over
precomputed patch embeddings (the vision frontend is a STUB per the
assignment: input_specs() supplies (B, n_patches, d_model) embeddings).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256,
    pattern=("dense", "dense", "dense", "dense", "cross"), n_periods=20,
    head_dim=128, rope_theta=5e5,
    mlp="swiglu", norm="rms",
    seq_parallel=True,  # Megatron-SP: see EXPERIMENTS.md §Perf hillclimb 4
    src_len=6400,  # ~4 tiles x 1601 patches, precomputed embeddings (stub)
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B scaling)",
)
