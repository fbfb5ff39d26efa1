"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=0, vocab_size=50280,
    pattern=("mamba",), n_periods=24,
    ssm_state=128, ssm_headdim=64, ssm_conv=4, ssm_expand=2, ssm_chunk=256,
    mlp="swiglu", norm="rms", tie_embeddings=True,
    source="arXiv:2405.21060",
)
