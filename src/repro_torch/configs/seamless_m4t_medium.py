"""SeamlessM4T-medium [arXiv:2308.11596] — enc-dec, multimodal backbone.

The audio frontend is a STUB per the assignment: input_specs() supplies
precomputed frame embeddings (B, src_len, d_model) consumed by a 12-layer
encoder; the 12-layer decoder attends via cross-attention.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=256206,
    pattern=("dec",), n_periods=12,
    enc_pattern=("enc",), n_enc_periods=12,
    head_dim=64, rope_theta=1e4,
    mlp="gelu", norm="ln",
    src_len=4096,  # precomputed audio frame embeddings (stub)
    source="arXiv:2308.11596",
)
