"""RecurrentGemma-2B [arXiv:2402.19427] — hybrid RG-LRU + local attention 1:2.

26 layers: 8 periods of (rec, rec, local-attn) + 2 trailing recurrent
layers; sliding window 2048; GQA kv=1 on the attention layers.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
    pattern=("rec", "rec", "local"), n_periods=8, tail=("rec", "rec"),
    head_dim=256, window=2048, lru_width=2560,
    mlp="geglu", norm="rms", tie_embeddings=True,
    source="arXiv:2402.19427",
)
