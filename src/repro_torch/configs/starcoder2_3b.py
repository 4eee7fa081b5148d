"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152. GQA + RoPE; GELU MLP with bias per the model card.
[arXiv:2402.19173]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49_152,
    mlp_activation="gelu",
    positional="rope",
    qkv_bias=True,
    tie_embeddings=True,
    norm="layernorm",
    source="arXiv:2402.19173 (StarCoder2)",
)
