"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064. QKV bias (Qwen1.5 family trait). [hf:Qwen/Qwen1.5-110B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152_064,
    mlp_activation="swiglu",
    positional="rope",
    qkv_bias=True,
    tie_embeddings=False,
    norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-110B (QKV-bias per hf:Qwen/Qwen1.5-0.5B card family)",
)
