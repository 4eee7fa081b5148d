"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU activation, head_dim=256 (wider than d_model/heads), MQA on the 2b
variant. [arXiv:2403.08295]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    mlp_activation="geglu",
    positional="rope",
    tie_embeddings=True,
    norm="rmsnorm",
    source="arXiv:2403.08295 (Gemma)",
)
