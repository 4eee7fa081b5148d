"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model. [hf:HuggingFaceTB/SmolLM-360M]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    mlp_activation="swiglu",
    positional="rope",
    tie_embeddings=True,
    norm="rmsnorm",
    source="hf:HuggingFaceTB/SmolLM-360M",
)
