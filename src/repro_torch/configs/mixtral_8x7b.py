"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    mlp_activation="swiglu",
    positional="rope",
    tie_embeddings=False,
    norm="rmsnorm",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
