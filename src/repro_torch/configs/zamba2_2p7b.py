"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (MHA kv=32) d_ff=10240
vocab=32000, ssm_state=64. Mamba2 backbone + ONE shared attention+MLP block
applied every ``hybrid_shared_period`` mamba layers (weights reused each
application — the Zamba trick). [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    mlp_activation="gelu",
    positional="rope",
    tie_embeddings=True,
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    hybrid_shared_period=6,
    source="arXiv:2411.15242 (Zamba2)",
)
