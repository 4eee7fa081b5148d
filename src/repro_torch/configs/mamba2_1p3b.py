"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality) chunked algorithm.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    mlp_activation="gelu",   # unused (attention-free, no MLP stack)
    positional="none",
    tie_embeddings=True,
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)
