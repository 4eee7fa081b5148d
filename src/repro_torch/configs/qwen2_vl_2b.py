"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE (3-component rotary: temporal/height/width), dynamic-resolution vision.
The vision frontend (ViT) is a stub: the caller provides precomputed patch
embeddings; this config is the language decoder. [arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    mlp_activation="swiglu",
    positional="mrope",
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    num_patch_tokens=256,   # patch embeddings prepended by the stub frontend
    source="arXiv:2409.12191 (Qwen2-VL)",
)
