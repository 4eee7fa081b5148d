"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504.

Encoder-only (same arch as wav2vec2); masked prediction over a 504-unit
codebook. The conv / mel frontend is a stub: the caller provides precomputed
frame embeddings. No decode (encoder-only). L2S does not apply: 504 units
are under four 128-word tiles. [arXiv:2106.07447]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_activation="gelu",
    positional="learned",
    tie_embeddings=False,
    norm="layernorm",
    is_encoder=True,
    source="arXiv:2106.07447 (HuBERT)",
)
