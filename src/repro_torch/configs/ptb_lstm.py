"""The paper's own models: 2-layer LSTM language models (PTB-Small/Large).

PTB-Small: hidden/embedding 200; PTB-Large: 1500. Vocab 10k (PTB).
[Marcus et al. 1993; paper §4]
"""
from repro_torch.configs.base import ModelConfig

PTB_SMALL = ModelConfig(
    name="ptb-small-lstm",
    family="lstm",
    num_layers=2,
    d_model=200,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=10_000,
    positional="none",
    tie_embeddings=False,
    norm="layernorm",
    source="L2S paper §4 (PTB-Small, 2-layer LSTM h=200)",
    dtype="float32",
)

PTB_LARGE = ModelConfig(
    name="ptb-large-lstm",
    family="lstm",
    num_layers=2,
    d_model=1500,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=10_000,
    positional="none",
    tie_embeddings=False,
    norm="layernorm",
    source="L2S paper §4 (PTB-Large, 2-layer LSTM h=1500)",
    dtype="float32",
)
