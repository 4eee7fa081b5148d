"""The paper's NMT DE→EN softmax setup: 2-layer LSTM decoder, vocab ≈ 25k
(IWSLT-14 DE-EN, OpenNMT checkpoint; hidden 500 per OpenNMT defaults).
[Cettolo et al. 2014; paper §4]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nmt-deen-lstm",
    family="lstm",
    num_layers=2,
    d_model=500,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=25_000,
    positional="none",
    tie_embeddings=False,
    norm="layernorm",
    source="L2S paper §4 (IWSLT-14 DE-EN, OpenNMT 2-layer LSTM)",
    dtype="float32",
)
