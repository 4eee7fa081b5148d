"""Config registry: ``get_config("<arch-id>")`` over the paper's LSTMs."""
from __future__ import annotations

from repro_torch.configs.base import V_BLK, ModelConfig
from repro_torch.configs.nmt_deen import CONFIG as _nmt_deen
from repro_torch.configs.ptb_lstm import PTB_LARGE as _ptb_large
from repro_torch.configs.ptb_lstm import PTB_SMALL as _ptb_small

REGISTRY = {c.name: c for c in (_ptb_small, _ptb_large, _nmt_deen)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "V_BLK", "get_config"]
