"""Config registry: ``get_config("<arch-id>")`` over every config of the
reference's registry (the paper's LSTMs, the dense transformers
smollm-360m, gemma-2b, starcoder2-3b and qwen1.5-110b, the moe
transformers mixtral-8x7b and phi3.5-moe-42b-a6.6b, mamba2-1.3b,
zamba2-2.7b, the vlm qwen2-vl-2b and the audio encoder hubert-xlarge), and
``ASSIGNED_ARCHS``, the ten the dry run costs over ``INPUT_SHAPES``."""
from __future__ import annotations

from repro_torch.configs.base import (INPUT_SHAPES, V_BLK, L2SConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, TrainConfig, shapes_for)
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert_xlarge
from repro_torch.configs.mamba2_1p3b import CONFIG as _mamba2_1p3b
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.nmt_deen import CONFIG as _nmt_deen
from repro_torch.configs.phi35_moe import CONFIG as _phi35_moe
from repro_torch.configs.ptb_lstm import PTB_LARGE as _ptb_large
from repro_torch.configs.ptb_lstm import PTB_SMALL as _ptb_small
from repro_torch.configs.qwen15_110b import CONFIG as _qwen15_110b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.smollm_360m import CONFIG as _smollm_360m
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2_3b
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2_2p7b

REGISTRY = {c.name: c for c in (_ptb_small, _ptb_large, _nmt_deen,
                                _smollm_360m, _gemma_2b, _starcoder2_3b,
                                _qwen15_110b, _mixtral_8x7b, _phi35_moe,
                                _mamba2_1p3b, _zamba2_2p7b, _qwen2_vl_2b,
                                _hubert_xlarge)}


ASSIGNED_ARCHS = (
    "gemma-2b",
    "phi3.5-moe-42b-a6.6b",
    "smollm-360m",
    "qwen2-vl-2b",
    "hubert-xlarge",
    "starcoder2-3b",
    "zamba2-2.7b",
    "qwen1.5-110b",
    "mamba2-1.3b",
    "mixtral-8x7b",
)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ASSIGNED_ARCHS", "INPUT_SHAPES", "L2SConfig", "ModelConfig",
           "MoEConfig", "REGISTRY", "SSMConfig", "ShapeConfig", "TrainConfig",
           "V_BLK", "get_config", "shapes_for"]
