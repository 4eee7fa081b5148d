"""Serving: the batched decode engine."""
from repro_torch.serving.engine import DecodeEngine, GenerationResult

__all__ = ["DecodeEngine", "GenerationResult"]
