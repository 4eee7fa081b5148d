"""Model configuration: the LSTM fields of the reference ``ModelConfig``.

The port carries only the paper's own family (``lstm``) so far; the fields
the attention, MoE and SSM families use come with their slice (ROADMAP.md,
Queue 1). ``reduced()`` gives the same small CPU variant as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

# Vocab block size of the block-candidate screens and of the packed softmax
# head (one CUDA tile of 128 rows).
V_BLK = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    tie_embeddings: bool = True
    source: str = ""
    dtype: str = "float32"

    def reduced(self) -> "ModelConfig":
        """Same family, tiny: 2 layers, d_model ≤ 128, vocab ≤ 512."""
        return replace(self, name=self.name + "-reduced", num_layers=2,
                       d_model=min(self.d_model, 128),
                       vocab_size=min(self.vocab_size, 512), dtype="float32")
