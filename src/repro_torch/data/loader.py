"""Host batches onto the device. Twin of ``repro/data/loader.py``'s
``BatchLoader``, without a mesh: the port trains on one card. The
reference's ``input_specs`` and ``random_inputs`` belong to its XLA dry-run
(ROADMAP.md, Queue 1)."""
from __future__ import annotations

from typing import Iterator

import torch

from repro_torch.device import resolve_device


class BatchLoader:
    """Iterates ``generator``'s numpy batches (dicts of arrays) as dicts of
    tensors on ``device`` ("cuda" by default; raises without a GPU unless
    the caller passes device="cpu")."""

    def __init__(self, generator: Iterator[dict], device="cuda"):
        self.generator = generator
        self.device = resolve_device(device)

    def __iter__(self):
        for batch in self.generator:
            yield {k: torch.as_tensor(v, device=self.device)
                   for k, v in batch.items()}
