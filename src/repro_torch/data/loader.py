"""Host batches onto the device, and the step inputs of the dry run.
Twin of ``repro/data/loader.py``: ``BatchLoader`` without a mesh (the port
trains on one card); ``input_specs(cfg, shape)`` the exact dict of inputs
each step function consumes, as tensors on the ``meta`` device by default
(the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no storage),
which ``launch/dryrun.py`` runs its steps on; ``random_inputs`` concrete
random inputs of the same keys, shapes and dtypes."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
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


def input_specs(cfg: ModelConfig, shape, device="meta"
                ) -> Dict[str, torch.Tensor]:
    """Inputs for (arch, input shape), as empty tensors on ``device``.

    train / prefill: the full-sequence batch; decode: ONE token per
    sequence and the absolute position (0-dim int32), the cache being
    threaded separately by the step. The modality frontends are stubs, as
    in the reference: audio supplies frame embeddings, the vlm patch
    embeddings, both at d_model width in the config's dtype."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    dev = resolve_device(device)
    B, T = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            out = {"frames": spec((B, T, cfg.d_model), dt)}
        elif cfg.family == "vlm":
            P = cfg.num_patch_tokens
            out = {"tokens": spec((B, T - P), torch.int32),
                   "patches": spec((B, P, cfg.d_model), dt)}
        else:
            out = {"tokens": spec((B, T), torch.int32)}
        if shape.kind == "train":
            lab_T = T - cfg.num_patch_tokens if cfg.family == "vlm" else T
            out["labels"] = spec((B, lab_T), torch.int32)
        return out
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode inputs")
    return {"token": spec((B,), torch.int32), "pos": spec((), torch.int32)}


def random_inputs(cfg: ModelConfig, shape, seed: int = 0, device="cuda"
                  ) -> Dict[str, torch.Tensor]:
    """Concrete random inputs matching ``input_specs``, drawn with numpy
    from ``seed`` as the reference draws them (token ids below the
    vocabulary, ``pos`` 0, embeddings standard normal), on ``device``."""
    specs = input_specs(cfg, shape)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in specs.items():
        if s.dtype.is_floating_point:
            a = rng.standard_normal(tuple(s.shape))
        elif k == "pos":
            a = np.zeros((), np.int64)
        else:
            hi = cfg.vocab_size if k in ("tokens", "labels", "token") \
                else 2 ** 30
            a = rng.integers(0, hi, tuple(s.shape))
        out[k] = torch.as_tensor(a).to(device=dev, dtype=s.dtype)
    return out
