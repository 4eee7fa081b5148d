"""Speculative decoding: draft cheap, verify exact, emit only what the
exact head would have emitted (see stream.py for the full contract). Twin
of ``repro/serving/spec``."""
from repro_torch.serving.spec.acceptance import (accept_draft, accept_step,
                                                 emission_distribution,
                                                 greedy_accept_lengths,
                                                 row_probs)
from repro_torch.serving.spec.policy import (DraftLenController, SpecPolicy,
                                             spec_step_flops)
from repro_torch.serving.spec.stream import SpecDecodeStream

__all__ = [
    "accept_draft",
    "accept_step",
    "emission_distribution",
    "greedy_accept_lengths",
    "row_probs",
    "DraftLenController",
    "SpecPolicy",
    "spec_step_flops",
    "SpecDecodeStream",
]
