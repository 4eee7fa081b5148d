"""Batched decode engine: prefill → token-by-token generation through a
pluggable ``SoftmaxHead``. Twin of ``repro/serving/engine.py`` (the lstm,
ssm and hybrid families; ``serve_batch``, ``DecodeStream`` and the
scheduler come later).

The head is the ONE seam: greedy decode, temperature/nucleus sampling, and
beam search all route next-token selection through ``head.next`` /
``head.sample`` / ``head.topk_logprobs``. A head is a registry name
("exact", "screened", "screened-cuda") resolved against the engine's
(W, b, screen) context, or a ready ``SoftmaxHead`` instance, and every
public method takes ``head=`` overriding the engine default.

PyTorch runs eagerly, so there is no compiled-step cache: each step is the
model's ``decode_step`` followed by the head's call. Generated tokens stay
on the device until the loop ends.

Beam search follows the paper's §4.2 protocol: log-softmax over the head's
reduced candidate space, probability 0 (−inf log-prob) elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import heads as heads_registry
from repro_torch.core.screening import ScreenParams
from repro_torch.device import resolve_device
from repro_torch.heads.base import SoftmaxHead
from repro_torch.models.model import Model, to_device
from repro_torch.tree import tree_map

HeadLike = Union[str, SoftmaxHead]


@dataclass
class GenerationResult:
    tokens: np.ndarray              # (B, T_new) generated ids
    scores: Optional[np.ndarray] = None
    steps: int = 0


class DecodeEngine:
    def __init__(self, model: Model, params, head: HeadLike = "exact",
                 screen: Optional[ScreenParams] = None, max_len: int = 512,
                 cache_dtype=torch.float32, head_kwargs: Optional[dict] = None,
                 device="cuda"):
        """``head``: default decode head — a registry name or an instance.
        ``screen``: L2S screen handed to screening heads resolved by name.
        ``max_len``: cache slots per row (prompt + generated tokens);
        ``cache_dtype``: dtype of the K/V caches (conv tails and SSM states
        stay f32, as the reference's do after prefill).
        ``head_kwargs``: extra construction kwargs for name resolution
        (e.g. ``{"fused": False}``). ``device``: "cuda" (default; raises
        without a GPU) or "cpu"; params and screen are moved there."""
        self.device = resolve_device(device)
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.model = model
        self.params = to_device(params, self.device)
        self.screen = None if screen is None else screen.to(self.device)
        self.W, self.b = model.softmax_weights(self.params)
        self._head_kwargs = dict(head_kwargs or {})
        self._head_cache: Dict[str, SoftmaxHead] = {}
        self.head = self.resolve_head("exact" if head is None else head)

    # -- head resolution ----------------------------------------------------
    def resolve_head(self, head: Optional[HeadLike]) -> SoftmaxHead:
        """name | instance | None (engine default) → prepared SoftmaxHead."""
        if head is None:
            return self.head
        if isinstance(head, str):
            if head not in self._head_cache:
                self._head_cache[head] = heads_registry.get(
                    head, device=self.device, W=self.W, b=self.b,
                    screen=self.screen, **self._head_kwargs)
            return self._head_cache[head]
        return head.prepare()

    def _prefill(self, prompts, max_new: int):
        """prompts (B, Tp) → (h_last (B, d), cache, Tp). Raises if the
        prompt and ``max_new`` tokens do not fit ``max_len`` cache slots."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                 device=self.device)
        B, Tp = tokens.shape
        if Tp + max_new > self.max_len:
            raise ValueError(f"a prompt of {Tp} tokens and {max_new} new ones "
                             f"need {Tp + max_new} cache slots; max_len is "
                             f"{self.max_len}")
        cache = self.model.init_cache(B, self.max_len, dtype=self.cache_dtype,
                                      device=self.device)
        h, cache = self.model.prefill(self.params, {"tokens": tokens}, cache)
        return h[:, -1].contiguous(), cache, Tp

    # -- generation (greedy or sampled, head-routed) -------------------------
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int,
                 head: Optional[HeadLike] = None,
                 temperature: Optional[float] = None, top_p: float = 1.0,
                 seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """prompts: (B, Tp) int. Decode ``max_new`` tokens.

        ``temperature=None`` (default) is greedy; otherwise temperature /
        nucleus sampling through ``head.sample``, with noise from
        ``generator`` (a ``torch.Generator`` on the engine's device) or from
        a new one seeded with ``seed`` — one of them is required unless
        temperature ≤ 0."""
        hd = self.resolve_head(head)
        h_last, cache, Tp = self._prefill(prompts, max_new)
        if temperature is None:
            def pick(h):
                return hd.next(h)
        else:
            if generator is None:
                if seed is None and temperature > 0:
                    raise ValueError("sampling with temperature > 0 needs a "
                                     "seed= or a generator=")
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0 if seed is None else int(seed))

            def pick(h):
                return hd.sample(h, temperature, top_p, generator=generator)
        tok = pick(h_last)
        out = [tok]
        for i in range(max_new - 1):
            h1, cache = self.model.decode_step(self.params, tok, cache, Tp + i)
            tok = pick(h1)
            out.append(tok)
        tokens = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=tokens, steps=max_new)

    # -- beam search (batch of 1 prompt, beam B_w) ---------------------------
    @torch.inference_mode()
    def beam_search(self, prompt: np.ndarray, beam: int, max_new: int,
                    head: Optional[HeadLike] = None) -> GenerationResult:
        """prompt: (Tp,) int. Returns the top beam's tokens and score.

        ``head.topk_logprobs`` supplies the per-step (ids, log-probs)."""
        hd = self.resolve_head(head)
        prompts = np.broadcast_to(np.asarray(prompt)[None],
                                  (beam, len(prompt))).copy()
        h_last, cache, Tp = self._prefill(prompts, max_new)

        ids, lps = hd.topk_logprobs(h_last[:1], beam)      # expand from beam 0
        ids, lps = ids.cpu().numpy(), lps.cpu().numpy()
        beam_tokens = [[int(ids[0, j])] for j in range(beam)]
        beam_scores = np.asarray(lps[0], np.float64).copy()
        tok = torch.as_tensor(ids[0], dtype=torch.long, device=self.device)

        for i in range(max_new - 1):
            h1, cache = self.model.decode_step(self.params, tok, cache, Tp + i)
            ids, lps = hd.topk_logprobs(h1, beam)          # (beam, beam)
            ids = ids.cpu().numpy()
            total = beam_scores[:, None] + lps.cpu().numpy().astype(np.float64)
            flat = total.reshape(-1)
            top = np.argsort(-flat)[:beam]
            src, choice = np.unravel_index(top, total.shape)
            beam_tokens = [beam_tokens[s] + [int(ids[s, c])]
                           for s, c in zip(src, choice)]
            beam_scores = flat[top]
            tok = torch.as_tensor(ids[src, choice], dtype=torch.long,
                                  device=self.device)
            # reorder caches to follow the surviving beams
            src_idx = torch.as_tensor(src, dtype=torch.long,
                                      device=self.device)
            cache = _reorder_cache(cache, src_idx, self.model.cfg)

        best = int(np.argmax(beam_scores))
        return GenerationResult(tokens=np.asarray(beam_tokens[best])[None],
                                scores=beam_scores[best:best + 1],
                                steps=max_new)


def _reorder_cache(cache, src_idx, cfg):
    """Gather beam rows. LSTM state lists carry batch at axis 0; the stacked
    SSM / attention caches at axis 1."""
    if cfg.family == "lstm":
        return tree_map(lambda a: a[src_idx], cache)
    return tree_map(lambda a: a[:, src_idx], cache)
