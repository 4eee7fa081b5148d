"""The ``SoftmaxHead`` protocol — the one seam every decode head plugs into.

Twin of ``repro/heads/base.py``. A head owns the softmax layer (W (L, d),
b (L,)) plus whatever its approximation needs (a learned screen, a packed
copy of W, ...) and answers four queries over context vectors h (B, d):

  topk(h, k)          → (ids (B, k) int32, scores (B, k))   raw logits
  topk_logprobs(h, k) → (ids (B, k) int32, logprobs (B, k)) paper §4.2
                        convention: log-softmax over the head's OWN
                        candidate space, probability 0 elsewhere
  next(h)             → (B,) int32 greedy argmax
  sample(h, temperature, top_p, generator=None, gumbel=None) → (B,) int32

Sampling draws its Gumbel noise, of the head's ``noise_shape``, from
``generator`` (a ``torch.Generator`` on the head's device), or takes it
ready-made as ``gumbel``: the same noise handed to two heads gives the same
draw.

``prepare()`` performs any one-time packing and returns the head; it is
idempotent and is called by the registry and the serving engine.

Routing metadata (``describe()``, ``memory_bytes``, ``step_key()``) is the
reference's, with one change of meaning: ``device_kind`` names the
framework, ``"torch"`` where the reference says ``"jax"``, and
``is_jittable`` says that the head's calls can be captured into a CUDA
graph (the port's counterpart of tracing into a ``jax.jit``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import gumbel_noise

NEG_INF = -1e30


class MissingScreenError(ValueError):
    """A screening head was requested without a fitted ``ScreenParams``."""


class ScreenBlockError(ValueError):
    """A kernel head was given a screen whose block size it cannot take."""


def require_screen(screen, head_name: str):
    if screen is None:
        raise MissingScreenError(
            f"{head_name} needs a fitted ScreenParams — pass screen= to the "
            f"engine or heads.get (interop.screen_from_numpy converts one "
            f"fitted by the reference's fit_l2s)")
    return screen


def screened_flops_per_query(screen, d: int) -> float:
    """Shared L2S cost model O((r + L̄)·d): routing plus the mean candidate
    matmul, with L̄ the uniform-over-clusters mean candidate words."""
    lbar = float(screen.cand_len.double().mean()) * screen.block
    return float((screen.r + lbar) * d)


def screened_bytes_per_query(screen, d: int, writeback_floats: float = 0.0,
                             itemsize: int = 4) -> float:
    """Shared L2S device-memory traffic model for one decode step: the
    router and the mean candidate weight tiles stream once, O((r + L̄)·d),
    plus ``writeback_floats`` intermediates written back and re-read
    (counted twice)."""
    lbar = float(screen.cand_len.double().mean()) * screen.block
    return float(((screen.r + lbar) * d + 2.0 * writeback_floats) * itemsize)


def tiered_flops_per_query(short_words: int, n_gates: int, p_descend: float,
                           expected_tail_words: float, d: int) -> float:
    """Adaptive-softmax cost model (Grave et al.): every query pays the
    short-list matmul plus the tail gates, O((F + C)·d); the tail cluster
    matmul only when the gate wins, so it enters in expectation under the
    unigram: ``p_descend`` is the unigram mass beyond the short-list and
    ``expected_tail_words`` the unigram-weighted mean tail-cluster width."""
    return float((short_words + n_gates +
                  p_descend * expected_tail_words) * d)


def tiered_bytes_per_query(short_words: int, n_gates: int, p_descend: float,
                           expected_tail_words: float, d: int,
                           writeback_floats: float = 0.0,
                           itemsize: int = 4) -> float:
    """Device-memory twin of ``tiered_flops_per_query``: short-list tiles
    and gates stream once per query, tail tiles in expectation, and
    ``writeback_floats`` intermediates are written back and re-read
    (counted twice) — O(k) results for the fused per-tier kernel, the full
    candidate row for the unfused path."""
    return float(((short_words + n_gates +
                   p_descend * expected_tail_words) * d +
                  2.0 * writeback_floats) * itemsize)


def exact_flops_per_query(L: int, d: int) -> float:
    """Full-vocabulary softmax: one multiply-accumulate per weight."""
    return float(L * d)


def exact_bytes_per_query(L: int, d: int, itemsize: int = 4) -> float:
    """Streams the full (L, d) weight matrix and writes back the L-wide
    logit row for top-k."""
    return float((L * d + 2 * L) * itemsize)


class SoftmaxHead:
    """Base class / protocol for decode heads. Subclasses implement
    ``topk``, ``topk_logprobs`` and ``sample``; ``next`` defaults to
    top-1."""

    name: str = "abstract"
    device_kind: str = "torch"
    is_jittable: bool = True
    supports_sampling: bool = True
    supports_dist: bool = False
    mesh = None

    def prepare(self) -> "SoftmaxHead":
        """One-time packing. Idempotent."""
        return self

    def topk(self, h, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def topk_logprobs(self, h, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def next(self, h) -> torch.Tensor:
        ids, _ = self.topk(h, 1)
        return ids[:, 0].to(torch.int32)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def noise_shape(self, batch: int, temperature: float
                    ) -> Optional[Tuple[int, ...]]:
        """Shape of the standard Gumbel noise ``sample`` draws for ``batch``
        rows at ``temperature`` (None at temperature ≤ 0, which draws
        none). ``sample`` draws exactly this (``noise``); the serving
        engine draws the same uniforms into a static buffer before each
        CUDA graph replay."""
        raise NotImplementedError

    def noise(self, h, temperature: float,
              generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None
              ) -> Optional[torch.Tensor]:
        """The noise ``sample`` adds: ``gumbel`` when given, else a draw of
        ``noise_shape`` from ``generator``."""
        if gumbel is not None:
            return gumbel
        shape = self.noise_shape(h.shape[0], temperature)
        return None if shape is None else gumbel_noise(shape, generator,
                                                       h.device)

    # -- metadata -----------------------------------------------------------
    @property
    def flops_per_query(self) -> float:
        """Analytic MACs per query (paper's hardware-independent cost)."""
        return float("nan")

    @property
    def bytes_per_query(self) -> float:
        """Estimated device-memory bytes one decode-step query moves."""
        return float("nan")

    _MEMORY_ATTRS = ("W", "b", "_Wb", "_bb")

    @property
    def memory_bytes(self) -> int:
        """Resident bytes of the head's serving tables: weights, the packed
        copy where the head keeps one, and the screen's tensors, each
        tensor counted once."""
        tensors = [getattr(self, a, None) for a in self._MEMORY_ATTRS]
        screen = getattr(self, "screen", None)
        if screen is not None:
            tensors += [screen.v, screen.cand_idx, screen.cand_len]
        seen = {id(t): t for t in tensors if isinstance(t, torch.Tensor)}
        return sum(int(t.nbytes) for t in seen.values())

    @property
    def n_shards(self):
        """Vocab shards this head spans: None, no port head is sharded."""
        return None

    def step_key(self) -> tuple:
        """Stable identity for the serving engine's step cache: the head's
        class and name, its underlying tensors by ``id`` (W, b and the
        screen's v, cand_idx, cand_len — a screen moved to the device it is
        on keeps its tensors) and its ``fused`` flag. A transient instance
        over the same tensors hits the hot entry (and its CUDA graphs)
        instead of evicting it; packed copies (``_Wb``, ``_bb``) are left
        out, being made from W and b."""
        parts = [self.name, type(self)]
        parts += [id(getattr(self, a)) for a in ("W", "b") if hasattr(self, a)]
        screen = getattr(self, "screen", None)
        if screen is not None:
            parts += [id(screen.v), id(screen.cand_idx), id(screen.cand_len),
                      screen.block]
        fused = getattr(self, "fused", None)
        if fused is not None:
            parts.append(bool(fused))
        return tuple(parts)

    def describe(self) -> dict:
        """Routing metadata, with the reference's keys: everything a
        ``RoutingPolicy`` may weigh."""
        return {"name": self.name, "device_kind": self.device_kind,
                "is_jittable": self.is_jittable,
                "supports_sampling": self.supports_sampling,
                "supports_dist": self.supports_dist,
                "flops_per_query": self.flops_per_query,
                "bytes_per_query": self.bytes_per_query,
                "memory_bytes": self.memory_bytes,
                "n_shards": self.n_shards}


def adjust_logits(logits: torch.Tensor, temperature: float, top_p: float
                  ) -> torch.Tensor:
    """The temperature / nucleus transform ``sample_from_logits`` draws
    through. Entries already masked to NEG_INF stay exactly NEG_INF.
    Requires temperature > 0."""
    masked = logits <= NEG_INF / 2
    logits = torch.where(masked, NEG_INF, logits / temperature)
    if top_p < 1.0:
        # Mask by sorted RANK, not by value: a `logits >= cutoff` test keeps
        # every position tied with the cutoff logit, which can exceed the
        # nucleus when duplicates exist. A stable descending order breaks
        # ties by lowest index (the top-k convention); rank < k_keep keeps
        # exactly the smallest prefix.
        order = torch.argsort(-logits, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        k_keep = (cum < top_p).sum(dim=-1) + 1       # smallest prefix ≥ top_p
        rank = torch.argsort(order, dim=-1)
        logits = torch.where(rank < k_keep[:, None], logits, NEG_INF)
    return logits


def sample_from_logits(logits: torch.Tensor, temperature: float, top_p: float,
                       gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    """Temperature + nucleus sampling over a (B, C) logit matrix, as a
    Gumbel-max draw: argmax(G + adjusted logits), the form of
    ``jax.random.categorical``, with G the head's ``gumbel`` noise (any
    shape of B·C elements). temperature ≤ 0 degenerates to argmax."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = adjust_logits(logits, temperature, top_p)
    return torch.argmax(gumbel.reshape(logits.shape) + logits,
                        dim=-1).to(torch.int32)
