"""Request-centric serving types: what a caller ASKS FOR, not how it runs.
Twin of ``repro/serving/request.py``, kept as the port's own copy.

``ServeRequest`` carries the per-request signal the routing layer needs —
the query's k, latency tier, accuracy tolerance, sampling parameters — so
one engine can serve mixed traffic: big-vocab / memory-pressured requests
ride a sharded head while small ones stay on single-device heads. The old
"array in, array out" ``DecodeEngine.generate`` survives as the low-level
primitive underneath ``serve_batch``.

Determinism contract: greedy requests (``temperature is None``) are
bit-identical to a solo ``engine.generate(prompt[None], max_new, head=...)``
call. Sampled requests are deterministic given (seed, group composition) — the
group's ``torch.Generator``, seeded with ``seed``, draws one noise tensor per
batch, so a request's draws legitimately depend on which requests it was
batched with; requests with distinct seeds are never batched together.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ServeRequest:
    """One decode request plus the routing signal attached to it.

    ``prompt``         (Tp,) int32 token ids.
    ``max_new``        tokens to generate.
    ``k``              how many candidates the caller ultimately wants per
                       step (beam width / n-best); a routing signal — large
                       k favors heads whose candidate sets are wide.
    ``temperature``    None → greedy; else temperature sampling.
    ``top_p``          nucleus mass (sampling only).
    ``seed``           per-request seed of the ``torch.Generator`` its
                       group samples from (sampling only).
    ``latency_tier``   "realtime" | "standard" | "batch" — how long the
                       caller is willing to wait.
    ``accuracy_floor`` minimum acceptable decode fidelity in [0, 1]; 1.0
                       demands exact-softmax heads, 0.0 accepts anything.
    ``head``           explicit registry head name — set, it OVERRIDES the
                       policy (escape hatch; policies never see it).
    ``timeout_s``      per-request wall budget on the scheduler's clock,
                       submission to last token; None (default) = no
                       timeout. Expired requests terminate as a typed
                       ``AdmissionRejected(stage="timeout")`` carrying the
                       partial decode — independent of the latency tier's
                       deadline, which is a PREEMPTION signal.

    The reference's ``draft_head`` and ``draft_len`` (speculative decoding)
    come with the spec layer (ROADMAP.md, Queue 1 item 8).
    """

    prompt: np.ndarray
    max_new: int
    k: int = 1
    temperature: Optional[float] = None
    top_p: float = 1.0
    seed: int = 0
    latency_tier: str = "standard"
    accuracy_floor: float = 0.0
    head: Optional[str] = None
    timeout_s: Optional[float] = None

    def __post_init__(self):
        # validate EVERYTHING the decode loop consumes up front: a bad k or
        # top_p otherwise only surfaces as a shape/NaN failure deep inside a
        # captured step, long after the request was accepted
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1:
            raise ValueError(f"ServeRequest.prompt must be 1-D (Tp,), got "
                             f"shape {self.prompt.shape}")
        if self.max_new < 1:
            raise ValueError(
                f"ServeRequest.max_new must be >= 1, got {self.max_new}")
        if self.k < 1:
            raise ValueError(f"ServeRequest.k must be >= 1, got {self.k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"ServeRequest.top_p must be in (0, 1], got "
                             f"{self.top_p}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(
                f"ServeRequest.timeout_s must be > 0 or None, got "
                f"{self.timeout_s}")

    @property
    def sampled(self) -> bool:
        return self.temperature is not None

    def sampling_key(self) -> tuple:
        """The sampling statics ONE cached step (and one continuous decode
        stream) can carry: ``("greedy",)`` or ``("sample", temperature,
        top_p, seed)``. Shared by ``group_key`` and the scheduler's stream
        signatures so the two batching layers can never drift."""
        if not self.sampled:
            return ("greedy",)
        return ("sample", float(self.temperature), float(self.top_p),
                int(self.seed))

    def group_key(self, head_name: str) -> tuple:
        """Requests sharing this key run as ONE padded batched decode: same
        resolved head, same prompt length (prefill shape), and the same
        sampling statics (temperature / top_p are baked into the engine's
        cached sample step; the seed keeps draws per-request
        deterministic)."""
        return (head_name, int(self.prompt.shape[0])) + self.sampling_key()


@dataclass
class ServeResult:
    """Tokens for one request, in the order the requests were submitted.

    ``tokens`` is (max_new,) int32 — trimmed back to the REQUEST's max_new
    when its group was padded to a longer decode. ``head`` is the registry
    name the router resolved; ``group_size`` how many requests shared the
    batched decode step (1 = ran alone)."""

    tokens: np.ndarray
    head: str
    request: ServeRequest = field(repr=False)
    group_size: int = 1
