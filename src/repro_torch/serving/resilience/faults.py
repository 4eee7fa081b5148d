"""Deterministic fault injection for the serving stack. Twin of
``repro/serving/resilience/faults.py``, kept as the port's own copy.

``FaultInjector`` is the chaos half of the resilience layer: a seeded,
injectable-clock fault source (mirroring the scheduler's ``FakeClock``
test idiom) that the decode streams and the scheduler consult at their
head/kernel/pool/stream boundaries. Armed ``FaultSpec``s can

  * raise typed ``HeadFault`` errors — ``transient`` (retryable: a flaky
    kernel launch, a dropped collective) or ``permanent`` (a lost shard,
    a poisoned head) — at the ``join`` / ``step`` / ``draft`` / ``verify``
    boundaries;
  * CORRUPT head outputs the way approximate heads really degenerate:
    ``nan`` (NaN logits → argmax garbage) and ``sentinel`` (every
    candidate row empty → the −inf / sentinel-id convention);
  * ``stall`` a head's streams (the scheduler skips their tick — what a
    hung device or a wedged collective looks like from the host);
  * ``delay`` ticks by advancing a ``LogicalClock`` (deadline pressure
    without wall time).

Every draw comes from one seeded ``numpy`` Generator, so a given spec
list + seed + call sequence replays the identical fault schedule — the
chaos benchmarks and the property tests depend on this.

The guards (``guard_tokens``) are also the HONEST-failure detectors: they
validate every emitted token id against the vocabulary whether or not an
injector is armed, so a genuinely degenerate head (all-sentinel candidate
rows at runtime) surfaces as a typed ``HeadFault`` the breaker/fallback
machinery can absorb — never as garbage tokens fed back into the decode.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

#: boundaries a FaultSpec may target. "tick" is scheduler-wide (delay
#: faults); the rest are per-head decode boundaries.
SITES = ("join", "step", "draft", "verify", "tick")

#: fault kinds. transient/permanent raise; nan/sentinel corrupt outputs;
#: stall freezes a head's streams; delay advances the logical clock.
KINDS = ("transient", "permanent", "nan", "sentinel", "stall", "delay")


class LogicalClock:
    """Deterministic monotonic clock: ``advance(dt)`` moves time, reads
    optionally auto-advance ``dt_per_read`` (the ``FakeClock`` idiom from
    the scheduler tests, promoted to a library type so fault injection,
    breakers and deadlines share one simulated timeline)."""

    def __init__(self, t0: float = 0.0, dt_per_read: float = 0.0):
        self.t = float(t0)
        self.dt_per_read = float(dt_per_read)

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def __call__(self) -> float:
        self.t += self.dt_per_read
        return self.t


class HeadFault(RuntimeError):
    """Typed failure of one head at one decode boundary.

    ``transient`` failures are retry candidates (bounded backoff);
    non-transient ones re-route immediately. ``kind`` keeps the original
    fault class ("transient" | "permanent" | "corrupt" | "stall") for
    telemetry; ``injected`` distinguishes chaos from honest detection."""

    def __init__(self, head: str, site: str, kind: str, transient: bool,
                 detail: str = "", injected: bool = False):
        super().__init__(
            f"head {head!r} fault at {site}: {kind}"
            + (f" ({detail})" if detail else ""))
        self.head = head
        self.site = site
        self.kind = kind
        self.transient = bool(transient)
        self.injected = bool(injected)


@dataclass
class FaultSpec:
    """One armed fault: fire ``kind`` at ``site`` for ``head`` (None = any
    head) with probability ``rate`` per opportunity, after skipping the
    first ``after`` opportunities, at most ``count`` times total."""

    site: str
    kind: str
    head: Optional[str] = None
    rate: float = 1.0
    count: Optional[int] = None
    after: int = 0
    delay_s: float = 0.0          # "delay" faults: logical seconds per fire

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"FaultSpec.site must be one of {SITES}, "
                             f"got {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"FaultSpec.kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"FaultSpec.rate must be in [0, 1], "
                             f"got {self.rate}")
        self.seen = 0             # opportunities offered
        self.fired = 0            # times actually fired


class FaultInjector:
    """Seeded, deterministic fault source for streams and the scheduler.

    The streams call ``raise_for``/``corrupt`` inside their guarded
    boundaries; the scheduler calls ``stalled``/``on_tick``. All state is
    host-side python — arming an injector never touches a captured step,
    so chaos runs capture exactly the graphs healthy runs capture."""

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0,
                 clock=None):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self.clock = clock
        self._rng = np.random.default_rng(self.seed)
        self.fired: Counter = Counter()          # (site, kind, head) -> n

    def arm(self, site: str, kind: str, head: Optional[str] = None,
            rate: float = 1.0, count: Optional[int] = None, after: int = 0,
            delay_s: float = 0.0) -> FaultSpec:
        spec = FaultSpec(site=site, kind=kind, head=head, rate=rate,
                         count=count, after=after, delay_s=delay_s)
        self.specs.append(spec)
        return spec

    # -- the draw ------------------------------------------------------------
    def _draw(self, site: str, head: Optional[str],
              kinds: Sequence[str]) -> Optional[FaultSpec]:
        """First armed spec matching (site, head, kinds) that fires this
        opportunity. Every matching spec consumes one rng draw whether or
        not it fires, so schedules replay bit-identically."""
        hit = None
        for spec in self.specs:
            if spec.site != site or spec.kind not in kinds:
                continue
            if spec.head is not None and head is not None \
                    and spec.head != head:
                continue
            spec.seen += 1
            if spec.seen <= spec.after:
                continue
            if spec.count is not None and spec.fired >= spec.count:
                continue
            fires = spec.rate >= 1.0 or self._rng.random() < spec.rate
            if fires and hit is None:
                spec.fired += 1
                self.fired[(site, spec.kind, head or "*")] += 1
                hit = spec
        return hit

    # -- boundary hooks ------------------------------------------------------
    def raise_for(self, site: str, head: str) -> None:
        """Error faults at a head boundary: raises ``HeadFault`` when a
        transient/permanent spec fires, else returns."""
        spec = self._draw(site, head, ("transient", "permanent"))
        if spec is not None:
            raise HeadFault(head, site, spec.kind,
                            transient=spec.kind == "transient",
                            detail="injected", injected=True)

    def corrupt(self, site: str, head: str, tokens: np.ndarray) -> np.ndarray:
        """Output-corruption faults: returns ``tokens`` with every row
        poisoned (NaN ids for "nan", the all-sentinel −1 convention for
        "sentinel") when a spec fires, else unchanged."""
        spec = self._draw(site, head, ("nan", "sentinel"))
        if spec is None:
            return tokens
        if spec.kind == "nan":
            return np.full(np.shape(tokens), np.nan, np.float64)
        return np.full(np.shape(tokens), -1, np.int32)

    def stalled(self, head: str) -> bool:
        """Stall faults: True means the scheduler must skip this head's
        streams this tick (the stream makes no progress)."""
        return self._draw("step", head, ("stall",)) is not None

    def on_tick(self) -> float:
        """Tick-delay faults: advances the injector's logical clock (when
        it has an ``advance``) and returns the injected seconds."""
        spec = self._draw("tick", None, ("delay",))
        if spec is None:
            return 0.0
        if self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(spec.delay_s)
        return spec.delay_s

    def telemetry(self) -> dict:
        return {
            "specs": len(self.specs),
            "fired": {f"{s}/{k}/{h}": n
                      for (s, k, h), n in sorted(self.fired.items())},
            "fired_total": sum(self.fired.values()),
        }


# -- output validation (always on, injector or not) ---------------------------

def invalid_token_rows(tokens: np.ndarray, vocab: int,
                       rows: Optional[Sequence[int]] = None) -> List[int]:
    """Row indices of ``tokens`` holding ids no head may legally emit:
    non-finite (NaN logits upstream) or outside [0, vocab) (the sentinel
    id of an all-empty candidate row). ``rows`` restricts the check to
    active slots — idle pad rows legally decode garbage."""
    arr = np.asarray(tokens).reshape(-1)
    if arr.dtype.kind == "f":
        bad = ~np.isfinite(arr) | (arr < 0) | (arr >= vocab)
    else:
        bad = (arr < 0) | (arr >= vocab)
    idx = range(arr.shape[0]) if rows is None else rows
    return [int(i) for i in idx if bad[i]]


def guard_tokens(fault_injector: Optional[FaultInjector], site: str,
                 head: str, tokens, vocab: int,
                 rows: Optional[Sequence[int]] = None) -> np.ndarray:
    """The one token-output guard every stream boundary runs: apply any
    armed error/corruption faults, then validate ids against the
    vocabulary. Returns the (possibly asarray'd) tokens; raises a typed
    ``HeadFault`` on an injected error or on invalid ids — which also
    catches HONEST degeneration (a head whose candidate rows all emptied
    returns sentinel ids) with no injector armed at all.

    ``tokens`` may be a tensor on the card: it is copied to the host once
    (which waits for the step that wrote it) and checked there."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    arr = np.asarray(tokens)
    injected = False
    if fault_injector is not None:
        fault_injector.raise_for(site, head)
        out = fault_injector.corrupt(site, head, arr)
        injected = out is not arr
        arr = out
    bad = invalid_token_rows(arr, vocab, rows)
    if bad:
        raise HeadFault(
            head, site, "corrupt", transient=True, injected=injected,
            detail=f"row(s) {bad} emitted non-finite or out-of-range "
                   f"token ids (vocab {vocab})")
    return arr


__all__ = ["SITES", "KINDS", "LogicalClock", "HeadFault", "FaultSpec",
           "FaultInjector", "invalid_token_rows", "guard_tokens"]
