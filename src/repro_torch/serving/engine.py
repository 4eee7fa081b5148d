"""Batched decode engine: prefill → token-by-token generation through a
pluggable ``SoftmaxHead``. Twin of ``repro/serving/engine.py`` (the lstm,
ssm and hybrid families; ``DecodeStream`` and the scheduler come later).

The head is the ONE seam: greedy decode, temperature/nucleus sampling, and
beam search all route next-token selection through ``head.next`` /
``head.sample`` / ``head.topk_logprobs``. A head is a registry name
("exact", "screened", "screened-cuda") resolved against the engine's
(W, b, screen) context, or a ready ``SoftmaxHead`` instance, and every
public method takes ``head=`` overriding the engine default.

Step cache, the twin of the reference's LRU of jitted steps: at most 32
cached steps, keyed by ``head.step_key()`` and the step kind —
``(key, "greedy")``, ``(key, "sample", temperature, top_p)`` and
``(key, "decode")``, beam search's decode composed with
``head.topk_logprobs`` at k = the beam width. On the card an entry holds
one captured ``torch.cuda.CUDAGraph`` per batch width, as a jit holds one
executable per shape, and ``compiled_step_counts`` counts them. A graph
replays ``model.decode_step`` and the head's call on static buffers (a
``_Slab``: token, 0-dim device position, cache): it writes the next token
into the token buffer and advances the position itself, so a step of
``generate`` is one ``replay()`` and one small copy of the token into the
output. The slab of a batch width is shared by every entry (heads never
replay at once; a zamba2-2.7b cache at B = 4, S = 640 holds 472 MB of K/V)
and lives as long as a graph at that width: each graph holds its slab and
the engine only a weak reference, so the LRU's eviction of the last graph
of a width frees its slab, and on the CPU, with no graph, a slab lives for
one call. The engine's graphs also share one memory pool. The prefill stays eager —
a graph per prompt length, run once per call — and writes into the slab's
cache.

A step is captured at its first use at a width. Its body first runs for
real on the engine's capture stream — that is the step the caller asked
for, and it loads the kernels and makes their per-stream buffers outside
any capture — and is then captured. Nothing turns the graphs off, and a
capture that fails raises. On the CPU an entry runs its body eagerly and
holds no graph; ``compiled_step_counts`` then reports 0 per key, as the
reference does for a head that is not jittable. Sampled steps draw their
uniforms from the caller's ``torch.Generator`` into a static buffer before
each replay, in ``head.noise_shape``, the shape ``head.sample`` draws
itself, and the graph turns them into Gumbel noise, so graph-sampled tokens
equal the eager ones bit for bit.

Request-centric serving: ``serve_batch(requests, policy=...)`` takes
``ServeRequest``s (``serving/request.py``), resolves each to a head name
through a ``RoutingPolicy`` (``serving/router.py``), groups requests by
(resolved head, prompt length, sampling statics) and runs each group as
one batched ``generate`` over the same cached steps, so a repeated mixed
batch adds no graph.

Beam search follows the paper's §4.2 protocol: log-softmax over the head's
reduced candidate space, probability 0 (−inf log-prob) elsewhere.
"""
from __future__ import annotations

import gc
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import heads as heads_registry
from repro_torch.core.screening import ScreenParams
from repro_torch.device import resolve_device
from repro_torch.heads.base import (MissingScreenError, ScreenBlockError,
                                    SoftmaxHead)
from repro_torch.kernels import ops
from repro_torch.models.model import Model, to_device
from repro_torch.serving.request import ServeRequest, ServeResult
from repro_torch.tree import tree_leaves

HeadLike = Union[str, SoftmaxHead]

# serve_batch sentinel: "route to the engine's default head instance" —
# never a valid registry name, never resolved through the registry
_ENGINE_DEFAULT = "__engine-default__"


@dataclass
class GenerationResult:
    tokens: np.ndarray              # (B, T_new) generated ids
    scores: Optional[np.ndarray] = None
    steps: int = 0


@dataclass
class _Slab:
    """The static buffers every cached step of one batch width B decodes
    in: ``cache`` (the model's decode cache at the engine's ``max_len`` and
    cache dtype), ``tok`` (B,) int32 (the token a step reads and the next
    token it writes), ``pos`` () int32 (the position of ``tok``; a step
    advances it), ``src`` (B,) int64 (beam search: the row each beam
    continues, gathered first by a decode step) and ``noise``, the uniform
    draws of sampled steps by shape. Graphs captured on a slab hold it."""
    cache: dict
    tok: torch.Tensor
    pos: torch.Tensor
    src: torch.Tensor
    noise: Dict[tuple, torch.Tensor] = field(default_factory=dict)

    def uniforms(self, shape: tuple) -> torch.Tensor:
        if shape not in self.noise:
            self.noise[shape] = torch.empty(shape, dtype=torch.float32,
                                            device=self.tok.device)
        return self.noise[shape]


class _Graph:
    """A step body captured at one batch width on ``stream``, into the
    engine's memory ``pool``. A replay calls no kernel wrapper, so it adds
    the launches the capture recorded to ``ops.LAUNCHES`` itself; the
    capture's own count is taken back out (capturing launches nothing).

    The engine's graphs share one pool: a later capture may reuse memory
    an earlier graph uses only while it runs, which is safe because graphs
    never replay at once and each replay's outputs are read before the next
    replay. The cyclic garbage collector is off during a capture, since
    freeing another CUDA graph then would invalidate it."""

    def __init__(self, body: Callable, slab: _Slab, stream, pool):
        self.slab = slab                    # the addresses the graph holds
        self.graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.outputs = body(slab)
        finally:
            if collecting:
                gc.enable()
            self.launches = {k: ops.LAUNCHES[k] - n for k, n in before.items()
                             if ops.LAUNCHES[k] != n}
            ops.LAUNCHES.update(before)

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n
        return self.outputs


class _Step:
    """One step-cache entry: the step's body, ``body(slab) -> outputs``,
    and on the card its graphs by batch width."""

    def __init__(self, body: Callable):
        self.body = body
        self.graphs: Dict[int, _Graph] = {}

    def __call__(self, slab: _Slab, stream, pool):
        """Run the step on ``slab``: a replay, or on the first call at this
        width the body for real on ``stream`` and then its capture
        (``stream`` None, on the CPU: the body)."""
        width = slab.tok.shape[0]
        graph = self.graphs.get(width)
        if graph is not None:
            return graph.replay()
        if stream is None:
            return self.body(slab)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = self.body(slab)
        torch.cuda.current_stream().wait_stream(stream)
        self.graphs[width] = _Graph(self.body, slab, stream, pool)
        return out


class DecodeEngine:
    def __init__(self, model: Model, params, head: HeadLike = "exact",
                 screen: Optional[ScreenParams] = None, max_len: int = 512,
                 cache_dtype=torch.float32, head_kwargs: Optional[dict] = None,
                 device="cuda"):
        """``head``: default decode head — a registry name or an instance.
        ``screen``: L2S screen handed to screening heads resolved by name.
        ``max_len``: cache slots per row (prompt + generated tokens), which
        bounds a hybrid decode; the LSTM and SSM states do not grow.
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
        # bounded LRU of steps keyed by head.step_key(): a transient
        # instance over the same tensors hits the hot entry; the
        # least-recently-USED entry is evicted with its graphs
        self._step_cache: "OrderedDict[tuple, _Step]" = OrderedDict()
        self._step_cache_max = 32
        # {batch width: _Slab}, alive while a graph (or a call) holds it
        self._slabs: "weakref.WeakValueDictionary[int, _Slab]" = \
            weakref.WeakValueDictionary()
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
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

    # -- step cache -----------------------------------------------------------
    def _cached_step(self, key: tuple, body: Callable) -> _Step:
        """The entry under ``key``, made around ``body`` on a miss."""
        if key in self._step_cache:
            self._step_cache.move_to_end(key)       # LRU hit → most recent
        else:
            self._put_step(key, _Step(body))
        return self._step_cache[key]

    def _put_step(self, key, step: _Step):
        while len(self._step_cache) >= self._step_cache_max:
            self._step_cache.popitem(last=False)    # least-recently-used
        self._step_cache[key] = step

    def _cache_size(self) -> int:
        """Cached steps — at most one per (head, step kind)."""
        return len(self._step_cache)

    def compiled_step_counts(self) -> Dict[tuple, int]:
        """{(head name, step kind): CUDA graphs held} across the step cache:
        one per batch width a step ran at on the card, 0 on the CPU. A
        repeated batch of the same shapes adds none."""
        out: Dict[tuple, int] = {}
        for (skey, kind, *_), step in self._step_cache.items():
            k = (skey[0], kind)
            out[k] = out.get(k, 0) + len(step.graphs)
        return out

    def _greedy_step(self, head: SoftmaxHead) -> _Step:
        model, params = self.model, self.params

        def body(slab):
            slab.tok.copy_(head.next(_advance(model, params, slab)))
        return self._cached_step((head.step_key(), "greedy"), body)

    def _sample_step(self, head: SoftmaxHead, temperature: float,
                     top_p: float) -> _Step:
        model, params = self.model, self.params

        def body(slab):
            h = _advance(model, params, slab)
            shape = head.noise_shape(h.shape[0], temperature)
            gumbel = (None if shape is None else
                      ops.gumbel_from_uniform(slab.uniforms(shape)))
            slab.tok.copy_(head.sample(h, temperature, top_p, gumbel=gumbel))
        key = (head.step_key(), "sample", float(temperature), float(top_p))
        return self._cached_step(key, body)

    def _decode_step(self, head: SoftmaxHead) -> _Step:
        """Beam search's step: the cache rows gathered by ``slab.src``, one
        decode, and the head's top-k log-probs at k = the beam width."""
        model, params = self.model, self.params

        def body(slab):
            _reorder_cache(slab.cache, slab.src, model.cfg)
            h = _advance(model, params, slab)
            return head.topk_logprobs(h, h.shape[0])
        return self._cached_step((head.step_key(), "decode"), body)

    def _run(self, step: _Step, slab: _Slab):
        return step(slab, self._stream, self._pool)

    # -- prefill --------------------------------------------------------------
    def _slab(self, batch: int) -> _Slab:
        """The slab of width ``batch``: the one its graphs hold, else new."""
        slab = self._slabs.get(batch)
        if slab is None:
            dev = self.device
            slab = self._slabs[batch] = _Slab(
                cache=self.model.init_cache(batch, self.max_len,
                                            dtype=self.cache_dtype,
                                            device=dev),
                tok=torch.zeros((batch,), dtype=torch.int32, device=dev),
                pos=torch.zeros((), dtype=torch.int32, device=dev),
                src=torch.arange(batch, device=dev))
        return slab

    def _prefill(self, prompts, max_new: int) -> tuple:
        """prompts (B, Tp) → (the slab of width B, its cache primed by the
        prompt and its position at Tp, h_last (B, d)). Raises if the hybrid
        family's K/V cache of ``max_len`` slots cannot hold the prompt and
        ``max_new`` tokens; the LSTM and SSM states do not grow, and decode
        past ``max_len`` as the reference does. The prefill runs eagerly."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                 device=self.device)
        B, Tp = tokens.shape
        if self.model.cfg.family == "hybrid" and Tp + max_new > self.max_len:
            raise ValueError(f"a prompt of {Tp} tokens and {max_new} new ones "
                             f"need {Tp + max_new} cache slots; max_len is "
                             f"{self.max_len}")
        slab = self._slab(B)
        for leaf in tree_leaves(slab.cache):
            leaf.zero_()
        h, cache = self.model.prefill(self.params, {"tokens": tokens},
                                      slab.cache)
        _write_back(slab.cache, cache)
        slab.pos.fill_(Tp)
        return slab, h[:, -1].contiguous()

    # -- generation (greedy or sampled, head-routed) -------------------------
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int,
                 head: Optional[HeadLike] = None,
                 temperature: Optional[float] = None, top_p: float = 1.0,
                 seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """prompts: (B, Tp) int. Decode ``max_new`` tokens: the first from
        the prefill's last hidden state, each next one by a cached step.

        ``temperature=None`` (default) is greedy; otherwise temperature /
        nucleus sampling through ``head.sample``, with noise from
        ``generator`` (a ``torch.Generator`` on the engine's device) or from
        a new one seeded with ``seed`` — one of them is required unless
        temperature ≤ 0."""
        return self._generate(prompts, max_new, self.resolve_head(head),
                              temperature, top_p, seed, generator, self._run)

    def _generate(self, prompts, max_new, hd, temperature, top_p, seed,
                  generator, run) -> GenerationResult:
        """``generate``'s loop, each step through ``run(step, slab)``."""
        slab, h_last = self._prefill(prompts, max_new)
        B = h_last.shape[0]
        shape = None
        if temperature is None:
            step = self._greedy_step(hd)
            first = hd.next(h_last)
        else:
            if generator is None:
                if seed is None and temperature > 0:
                    raise ValueError("sampling with temperature > 0 needs a "
                                     "seed= or a generator=")
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0 if seed is None else int(seed))
            step = self._sample_step(hd, temperature, top_p)
            shape = hd.noise_shape(B, temperature)
            first = hd.sample(h_last, temperature, top_p, generator=generator)
        slab.tok.copy_(first)
        out = torch.empty((B, max_new), dtype=torch.int32, device=self.device)
        out[:, 0].copy_(first)
        for i in range(1, max_new):
            if shape is not None:
                torch.rand(shape, generator=generator,
                           out=slab.uniforms(shape))
            run(step, slab)
            out[:, i].copy_(slab.tok)
        return GenerationResult(tokens=out.cpu().numpy(), steps=max_new)

    # -- beam search (batch of 1 prompt, beam B_w) ---------------------------
    @torch.inference_mode()
    def beam_search(self, prompt: np.ndarray, beam: int, max_new: int,
                    head: Optional[HeadLike] = None) -> GenerationResult:
        """prompt: (Tp,) int. Returns the top beam's tokens and score.

        ``head.topk_logprobs`` supplies the per-step (ids, log-probs): the
        first step's eagerly from the prefill (which stays eager, as in
        ``generate``), every later one from the cached ``"decode"`` step,
        which also gathers the cache rows of the surviving beams in place."""
        return self._beam_search(prompt, beam, max_new,
                                 self.resolve_head(head), self._run)

    def _beam_search(self, prompt, beam, max_new, hd, run
                     ) -> GenerationResult:
        """``beam_search``'s loop, each step through ``run(step, slab)``."""
        prompts = np.broadcast_to(np.asarray(prompt)[None],
                                  (beam, len(prompt))).copy()
        slab, h_last = self._prefill(prompts, max_new)
        ids, lps = hd.topk_logprobs(h_last[:1], beam)      # expand from beam 0
        ids, lps = ids.cpu().numpy(), lps.cpu().numpy()
        beam_tokens = [[int(ids[0, j])] for j in range(beam)]
        beam_scores = np.asarray(lps[0], np.float64).copy()
        slab.tok.copy_(torch.as_tensor(ids[0]))
        slab.src.copy_(torch.arange(beam))
        step = self._decode_step(hd)

        for i in range(max_new - 1):
            ids, lps = run(step, slab)                     # (beam, beam)
            ids = ids.cpu().numpy()
            total = beam_scores[:, None] + lps.cpu().numpy().astype(np.float64)
            flat = total.reshape(-1)
            top = np.argsort(-flat)[:beam]
            src, choice = np.unravel_index(top, total.shape)
            beam_tokens = [beam_tokens[s] + [int(ids[s, c])]
                           for s, c in zip(src, choice)]
            beam_scores = flat[top]
            slab.tok.copy_(torch.as_tensor(ids[src, choice]))
            slab.src.copy_(torch.as_tensor(src))          # rows to follow

        best = int(np.argmax(beam_scores))
        return GenerationResult(tokens=np.asarray(beam_tokens[best])[None],
                                scores=beam_scores[best:best + 1],
                                steps=max_new)

    # -- request-centric serving ---------------------------------------------
    def head_catalog(self, names: Sequence[str]) -> Dict[str, dict]:
        """{name: head.describe()} for every resolvable name — the metadata
        routing policies weigh. Names whose head cannot be built in THIS
        engine — a screening head with no fitted screen
        (``MissingScreenError``), or a kernel head whose screen has the
        wrong block size (``ScreenBlockError``) — are omitted, so a policy
        listing them simply never routes there; unknown registry names
        still raise KeyError."""
        catalog = {}
        for name in dict.fromkeys(names):
            try:
                catalog[name] = self.resolve_head(name).describe()
            except (MissingScreenError, ScreenBlockError):
                continue
        return catalog

    def serve_batch(self, requests: Sequence[ServeRequest],
                    policy=None) -> List[ServeResult]:
        """Serve a mixed batch of ``ServeRequest``s through routed heads.

        Each request resolves to a head name — its explicit ``head`` field,
        else ``policy.route`` over ``head_catalog(policy.candidates)``;
        ``policy=None`` keeps everything on the engine's default head.
        Requests sharing (head, prompt length, sampling statics) run as ONE
        batched ``generate`` padded to the group's longest ``max_new``,
        through the same cached steps and graphs — a repeated mixed batch
        adds no graph. Results come back in request order; greedy results
        are bit-identical to solo ``generate`` calls (see
        ``serving/request.py`` for the sampling determinism contract)."""
        from repro_torch.serving.router import StaticPolicy, route_requests
        requests = list(requests)
        if not requests:
            return []
        # policy=None serves through the engine's default head INSTANCE (a
        # custom instance may not be re-resolvable by name); the sentinel
        # groups those requests together and maps back to self.head below
        if policy is None:
            policy = StaticPolicy(_ENGINE_DEFAULT)
        catalog = self.head_catalog(
            tuple(n for n in getattr(policy, "candidates", ())
                  if n != _ENGINE_DEFAULT))
        names = route_requests(requests, policy, catalog)

        groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, (req, name) in enumerate(zip(requests, names)):
            groups.setdefault(req.group_key(name), []).append(i)

        results: List[Optional[ServeResult]] = [None] * len(requests)
        for key, idxs in groups.items():
            name = key[0]
            head = self.head if name == _ENGINE_DEFAULT else name
            reqs = [requests[i] for i in idxs]
            prompts = np.stack([r.prompt for r in reqs])
            max_new = max(r.max_new for r in reqs)
            proto = reqs[0]                  # sampling statics shared by key
            if proto.sampled:
                out = self.generate(prompts, max_new, head=head,
                                    temperature=proto.temperature,
                                    top_p=proto.top_p, seed=proto.seed)
            else:
                out = self.generate(prompts, max_new, head=head)
            served = getattr(self.head, "name", _ENGINE_DEFAULT) \
                if name == _ENGINE_DEFAULT else name
            for row, i in enumerate(idxs):
                results[i] = ServeResult(
                    tokens=out.tokens[row, :requests[i].max_new],
                    head=served, request=requests[i], group_size=len(idxs))
        return results


def _advance(model: Model, params, slab: _Slab) -> torch.Tensor:
    """``model.decode_step`` of ``slab.tok`` at ``slab.pos``, its cache
    written back into the slab, the position advanced → h (B, d)."""
    h, cache = model.decode_step(params, slab.tok, slab.cache, slab.pos)
    _write_back(slab.cache, cache)
    slab.pos.add_(1)
    return h


def _write_back(dst, src) -> None:
    """Copy each leaf of ``src`` into the same leaf of ``dst`` unless it is
    that leaf (the LSTM returns a new state; the SSM and hybrid caches are
    written in place)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def _reorder_cache(cache, src_idx, cfg):
    """Gather beam rows IN PLACE (the reference returns a new cache): each
    leaf is gathered into a new tensor and copied back, so a graph that
    captures it writes its static buffers. LSTM state lists carry batch at
    axis 0; the stacked SSM / attention caches at axis 1. → ``cache``."""
    axis = 0 if cfg.family == "lstm" else 1
    for leaf in tree_leaves(cache):
        leaf.copy_(leaf.index_select(axis, src_idx))
    return cache
