"""Batched decode engine: prefill → token-by-token generation through a
pluggable ``SoftmaxHead``. Twin of ``repro/serving/engine.py`` (the lstm,
ssm and hybrid families, and ``DecodeStream``; the paged and speculative
streams come with ROADMAP.md Queue 1 item 8).

The head is the ONE seam: greedy decode, temperature/nucleus sampling, and
beam search all route next-token selection through ``head.next`` /
``head.sample`` / ``head.topk_logprobs``. A head is a registry name
("exact", "screened-cuda", "adaptive", "svd", ...) resolved against the
engine's (W, b, screen) context and ``head_kwargs``, or a ready
``SoftmaxHead`` instance, and every public method takes ``head=``
overriding the engine default.

Host heads: a head that cannot be captured (``is_jittable = False``, the
numpy baselines and ``screened-cpu``) runs on the host between replays of
the model's decode step, which stays a graph on the card (``_HostStep``):
``h`` is copied out after the replay, the head picks the token and it is
written back into the slab, as the reference runs its ``_jit_decode`` and a
numpy head. Such a step holds no graph of its own, so
``compiled_step_counts`` reports 0 for its keys, as the reference's does.

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

Continuous batching: ``open_stream(head, width)`` returns a
``DecodeStream`` — a FIXED-width batched decode whose pad slots are live
capacity. ``join`` prefills one request solo and splices its cache rows
into a free slot mid-decode (per-row positions ride the (W,) ``pos`` of the
stream's slab through ``attn_decode``); ``step`` advances every active slot
one token through the same cached steps, as graph replays on the card;
finished slots retire and free their pad slot for the next join. A
stream's slab is its own (``pos`` of shape (W,), and copies of the
recurrent state for rollback), lent by the engine while the stream has an
occupied slot, so generate and serve_batch between its ticks leave it
alone; a slab serves one step (head and step kind) only, so the next
stream of that step and width is lent it and replays the same graphs. The
``repro_torch.serving.scheduler`` subsystem builds its tick loop on
exactly these hooks.
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
from repro_torch.serving.observe.trace import NULL_TRACER
from repro_torch.serving.request import ServeRequest, ServeResult
from repro_torch.serving.resilience.faults import HeadFault, guard_tokens
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


@dataclass(eq=False)
class _Slab:
    """The static buffers every cached step of one batch width B decodes
    in: ``cache`` (the model's decode cache at the engine's ``max_len`` and
    cache dtype), ``tok`` (B,) int32 (the token a step reads and the next
    token it writes), ``pos`` int32 (the position of ``tok``; a step
    advances it), ``src`` (B,) int64 (beam search: the row each beam
    continues, gathered first by a decode step) and ``noise``, the uniform
    draws of sampled steps by shape. Graphs captured on a slab hold it.

    ``key`` names the slab's graphs in a step: the width B for the slab
    ``generate`` and ``beam_search`` share (``pos`` 0-dim), ``(B, n)`` for
    the n-th stream slab (``pos`` (B,), one position per row). A stream
    slab serves one step, ``owner`` (its step-cache key), and has
    ``saved``: copies of the cache's recurrent leaves (the LSTM state; the
    SSM states and conv tails), which every step on it takes first, so a
    step the guard refuses can be undone."""
    cache: dict
    tok: torch.Tensor
    pos: torch.Tensor
    src: torch.Tensor
    key: object
    noise: Dict[tuple, torch.Tensor] = field(default_factory=dict)
    owner: object = None
    saved: Optional[List[torch.Tensor]] = None

    def uniforms(self, shape: tuple) -> torch.Tensor:
        if shape not in self.noise:
            self.noise[shape] = torch.empty(shape, dtype=torch.float32,
                                            device=self.tok.device)
        return self.noise[shape]

    def save(self) -> None:
        """Copy the recurrent leaves into ``saved`` (stream slabs only)."""
        if self.saved is not None:
            for d, s in zip(self.saved, _recurrent_leaves(self.cache)):
                d.copy_(s)

    def restore(self) -> None:
        """Undo the last step's writes that a retry would not repeat: the
        recurrent leaves it overwrote come back from ``saved``. The K/V
        caches need nothing: a step writes only slot ``pos[i]`` of row i,
        nothing reads past a row's own position, and the retry writes the
        same slot with the same values."""
        for d, s in zip(_recurrent_leaves(self.cache), self.saved):
            d.copy_(s)


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
    and on the card its graphs by slab key (``_Slab.key``)."""

    def __init__(self, body: Callable):
        self.body = body
        self.graphs: Dict[object, _Graph] = {}

    def __call__(self, slab: _Slab, stream, pool):
        """Run the step on ``slab``: a replay, or on the first call on this
        slab the body for real on ``stream`` and then its capture
        (``stream`` None, on the CPU: the body)."""
        graph = self.graphs.get(slab.key)
        if graph is not None:
            return graph.replay()
        if stream is None:
            return self.body(slab)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = self.body(slab)
        torch.cuda.current_stream().wait_stream(stream)
        self.graphs[slab.key] = _Graph(self.body, slab, stream, pool)
        return out


class _HostStep:
    """The step-cache entry of a head that cannot be captured
    (``is_jittable = False``, the numpy heads): ``model``, this entry's own
    step of the model's decode alone (a graph replay on the card, its
    output h read before the next replay), then ``head(slab, h)`` run
    eagerly, the head on the host — the reference's ``_jit_decode`` and
    host head. The model's graphs, and the slabs they hold, live and are
    evicted with the entry. It holds no graph of the head, so
    ``compiled_step_counts`` reports 0 for it, as the reference does."""

    def __init__(self, model: _Step, head: Callable):
        self.model = model
        self.head = head
        self.graphs: Dict[object, _Graph] = {}

    def body(self, slab: _Slab):
        return self.head(slab, self.model.body(slab))

    def __call__(self, slab: _Slab, stream, pool):
        return self.head(slab, self.model(slab, stream, pool))


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
        # stream slabs not lent to a stream, by (width, step-cache key)
        # (weak: a graph keeps one alive), and the serial naming the next
        self._free_stream_slabs: Dict[tuple, List[weakref.ref]] = {}
        self._n_stream_slabs = 0
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
    def _cached_step(self, key: tuple, head: SoftmaxHead, kind: str,
                     head_fn: Callable) -> _Step:
        """The entry under ``key``, made on a miss: the model's decode of
        ``kind`` (``_model_body``) and then ``head_fn(slab, h)``, captured
        together for a capturable head, else a ``_HostStep``."""
        if key in self._step_cache:
            self._step_cache.move_to_end(key)       # LRU hit → most recent
        elif head.is_jittable:
            model_body = self._model_body(kind)
            self._put_step(key, _Step(
                lambda slab: head_fn(slab, model_body(slab))))
        else:
            self._put_step(key, _HostStep(_Step(self._model_body(kind)),
                                          head_fn))
        return self._step_cache[key]

    def _model_body(self, kind: str) -> Callable:
        """The model's part of a step → h: ``"advance"`` (greedy and
        sampled), or ``"reorder"`` (beam search: the cache rows gathered by
        ``slab.src`` first)."""
        model, params = self.model, self.params

        def body(slab):
            if kind == "reorder":
                _reorder_cache(slab.cache, slab.src, model.cfg)
            return _advance(model, params, slab)
        return body

    def host_model_graphs(self) -> int:
        """CUDA graphs of the model's decode alone held by the host heads'
        entries of the step cache (one per entry and slab; 0 on the CPU),
        which ``compiled_step_counts`` leaves out, as the reference leaves
        out its ``_jit_decode``."""
        return sum(len(s.model.graphs) for s in self._step_cache.values()
                   if isinstance(s, _HostStep))

    def _put_step(self, key, step: _Step):
        while len(self._step_cache) >= self._step_cache_max:
            self._step_cache.popitem(last=False)    # least-recently-used
        self._step_cache[key] = step

    def _cache_size(self) -> int:
        """Cached steps — at most one per (head, step kind)."""
        return len(self._step_cache)

    def compiled_step_counts(self) -> Dict[tuple, int]:
        """{(head name, step kind): CUDA graphs held} across the step cache:
        one per slab a step ran on on the card, 0 on the CPU — one per
        batch width for ``generate`` / ``beam_search``, and one per stream
        slab for streams. A repeated batch of the same shapes adds none,
        and neither do repeated streams of the same step and width, which
        are lent the slabs (and so the graphs) of the streams before them.
        Two streams of one step and width that hold occupied slots at once
        run on two slabs, and the step holds two graphs."""
        out: Dict[tuple, int] = {}
        for (skey, kind, *_), step in self._step_cache.items():
            k = (skey[0], kind)
            out[k] = out.get(k, 0) + len(step.graphs)
        return out

    @staticmethod
    def _token_step_key(head: SoftmaxHead, temperature: Optional[float],
                        top_p: float) -> tuple:
        """The step-cache key of greedy (``temperature`` None) or sampled
        decoding through ``head``."""
        if temperature is None:
            return (head.step_key(), "greedy")
        return (head.step_key(), "sample", float(temperature), float(top_p))

    def _greedy_step(self, head: SoftmaxHead) -> _Step:
        def head_fn(slab, h):
            slab.tok.copy_(head.next(h))
        return self._cached_step(self._token_step_key(head, None, 1.0), head,
                                 "advance", head_fn)

    def _sample_step(self, head: SoftmaxHead, temperature: float,
                     top_p: float) -> _Step:
        def head_fn(slab, h):
            shape = head.noise_shape(h.shape[0], temperature)
            gumbel = (None if shape is None else
                      ops.gumbel_from_uniform(slab.uniforms(shape)))
            slab.tok.copy_(head.sample(h, temperature, top_p, gumbel=gumbel))
        return self._cached_step(
            self._token_step_key(head, temperature, top_p), head, "advance",
            head_fn)

    def _decode_step(self, head: SoftmaxHead) -> _Step:
        """Beam search's step: the cache rows gathered by ``slab.src``, one
        decode, and the head's top-k log-probs at k = the beam width."""
        return self._cached_step(
            (head.step_key(), "decode"), head, "reorder",
            lambda slab, h: head.topk_logprobs(h, h.shape[0]))

    def _run(self, step: _Step, slab: _Slab):
        return step(slab, self._stream, self._pool)

    # -- prefill --------------------------------------------------------------
    def _new_slab(self, batch: int, key, pos_shape: tuple) -> _Slab:
        dev = self.device
        return _Slab(
            cache=self.model.init_cache(batch, self.max_len,
                                        dtype=self.cache_dtype, device=dev),
            tok=torch.zeros((batch,), dtype=torch.int32, device=dev),
            pos=torch.zeros(pos_shape, dtype=torch.int32, device=dev),
            src=torch.arange(batch, device=dev), key=key)

    def _slab(self, batch: int) -> _Slab:
        """The slab of width ``batch``: the one its graphs hold, else new."""
        slab = self._slabs.get(batch)
        if slab is None:
            slab = self._slabs[batch] = self._new_slab(batch, batch, ())
        return slab

    def _lend_stream_slab(self, width: int, key: tuple) -> _Slab:
        """A slab of ``width`` for one stream of the step under ``key``
        until the stream gives it back (``_return_stream_slab``): a free
        one that served the step before — it holds the step's graph on the
        card — else a new one. A slab serves one step only, so the streams
        of one step never lose their slab (and graph) to another step's.
        Its contents are whatever the last stream left; a join overwrites
        the rows it takes."""
        pool = [s for s in (r() for r in self._free_stream_slabs.get(
            (width, key), ())) if s is not None]
        if pool:
            slab = pool.pop(0)
        else:
            self._n_stream_slabs += 1
            slab = self._new_slab(width, (width, self._n_stream_slabs),
                                  (width,))
            slab.owner = key
            slab.saved = [torch.empty_like(leaf)
                          for leaf in _recurrent_leaves(slab.cache)]
        self._free_stream_slabs[(width, key)] = [weakref.ref(s)
                                                 for s in pool]
        return slab

    def _return_stream_slab(self, slab: _Slab) -> None:
        self._free_stream_slabs.setdefault(
            (slab.tok.shape[0], slab.owner), []).append(weakref.ref(slab))

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

    # -- continuous batching: fixed-width streams ---------------------------
    def open_stream(self, head: Optional[HeadLike] = None, width: int = 4,
                    temperature: Optional[float] = None, top_p: float = 1.0,
                    seed: int = 0) -> "DecodeStream":
        """Open a fixed-width continuous decode stream on this engine.

        The stream shares the engine's cached steps (on the card one graph
        per (head, step kind) and stream slab, captured at the slab's first
        step, replayed after) and its eager prefill. Greedy tokens produced
        through a stream equal solo ``generate`` calls; see
        ``DecodeStream``."""
        name = head if isinstance(head, str) else None
        hd = self.resolve_head(head)
        if name is None:
            name = getattr(hd, "name", "custom")
        return DecodeStream(self, hd, width, temperature=temperature,
                            top_p=top_p, seed=seed, head_name=name)

    def open_paged_stream(self, *args, **kwargs):
        """A stream over a paged KV pool: not ported yet."""
        raise NotImplementedError(
            "repro_torch: paged decode streams (serving/kvpool) are not "
            "ported yet (ROADMAP.md, Queue 1 item 8)")

    def open_spec_stream(self, *args, **kwargs):
        """A speculative decode stream: not ported yet."""
        raise NotImplementedError(
            "repro_torch: speculative decode streams (serving/spec) are not "
            "ported yet (ROADMAP.md, Queue 1 item 8)")


@dataclass
class _StreamSlot:
    """One occupied pad slot of a DecodeStream."""
    tag: object                      # opaque caller handle (scheduler bookkeeping)
    request: ServeRequest
    tokens: list                     # generated ids so far (python ints)
    remaining: int                   # tokens still to decode


class DecodeStream:
    """A fixed-width continuously-batched decode: join-at-step over pad slots.

    The stream keeps per-slot (token, position) state on the host and, while
    any slot is occupied, a width-W slab lent by the engine (its own cache,
    token buffer and (W,) position vector; see ``_Slab``). ``join(request)``
    prefills the request SOLO (B = 1, eagerly, as ``generate`` does),
    computes its first token the way ``generate`` does, and splices the
    prefilled cache rows into a free slot of the slab; ``step()`` writes the
    host tokens and positions into the slab and advances every slot one
    token through the SAME cached step ``generate`` / ``serve_batch`` use —
    a graph replay on the card — with one position per row
    (``attn_decode``'s per-row branch; the LSTM and SSM states ignore
    position). Every row of a batched step is computed on its own, so a
    greedy request's tokens equal a solo ``generate`` call's no matter when
    it joined or who shares the stream; on the card the GEMMs of a width-W
    step may round otherwise than a width-1 step's, so the last bits of a
    hidden state can differ and a near-tied argmax with them.

    Graphs: the width is FIXED at ``width`` — empty slots are padding, so
    join / retire churn never changes a step's shapes. The slab goes back
    to the engine when the last slot empties, and the engine lends it to
    the next stream of the width whose step already holds a graph on it,
    so repeated streams of the same shape add no graph
    (``engine.compiled_step_counts()`` is the audit).

    Guarded steps: the token guard (``guard_tokens``) runs after the step
    on the host. The step has by then written the slab in place (the
    reference computes into new arrays and commits after the guard), so a
    refused step is undone before the fault propagates: the recurrent
    leaves come back from the copy the step took first, the generator's
    state is restored, and ``tok`` / ``pos`` are rewritten from the host
    before every step anyway. A retry is then the identical step, bit for
    bit. A join guards its first token before it touches the slab.

    Sampling: one stream carries ONE sampling static tuple (temperature,
    top_p, seed) — the scheduler keys streams so this holds. The stream
    draws from its own ``torch.Generator`` seeded with ``seed``, exactly as
    ``generate`` does (the first token's draw at the join, then one
    batch-wide draw of uniforms per step), so an isolated width-1 sampled
    stream reproduces solo ``generate``; at width > 1 draws depend on
    stream width and join composition, the same contract ``serve_batch``
    documents for group composition.
    """

    def __init__(self, engine: DecodeEngine, head: SoftmaxHead, width: int,
                 temperature: Optional[float] = None, top_p: float = 1.0,
                 seed: int = 0, head_name: str = "custom"):
        if width < 1:
            raise ValueError(f"stream width must be >= 1: {width}")
        self.engine = engine
        self.head = engine.resolve_head(head)
        self.head_name = head_name
        # resilience hooks: the scheduler arms an injector on streams it
        # opens; the vocab bound backs the always-on output guard (a head
        # emitting sentinel/NaN ids raises a typed HeadFault instead of
        # feeding garbage back into the decode)
        self.fault_injector = None
        # observability: the scheduler arms its tracer here too; kernel
        # spans time the host-side replay+guard window around the cached
        # step (the guard's token copy waits for the card)
        self.tracer = NULL_TRACER
        self.vocab = int(engine.W.shape[0])
        self.width = int(width)
        self.temperature = temperature
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.sampled = temperature is not None
        self._gen = None
        if self.sampled:
            self._gen = torch.Generator(device=engine.device)
            self._gen.manual_seed(self.seed)
        self._slab: Optional[_Slab] = None
        self.tok = np.zeros((self.width,), np.int32)
        self.pos = np.zeros((self.width,), np.int32)
        self.slots: List[Optional[_StreamSlot]] = [None] * self.width
        self._finished: List[tuple] = []

    # -- capacity ------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return self.width - self.n_active

    @property
    def idle(self) -> bool:
        """No occupied slots and no completions waiting to be drained —
        safe for a scheduler to close and replace."""
        return self.n_active == 0 and not self._finished

    @property
    def cache(self) -> Optional[dict]:
        """The slab's decode cache while a slot is occupied, else None."""
        return None if self._slab is None else self._slab.cache

    def occupied(self) -> List[tuple]:
        """[(slot index, tag)] for every occupied slot — what a scheduler
        scans when deciding whom to preempt."""
        return [(i, s.tag) for i, s in enumerate(self.slots) if s is not None]

    def _first_free(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        raise RuntimeError("DecodeStream is full — check free_slots first")

    def _step_entry(self) -> _Step:
        eng = self.engine
        if self.sampled:
            return eng._sample_step(self.head, self.temperature, self.top_p)
        return eng._greedy_step(self.head)

    def _release_if_empty(self) -> None:
        """Give the slab back once no slot is occupied."""
        if self._slab is not None and self.n_active == 0:
            self.engine._return_stream_slab(self._slab)
            self._slab = None

    # -- join: solo prefill + cache splice into a pad slot -------------------
    @torch.inference_mode()
    def join(self, request: ServeRequest, tag: object = None) -> int:
        """Admit one request into a free slot mid-decode. Returns the slot.

        The request's first token comes from its own solo prefill (identical
        to ``generate``'s first-token path); subsequent tokens come from the
        shared batched ``step``. A ``max_new == 1`` request completes here
        and surfaces from the next ``step()``/``pop_finished()``."""
        eng = self.engine
        Tp = int(request.prompt.shape[0])
        if Tp + request.max_new > eng.max_len:
            raise ValueError(
                f"request needs {Tp + request.max_new} cache slots, stream "
                f"max_len is {eng.max_len}")
        slot = self._first_free()
        solo, h_last = eng._prefill(request.prompt[None], request.max_new)
        hd = self.head
        state = None
        if self.sampled:
            state = self._gen.get_state()
            first = hd.sample(h_last, self.temperature, self.top_p,
                              generator=self._gen)
        else:
            first = hd.next(h_last)
        # guard BEFORE any stream state mutates: a join-boundary fault
        # (injected or an honestly degenerate first token) leaves the
        # stream exactly as it was, so the scheduler can retry or re-route
        try:
            first = int(guard_tokens(self.fault_injector, "join",
                                     self.head_name, first,
                                     self.vocab).ravel()[0])
        except HeadFault:
            if state is not None:
                self._gen.set_state(state)
            raise
        entry = _StreamSlot(tag=tag, request=request, tokens=[first],
                            remaining=request.max_new - 1)
        if entry.remaining == 0:
            self._finished.append(
                (entry.tag, entry.request,
                 np.asarray(entry.tokens, np.int32)))
            return slot
        if self._slab is None:
            self._slab = eng._lend_stream_slab(
                self.width, eng._token_step_key(self.head, self.temperature,
                                                self.top_p))
        _splice_cache(self._slab.cache, solo.cache, slot, eng.model.cfg)
        self.tok[slot] = first
        self.pos[slot] = Tp
        self.slots[slot] = entry
        return slot

    # -- step: advance every occupied slot one token -------------------------
    @torch.inference_mode()
    def step(self) -> List[tuple]:
        """One batched decode tick. Returns retired ``(tag, request,
        tokens)`` triples — requests that hit their ``max_new`` this tick
        (plus any that completed at join). Idle slots decode padding that is
        never read and is overwritten by the next join's splice. A
        ``HeadFault`` from the guard leaves the stream as it was before the
        step (completions from joins stay queued for ``pop_finished``)."""
        out = self._finished
        self._finished = []
        idx = [i for i, s in enumerate(self.slots) if s is not None]
        if not idx:
            return out
        eng, slab = self.engine, self._slab
        slab.tok.copy_(torch.from_numpy(self.tok))
        slab.pos.copy_(torch.from_numpy(self.pos))
        state = None
        if self.sampled:
            state = self._gen.get_state()
            shape = self.head.noise_shape(self.width, self.temperature)
            if shape is not None:
                torch.rand(shape, generator=self._gen,
                           out=slab.uniforms(shape))
        tr = self.tracer
        k_t0 = tr.now() if tr.enabled else 0.0
        eng._run(self._step_entry(), slab)
        try:
            nxt = guard_tokens(self.fault_injector, "step", self.head_name,
                               slab.tok, self.vocab, rows=idx)
        except HeadFault:
            slab.restore()
            if state is not None:
                self._gen.set_state(state)
            self._finished = out
            raise
        if tr.enabled:
            tr.span("kernel.step", "kernel", k_t0,
                    args={"head": self.head_name, "active": len(idx)})
        for i in idx:
            s = self.slots[i]
            t = int(nxt[i])
            s.tokens.append(t)
            s.remaining -= 1
            self.tok[i] = t
            self.pos[i] += 1
            if s.remaining == 0:
                out.append((s.tag, s.request,
                            np.asarray(s.tokens, np.int32)))
                self.slots[i] = None
        self._release_if_empty()
        return out

    def pop_finished(self) -> List[tuple]:
        """Drain completions that happened outside ``step`` (max_new == 1
        joins) without advancing the decode."""
        out = self._finished
        self._finished = []
        return out

    # -- evict: preemption hook ----------------------------------------------
    def evict(self, slot: int) -> tuple:
        """Forcibly retire a slot (scheduler preemption). Returns ``(tag,
        request, partial_tokens)``; the slot is free for the next join."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        self._release_if_empty()
        return (s.tag, s.request, np.asarray(s.tokens, np.int32))


def _advance(model: Model, params, slab: _Slab) -> torch.Tensor:
    """``model.decode_step`` of ``slab.tok`` at ``slab.pos``, its cache
    written back into the slab, the position advanced → h (B, d). A stream
    slab first saves its recurrent leaves (``_Slab.save``)."""
    slab.save()
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


def _recurrent_leaves(cache) -> List[torch.Tensor]:
    """The leaves a decode step overwrites whole: the LSTM state, or the
    SSM states and conv tails (not the hybrid's K/V caches)."""
    return tree_leaves(cache["lstm"] if "lstm" in cache else cache["ssm"])


def _splice_cache(group, solo, slot: int, cfg) -> None:
    """Write a solo (B = 1) prefilled cache into row ``slot`` of a width-W
    stream cache, IN PLACE (the reference returns a new cache): the
    stream's graphs hold the addresses of ``group``. Every leaf's whole row
    is copied, the K/V rows past the prompt included. The batch axis is
    ``_reorder_cache``'s: 0 for the LSTM state, 1 for the stacked SSM /
    attention caches."""
    axis = 0 if cfg.family == "lstm" else 1
    for g, s in zip(tree_leaves(group), tree_leaves(solo)):
        g.select(axis, slot).copy_(s.select(axis, 0))


def _reorder_cache(cache, src_idx, cfg):
    """Gather beam rows IN PLACE (the reference returns a new cache): each
    leaf is gathered into a new tensor and copied back, so a graph that
    captures it writes its static buffers. LSTM state lists carry batch at
    axis 0; the stacked SSM / attention caches at axis 1. → ``cache``."""
    axis = 0 if cfg.family == "lstm" else 1
    for leaf in tree_leaves(cache):
        leaf.copy_(leaf.index_select(axis, src_idx))
    return cache
