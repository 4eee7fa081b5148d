"""The system under test and the loop that drives it.

Everything here that touches the program goes through its public entry
points: ``DecodeEngine`` (``serve_batch``) with the routing policy
``CostAwarePolicy``. The benchmark hands the program weights and a screen
it drew itself (``weights.py``).

One client sends ``serve_batch`` jobs back to back. The window closes at
the end of the first block of jobs (``traffic.ClosedJobs``) that ends
after ``seconds``, so that every seed's window holds the same work.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import List

import numpy as np
import torch

from l2sbench import traffic as tr

# keys of a configuration file that are the benchmark's and not sizes of
# the program's ModelConfig
OWN_KEYS = ("name", "source", "port_config", "screen", "reduced", "assumed",
            "not_run")


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: its
    registry entry (``port_config``) with every other key of the file
    applied, a nested group (such as ``ssm`` or ``moe``) key by key over
    the entry's. Raises on a key the ``ModelConfig`` does not have: no
    size of the file goes unrun."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_config"])
    known = {f.name: f for f in fields(base)}
    out = {}
    for key, value in cfg.items():
        if key in OWN_KEYS:
            continue
        if key not in known:
            raise ValueError(f"{cfg['name']}: {key!r} is no size of the "
                             f"program's ModelConfig")
        cur = getattr(base, key)
        if isinstance(value, dict):
            if not is_dataclass(cur):
                raise ValueError(f"{cfg['name']}: {key!r} is no group of "
                                 f"the registry entry {cfg['port_config']}")
            value = replace(cur, **value)
        out[key] = value
    return replace(base, **out)


def build_engine(cfg: dict, params, v, cand, device, max_len: int):
    """A ``DecodeEngine`` over the benchmark's weights and screen; K/V
    caches in the configuration's dtype."""
    from repro_torch.core.screening import ScreenParams
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import DecodeEngine
    K = cand.shape[1]
    screen = ScreenParams(
        v=v, cand_idx=cand,
        cand_len=torch.full((cand.shape[0],), K, dtype=torch.int32,
                            device=v.device),
        vocab_size=int(cfg["vocab_size"]), block=int(cfg["screen"]["block"]))
    return DecodeEngine(Model(port_config(cfg)), params, head="exact",
                        screen=screen, max_len=max_len,
                        cache_dtype=getattr(torch, cfg["dtype"]),
                        device=device)


def program_layout(cfg: dict):
    """The program's parameter tree on the meta device (shapes, dtypes)."""
    from repro_torch.models.model import Model
    return Model(port_config(cfg)).init(None, device="meta")


def policy(mix: dict):
    from repro_torch.serving.router import CostAwarePolicy
    return CostAwarePolicy(mix["heads"])


def serve_request(r: tr.Request, floor: float):
    from repro_torch.serving.request import ServeRequest
    return ServeRequest(prompt=r.prompt, max_new=r.max_new,
                        accuracy_floor=floor)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Job:
    """One job of the window, kept as a few arrays (no object a request:
    the garbage collector never walks the window's requests)."""
    start: float
    end: float
    prompts: np.ndarray          # (n, T) int32
    max_new: np.ndarray          # (n,)
    tokens: np.ndarray           # (n, S) int32, row j valid to lengths[j]
    lengths: np.ndarray          # (n,) tokens served
    heads: tuple                 # (n,) the head each request was served by

    @classmethod
    def of(cls, start: float, end: float, reqs, results) -> "Job":
        lengths = np.array([len(r.tokens) for r in results], np.int64)
        tokens = np.zeros((len(results), int(lengths.max(initial=0))),
                          np.int32)
        for j, r in enumerate(results):
            tokens[j, :lengths[j]] = r.tokens
        return cls(start=start, end=end,
                   prompts=np.stack([r.prompt for r in reqs]),
                   max_new=np.array([r.max_new for r in reqs], np.int64),
                   tokens=tokens, lengths=lengths,
                   heads=tuple(r.head for r in results))


@dataclass
class Record:
    """What the client saw in the window (seconds from its start)."""
    window_s: float
    jobs: List[Job] = field(default_factory=list)


class Profiler:
    """Starts and stops ``torch.profiler`` around part of the window, and
    keeps the traced window's bounds on Kineto's clock (wall-clock ns);
    does nothing when off."""

    def __init__(self, on: bool, start_s: float, seconds: float):
        self.start_s, self.seconds = start_s, seconds
        self.prof = None
        self.t0 = None
        self.window = None                 # Kineto's clock, ns
        self.span = None                   # the window's clock, s
        self.done = not on

    def tick(self, t: float) -> None:
        """Called between units of work at time ``t`` of the window."""
        if self.done:
            return
        if self.prof is None and t >= self.start_s:
            from torch.profiler import ProfilerActivity, profile
            before = time.perf_counter()
            # the device's operations and the CUDA runtime's calls only:
            # recording every host op slows the eager prefill's launches
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self._w0 = time.time_ns()
            # the first start sets up CUPTI, seconds of the window
            self.t0 = t + time.perf_counter() - before
            self.span = (t, float("inf"))
        elif self.prof is not None and t - self.t0 >= self.seconds:
            self.stop(t)

    def stop(self, t: float = float("inf")) -> None:
        """Stop at time ``t`` of the window (the window's end: inf)."""
        if self.prof is not None and not self.done:
            torch.cuda.synchronize()
            self.window = (self._w0, time.time_ns())
            self.span = (self.span[0], t)
            self.prof.stop()
        self.done = True


class ClosedLoop:
    """One client, ``serve_batch`` jobs back to back."""

    def __init__(self, engine, mix: dict, seed: int, vocab: int):
        self.engine = engine
        self.policy = policy(mix)
        self.jobs = tr.ClosedJobs(mix, seed, vocab)
        self.floor = float(mix["accuracy_floor"])

    def warm(self) -> None:
        """Each prompt bucket once (its eager prefill) and one step at the
        job's width (its graph captured)."""
        n = self.jobs.n
        for T in self.jobs.used_buckets():
            reqs = [tr.Request(prompt=np.zeros(T, np.int32), max_new=2)] * n
            self.engine.serve_batch([serve_request(r, self.floor)
                                     for r in reqs], self.policy)
        sync(self.engine.device)

    def run(self, seconds: float, prof: Profiler) -> Record:
        jobs: List[Job] = []
        clock = time.perf_counter
        t0 = clock()
        i = 0
        while True:
            prof.tick(clock() - t0)
            reqs = self.jobs.job(i)
            a = clock() - t0
            res = self.engine.serve_batch([serve_request(r, self.floor)
                                           for r in reqs], self.policy)
            e = clock() - t0
            jobs.append(Job.of(a, e, reqs, res))
            i += 1
            # whole blocks only: every seed's window holds the same jobs
            if e >= seconds and i % len(self.jobs.block) == 0:
                break
        prof.stop()
        return Record(window_s=jobs[-1].end, jobs=jobs)


def head_probe(engine, cfg: dict, mix: dict, head_name: str, seed: int,
               calls: int = 100) -> dict:
    """The benchmark's span around the routed head's ``next(h)``: one
    job's width of contexts from the cell's own model (its hidden state
    after the first job's prompts), the call captured in a CUDA graph as
    the decode step runs it, each replay timed by CUDA events with the L2
    cache flushed before it (256 MB read). → {"ms": mean per call, "h":
    the contexts}."""
    jobs = tr.ClosedJobs(mix, seed, int(cfg["vocab_size"]))
    prompts = np.stack([r.prompt for r in jobs.job(0)])
    head = engine.resolve_head(head_name)
    with torch.inference_mode():
        tok = torch.as_tensor(prompts, dtype=torch.long, device=engine.device)
        h = engine.model.forward(engine.params, {"tokens": tok})[0][:, -1]
        h = h.contiguous()
        flush = torch.empty(64 * 2**20, dtype=torch.float32,
                            device=engine.device)
        side = torch.cuda.Stream(engine.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):               # kernels and buffers loaded
                head.next(h)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            head.next(h)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
        for a, b in ev:
            flush.sum()
            a.record()
            graph.replay()
            b.record()
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ev]
    return {"ms": float(np.mean(ms)), "h": h.detach().clone(),
            "head": head_name}
