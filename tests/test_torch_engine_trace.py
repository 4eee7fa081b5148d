"""The engine's spans on the CPU: ``DecodeEngine.tracer`` and the lane
``ENGINE_TID``, and ``observe.trace.PROCESS_TRACER``, which takes the spans
on the torch profiler's clock while a profile runs.

Model: ``ptb-small-lstm`` reduced, random weights, the ``exact`` head; two
prompt lengths make two groups of ``serve_batch``, each padded to its
longest ``max_new``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import DecodeEngine, ServeRequest, Tracer
from repro_torch.serving.observe import (ENGINE_TID, NULL_TRACER,
                                         PROCESS_TRACER, active)

# (prompt length, the max_new of each request): one group a length
GROUPS = ((5, (3, 6, 4)), (8, (2, 5)))
NS = 1_000_000_000


def _engine():
    model = Model(get_config("ptb-small-lstm").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return DecodeEngine(model, params, head="exact", max_len=32,
                        device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [ServeRequest(prompt=rng.integers(0, vocab, T).astype(np.int32),
                         max_new=n)
            for T, news in GROUPS for n in news]


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _named(events, name):
    return [e for e in events if e["name"] == name]


def _serve(engine, tracer):
    engine.tracer = tracer
    try:
        return engine.serve_batch(_requests(engine.model.cfg.vocab_size))
    finally:
        engine.tracer = NULL_TRACER


def test_untraced_serve_batch_records_nothing(engine):
    PROCESS_TRACER.clear()
    assert active(engine.tracer) is NULL_TRACER
    out = _serve(engine, NULL_TRACER)
    assert [len(r.tokens) for r in out] == [n for _, ns in GROUPS for n in ns]
    assert PROCESS_TRACER.emitted == 0


def test_active_picks_the_tracer():
    armed = Tracer()
    assert active(armed) is armed
    assert active(NULL_TRACER) is NULL_TRACER
    with profile(activities=[ProfilerActivity.CPU]):
        assert active(NULL_TRACER) is PROCESS_TRACER
        assert active(armed) is armed
    assert active(NULL_TRACER) is NULL_TRACER


def test_armed_tracer_spans_nest_and_count_padding(engine):
    PROCESS_TRACER.clear()
    tr = Tracer()
    out = _serve(engine, tr)
    ev = tr.events()
    assert PROCESS_TRACER.emitted == 0 and tr.dropped == 0
    assert {e["tid"] for e in ev} == {ENGINE_TID}
    assert {e["cat"] for e in ev} == {"engine"}
    (root,) = _named(ev, "serve_batch")
    job = root["args"]["job"]
    assert root["args"] == {"job": job, "requests": 5, "groups": 2}
    (route,) = _named(ev, "serve.route")
    (results,) = _named(ev, "serve.results")
    gens = sorted(_named(ev, "engine.generate"), key=lambda e: e["ts"])
    assert len(gens) == 2
    assert _within(route, root) and _within(results, root)
    assert route["ts"] + route["dur"] <= gens[0]["ts"]
    assert gens[-1]["ts"] + gens[-1]["dur"] <= results["ts"]
    inner = {"engine.prefill", "engine.first", "engine.step",
             "engine.capture", "engine.readback"}
    for g, (T, news) in zip(gens, GROUPS):
        assert _within(g, root)
        assert g["args"] == {"job": job, "head": "exact", "rows": len(news),
                             "steps": max(news), "kept": sum(news)}
        kids = sorted((e for e in ev if e["name"] in inner and _within(e, g)),
                      key=lambda e: e["ts"])
        names = [e["name"] for e in kids]
        # the CPU holds no graph: no step captures
        assert names == (["engine.prefill", "engine.first"]
                         + ["engine.step"] * (max(news) - 1)
                         + ["engine.readback"])
        assert kids[0]["args"] == {"rows": len(news), "prompt": T}
        for a, b in zip(kids, kids[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
    # every span of the call lies in the root
    assert all(_within(e, root) for e in ev)
    kept = sum(g["args"]["kept"] for g in gens)
    decoded = sum(g["args"]["rows"] * g["args"]["steps"] for g in gens)
    assert kept == sum(len(r.tokens) for r in out) == 20
    assert decoded == 3 * 6 + 2 * 5


def test_generate_alone_is_a_job_of_its_own(engine):
    tr = Tracer()
    engine.tracer = tr
    try:
        engine.generate(np.zeros((3, 4), np.int32), 4)
        engine.generate(np.zeros((2, 4), np.int32), 2)
    finally:
        engine.tracer = NULL_TRACER
    gens = _named(tr.events(), "engine.generate")
    assert [g["args"]["rows"] * g["args"]["steps"] for g in gens] == [12, 4]
    assert [g["args"]["kept"] for g in gens] == [12, 4]
    assert gens[0]["args"]["job"] != gens[1]["args"]["job"]
    assert not _named(tr.events(), "serve_batch")
    assert len(_named(tr.events(), "engine.step")) == 3 + 1


def test_a_step_that_captures_is_a_capture_span():
    engine = _engine()

    def run(step, slab):
        # stands in for the card's first run of a step at a width, which
        # captures its graph under the slab's key
        step.graphs.setdefault(slab.key, None)
        return step.body(slab)

    tr = Tracer()
    engine.tracer = tr
    prompts = np.zeros((2, 3), np.int32)
    hd = engine.resolve_head("exact")
    with torch.inference_mode():
        engine._generate(prompts, 4, hd, None, 1.0, None, None, run)
        first = [e["name"] for e in tr.events()
                 if e["name"] in ("engine.step", "engine.capture")]
        tr.clear()
        engine._generate(prompts, 4, hd, None, 1.0, None, None, run)
    again = [e["name"] for e in tr.events()
             if e["name"] in ("engine.step", "engine.capture")]
    assert first == ["engine.capture", "engine.step", "engine.step"]
    assert again == ["engine.step"] * 3


def test_profiler_puts_spans_on_its_clock(engine):
    PROCESS_TRACER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(engine, NULL_TRACER)
    assert active(engine.tracer) is NULL_TRACER
    ev = PROCESS_TRACER.events()
    PROCESS_TRACER.clear()
    assert PROCESS_TRACER.dropped == 0
    assert len(_named(ev, "serve_batch")) == 1
    assert len(_named(ev, "engine.generate")) == 2
    pre = [(round(e["ts"] * NS), round((e["ts"] + e["dur"]) * NS))
           for e in _named(ev, "engine.prefill")]
    assert len(pre) == 2
    # the LSTM's prefill stacks each layer's outputs; the decode step
    # does not: its aten::stack events are the prefills', and they lie in
    # the engine.prefill spans on the shared clock
    stacks = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::stack"]
    layers = engine.model.cfg.num_layers
    assert len(stacks) == layers * len(pre)
    slack = 50_000
    for a, b in stacks:
        assert any(p0 - slack <= a and b <= p1 + slack for p0, p1 in pre)
    for p0, p1 in pre:
        assert sum(p0 - slack <= a and b <= p1 + slack
                   for a, b in stacks) == layers


def test_engine_lane_is_named_in_the_chrome_trace():
    tr = Tracer()
    tr.span("serve_batch", "engine", 1.0, 2.0, tid=ENGINE_TID)
    meta = [m for m in tr.chrome_trace()["traceEvents"] if m["ph"] == "M"]
    assert meta == [{"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": ENGINE_TID, "args": {"name": "engine"}}]
