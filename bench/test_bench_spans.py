"""The span readers (``l2sbench/spans.py`` and the ``idle_*.batch`` /
``pad_share.batch`` metrics) on a synthetic profile and synthetic spans
of the program's process tracer."""
import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1] / "src")]

from l2sbench import harness, profile, spans, traffic  # noqa: E402
from repro_torch.serving.observe import trace as trace_mod  # noqa: E402
from repro_torch.serving.observe.trace import ENGINE_TID, Tracer  # noqa: E402
from test_bench_readers import CPU, CUDA, Ev, _ctx, _read  # noqa: E402

US = 1000
IDLE = ("idle_client.batch", "idle_serve.batch", "idle_prefill.batch",
        "idle_decode.batch")


def _trace(base=0):
    """Window [0, 1000) µs past ``base`` ns; the card busy at [100, 200),
    [250, 300), [400, 500) and [950, 1100) (past the window's end)."""
    events = [Ev("cudaLaunchKernel", CPU, 95, 99),
              Ev("k1", CUDA, 100, 200), Ev("k2", CUDA, 250, 300),
              Ev("k1", CUDA, 400, 500), Ev("k3", CUDA, 950, 1100)]
    tr = profile.Trace(events, (0, 1000 * US))
    if base:
        tr.dev_t0 = tr.dev_t0 + base
        tr.dev_t1 = tr.dev_t1 + base
        tr.window = (base, base + 1000 * US)
    return tr


# (name, start µs, end µs, args): one call of four rows decoding three
# steps, nine tokens kept; a second call that leaves the window
SPANS = [
    ("serve_batch", 50, 900, {"job": 0, "requests": 4, "groups": 1}),
    ("serve.route", 50, 80, None),
    ("engine.generate", 80, 850,
     {"job": 0, "head": "exact", "rows": 4, "steps": 3, "kept": 9}),
    ("engine.prefill", 90, 300, {"rows": 4, "prompt": 8}),
    ("engine.first", 300, 320, None),
    ("engine.step", 320, 420, None),
    ("engine.step", 420, 520, None),
    ("engine.readback", 520, 840, None),
    ("serve.results", 860, 890, None),
    ("serve_batch", 970, 1300, {"job": 1, "requests": 2, "groups": 1}),
    ("engine.generate", 980, 1200,
     {"job": 1, "head": "exact", "rows": 2, "steps": 5, "kept": 6}),
]
# idle µs by part: client [0, 50) + [900, 950); serve [50, 80) + [850,
# 860) + [860, 890) + [890, 900); prefill [90, 100) + [200, 250) + [300,
# 320); decode [80, 90) + [320, 400) + [500, 850)
WANT = {"idle_client.batch": 10.0, "idle_serve.batch": 8.0,
        "idle_prefill.batch": 8.0, "idle_decode.batch": 44.0}


def _tracer(span_list=SPANS, base=0, capacity=65536):
    tr = Tracer(capacity=capacity)
    # the engine records a span at its end: children before parents
    for name, a, b, args in sorted(span_list, key=lambda s: s[2]):
        tr.span(name, "engine", (base + a * US) * 1e-9,
                (base + b * US) * 1e-9, tid=ENGINE_TID, args=args)
    return tr


@pytest.fixture
def program(monkeypatch):
    """Arms the program's process tracer with ``_tracer(...)``'s spans."""
    def arm(tracer):
        monkeypatch.setattr(trace_mod, "PROCESS_TRACER", tracer)
    return arm


def test_idle_parts_by_innermost_span(program):
    program(_tracer())
    ctx = _ctx(trace=_trace())
    got = {m: _read(m, ctx) for m in IDLE}
    assert got == pytest.approx(WANT, abs=1e-12)
    assert _read("device_idle.batch", ctx) == pytest.approx(70.0)
    assert _read("pad_share.batch", ctx) == pytest.approx(25.0)


@pytest.mark.parametrize("base", [0, 1_760_000_000 * 10**9 + 123_456_789])
def test_idle_parts_sum_to_device_idle(program, base):
    program(_tracer(base=base))
    ctx = _ctx(trace=_trace(base))
    total = sum(_read(m, ctx) for m in IDLE)
    assert abs(total - _read("device_idle.batch", ctx)) < 1e-9
    # on the wall clock's float seconds each edge moves by under 0.25 µs
    got = {m: _read(m, ctx) for m in IDLE}
    assert got == pytest.approx(WANT, abs=0.1)


@pytest.mark.parametrize("at,part", [(20, "client"), (60, "serve"),
                                     (85, "decode"), (95, "prefill"),
                                     (210, "prefill"), (310, "prefill"),
                                     (350, "decode"), (600, "decode"),
                                     (855, "serve"), (870, "serve"),
                                     (920, "client")])
def test_an_idle_instant_takes_the_innermost_span(at, part):
    spans_ = spans.window_spans(_tracer(), ENGINE_TID, (0, 1000 * US))
    segs = spans.segments(spans_, (0, 1000 * US))
    (hit,) = [p for a, b, p in segs if a <= at * US < b]
    assert hit == part
    # the pieces tile the window
    assert segs[0][0] == 0 and segs[-1][1] == 1000 * US
    assert all(x[1] == y[0] for x, y in zip(segs, segs[1:]))
    # one idle microsecond there lands in that part alone
    one = spans.split_idle([(0, at * US), (at * US + US, 1000 * US)],
                           spans_, (0, 1000 * US))
    assert one == {p: (US if p == part else 0) for p in spans.PARTS}


def test_a_span_of_another_name_takes_its_parents_part():
    w = (0, 1000 * US)
    plain = spans.split_idle([], spans.window_spans(_tracer(), ENGINE_TID, w),
                             w)
    extra = SPANS + [("engine.other", 600, 700, None)]
    got = spans.split_idle([], spans.window_spans(_tracer(extra), ENGINE_TID,
                                                  w), w)
    assert got == plain
    # the first call's decode part and the second call's, to the window
    assert got["decode"] == (850 - 80 - 210 - 20 + 1000 - 980) * US


def test_nothing_to_read_gives_none(program, monkeypatch):
    ctx = _ctx(trace=_trace())
    names = IDLE + ("pad_share.batch",)
    # events dropped from the ring
    program(_tracer(capacity=4))
    assert all(_read(m, ctx) is None for m in names)
    # no serve_batch span inside the window
    program(_tracer([s for s in SPANS if s[0] != "serve_batch"]))
    assert all(_read(m, ctx) is None for m in names)
    program(_tracer(base=5_000 * US))
    assert all(_read(m, ctx) is None for m in names)
    # no trace
    program(_tracer())
    assert all(_read(m, _ctx()) is None for m in names)
    # a program with no process tracer (as before the engine had spans)
    monkeypatch.delattr(trace_mod, "PROCESS_TRACER")
    assert all(_read(m, ctx) is None for m in names)


@pytest.mark.parametrize("mix", ["iwslt14-b640-f090", "iwslt14-b640-f100"])
def test_pad_share_is_the_jobs_padding(program, mix):
    """One block of the cell's jobs as the engine's counters carry them:
    each job one group, padded to its longest max_new."""
    jobs = traffic.ClosedJobs(
        harness.load_json(harness.BENCH / "traffic" / f"{mix}.json"), 7, 100)
    span_list, t = [], 10
    kept = decoded = 0
    per_job = []
    for i in range(len(jobs.block)):
        news = jobs.max_new(jobs.bucket(i))
        n, steps = len(news), max(news)
        span_list += [("serve_batch", t, t + 50, {"job": i}),
                      ("engine.generate", t + 5, t + 45,
                       {"job": i, "head": "exact", "rows": n,
                        "steps": steps, "kept": sum(news)})]
        t += 55
        kept += sum(news)
        decoded += n * steps
        per_job.append(100 * (1 - sum(news) / (n * steps)))
    program(_tracer(span_list))
    ctx = _ctx(trace=profile.Trace([], (0, (t + 10) * US)))
    got = _read("pad_share.batch", ctx)
    assert got == pytest.approx(100 * (1 - kept / decoded), rel=1e-12)
    assert got == pytest.approx(31.625, abs=1e-3)
    assert min(per_job) > 25.8 and max(per_job) < 37.4
    # a window on one job reads that job's share
    ctx = _ctx(trace=profile.Trace([], (8 * US, 62 * US)))
    assert _read("pad_share.batch", ctx) == pytest.approx(per_job[0])
