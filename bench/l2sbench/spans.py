"""The program's own spans in a traced window: what the host was doing
while the card idled, and the padded rows the engine decoded.

While a torch profiler runs, the engine records its spans (the lane
``ENGINE_TID``) into the process tracer,
``repro_torch.serving.observe.trace.PROCESS_TRACER``, stamped on the
profiler's clock (``time.time_ns``, seconds in the tracer), so they lie on
the axis of the trace's device events. A program without that tracer, or a
window it dropped events of or holds no ``serve_batch`` span in, gives
nothing here (None).

The idle time of the window, the complement of ``Trace.busy_intervals``
(the intervals ``device_idle.batch`` reads, no threshold), is split into
``PARTS`` by the innermost span running at each idle instant: spans nest
by time on their one lane. The parts sum to the idle time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PARTS = ("client", "serve", "prefill", "decode")
# the part a span takes while it is the innermost span running; outside
# every span the host is in the client
PART_OF = {
    "serve_batch": "serve", "serve.route": "serve", "serve.results": "serve",
    "engine.prefill": "prefill", "engine.first": "prefill",
    "engine.generate": "decode", "engine.step": "decode",
    "engine.capture": "decode", "engine.readback": "decode",
}
NS = 1_000_000_000

Span = Tuple[int, int, str, dict]          # (t0 ns, t1 ns, name, args)


def process_tracer():
    """The program's process tracer and its engine lane, or None where the
    program has none."""
    try:
        from repro_torch.serving.observe import trace as mod
    except ImportError:
        return None
    tracer = getattr(mod, "PROCESS_TRACER", None)
    tid = getattr(mod, "ENGINE_TID", None)
    return None if tracer is None or tid is None else (tracer, tid)


def window_spans(tracer, tid: int, window: tuple) -> Optional[List[Span]]:
    """The engine's spans that overlap ``window`` (ns), sorted by start,
    the outer first; None where the tracer dropped events or holds no
    ``serve_batch`` span there."""
    if tracer.dropped:
        return None
    w0, w1 = window
    out = []
    for e in tracer.events():
        if e.get("ph") != "X" or e["tid"] != tid:
            continue
        a = int(round(e["ts"] * NS))
        b = int(round((e["ts"] + e["dur"]) * NS))
        if b > w0 and a < w1:
            out.append((a, b, e["name"], e.get("args", {})))
    if not any(s[2] == "serve_batch" for s in out):
        return None
    out.sort(key=lambda s: (s[0], -s[1]))
    return out


def segments(spans: List[Span], window: tuple) -> List[tuple]:
    """[(a, b, part)]: the window cut where the innermost span changes,
    each piece labelled with that span's part (a span of a name not in
    ``PART_OF`` takes its parent's)."""
    w0, w1 = window
    out: List[tuple] = []
    cur = w0

    def emit(upto: int, part: str) -> None:
        nonlocal cur
        upto = min(max(upto, w0), w1)
        if upto > cur:
            out.append((cur, upto, part))
            cur = upto

    stack: List[tuple] = []                  # (end ns, part), innermost last
    for a, b, name, _ in spans:
        while stack and stack[-1][0] <= a:
            end, part = stack.pop()
            emit(end, part)
        outer = stack[-1][1] if stack else "client"
        emit(a, outer)
        stack.append((b, PART_OF.get(name, outer)))
    while stack:
        end, part = stack.pop()
        emit(end, part)
    emit(w1, "client")
    return out


def idle_intervals(busy: List[tuple], window: tuple) -> List[tuple]:
    """The window less the (sorted, merged) busy intervals."""
    w0, w1 = window
    out, prev = [], w0
    for a, b in busy:
        if a > prev:
            out.append((prev, min(a, w1)))
        prev = max(prev, b)
    if w1 > prev:
        out.append((prev, w1))
    return [(a, b) for a, b in out if b > a]


def split_idle(busy: List[tuple], spans: List[Span],
               window: tuple) -> Dict[str, int]:
    """{part: idle ns} over ``PARTS``: each idle instant of the window in
    the part of the innermost span running then."""
    tot = dict.fromkeys(PARTS, 0)
    segs = segments(spans, window)
    i = 0
    for a, b in idle_intervals(busy, window):
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s0, s1, part = segs[j]
            tot[part] += min(b, s1) - max(a, s0)
            j += 1
    return tot


def pad_share(spans: List[Span], window: tuple) -> Optional[float]:
    """1 − Σ kept / Σ rows × steps over the ``engine.generate`` spans that
    lie wholly in the window, in %; None where there is none."""
    w0, w1 = window
    kept = decoded = 0
    for a, b, name, args in spans:
        if name == "engine.generate" and w0 <= a and b <= w1:
            kept += int(args["kept"])
            decoded += int(args["rows"]) * int(args["steps"])
    return None if decoded == 0 else 100.0 * (1.0 - kept / decoded)


def summarize(trace, tracer, tid: int) -> Optional[dict]:
    """{"idle_<part>": % of the window, ..., "pad_share": %} of a traced
    window, or None."""
    if trace is None or trace.window[1] <= trace.window[0]:
        return None
    spans = window_spans(tracer, tid, trace.window)
    if spans is None:
        return None
    width = trace.window[1] - trace.window[0]
    parts = split_idle(trace.busy_intervals(), spans, trace.window)
    out = {f"idle_{p}": 100.0 * ns / width for p, ns in parts.items()}
    out["pad_share"] = pad_share(spans, trace.window)
    return out


def read(ctx, key: str) -> Optional[float]:
    """One number of ``summarize`` for the run's trace and the program's
    process tracer."""
    found = process_tracer()
    if ctx.trace is None or found is None:
        return None
    out = summarize(ctx.trace, *found)
    return None if out is None else out[key]
