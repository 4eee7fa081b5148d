"""Each metric reader on a synthetic run and a synthetic profile."""
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.autograd import DeviceType

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1] / "src")]

from l2sbench import drive, harness, profile, work  # noqa: E402

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
US = 1000


class Ev:
    """A Kineto event's accessors."""

    def __init__(self, name, dev, t0, t1, corr=0):
        self._v = (name, dev, t0 * US, (t1 - t0) * US, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _trace():
    """Window [0, 1000) µs: a graph replay (correlation 5) of two kernels
    at [100, 200) and [250, 300), a plain kernel at [400, 500) and one
    that ends past the window at [950, 1100)."""
    events = [Ev("cudaGraphLaunch", CPU, 90, 95, 5),
              Ev("aten::mm", CPU, 320, 380, 6),
              Ev("cudaStreamSynchronize", CPU, 520, 940),
              Ev("Activity Buffer Request", CPU, 600, 610),
              Ev("k1", CUDA, 100, 200, 5), Ev("k2", CUDA, 250, 300, 5),
              Ev("k1", CUDA, 400, 500, 6), Ev("k3", CUDA, 950, 1100, 7)]
    return profile.Trace(events, (0, 1000 * US))


def test_trace_sums():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(300e-6)
    assert tr.device_ops()[0] == ["k1", pytest.approx(200e-6)]
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(450e-6)
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    # kineto's own buffer request never labels a gap
    assert "Activity Buffer Request" not in gaps
    assert sum(gaps.values()) == pytest.approx(700e-6)


def _ctx(**kw):
    cfg = harness.load_json(harness.ROOT / "bench/configs/nmt-deen-lstm.json")
    base = dict(cfg=cfg, mix={}, record=drive.Record(window_s=2.0),
                setup_s=12.5, screen_words=1150.0)
    base.update(kw)
    return harness.Ctx(**base)


def _read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_device_readers():
    ctx = _ctx(trace=_trace())
    assert _read("device_idle.batch", ctx) == pytest.approx(70.0)
    assert _read("device_idle.batch", _ctx()) is None


def test_head_readers():
    probe = {"ms": 0.5, "bytes": 3.35e12 * 1e-4, "flops": 0.0}
    ctx = _ctx(probe=probe)
    assert _read("head_ms.batch", ctx) == 0.5
    # the least time is 0.1 ms of bytes against 0.5 ms measured
    assert _read("head_roofline.batch", ctx) == pytest.approx(20.0)
    assert _read("head_ms.batch", _ctx()) is None
    assert _read("head_roofline.batch", _ctx()) is None


def _job(start, end, prompt, news, heads):
    n = len(news)
    tokens = np.zeros((n, max(news)), np.int32)
    return drive.Job(start=start, end=end,
                     prompts=np.zeros((n, prompt), np.int32),
                     max_new=np.array(news), tokens=tokens,
                     lengths=np.array(news), heads=tuple(heads))


def test_closed_loop_readers():
    first = _job(0.0, 2.0, 16, [200, 250], ["screened-cuda", "exact"])
    traced = _job(2.0, 3.0, 32, [256], ["screened-cuda"])
    rec = drive.Record(window_s=3.0, jobs=[first, traced])
    ctx = _ctx(record=rec, traced_span=(2.0, float("inf")))
    assert _read("tokens_per_s", ctx) == pytest.approx(706 / 3.0)
    # the job the profiler saw is left out of the model step's share
    ref = harness.reference_module(ctx.cfg)
    want = (work.request_flops(ctx.cfg, ref, "screened", 1150.0, 16, 200)
            + work.request_flops(ctx.cfg, ref, "exact", 0, 16, 250)) / 2.0
    assert _read("step_mfu.batch", ctx) == pytest.approx(
        100 * want / 67e12)
    assert _read("setup_s", ctx) == 12.5
    assert _read("tokens_per_s", _ctx()) is None


def test_a_job_keeps_what_was_served():
    from types import SimpleNamespace as NS
    reqs = [NS(prompt=np.full(4, i, np.int32), max_new=3) for i in range(3)]
    res = [NS(tokens=np.arange(3) + i, head="exact") for i in range(3)]
    res[1].tokens = res[1].tokens[:2]          # one that never finished
    job = drive.Job.of(1.0, 2.0, reqs, res)
    assert job.lengths.tolist() == [3, 2, 3]
    assert [job.tokens[j, :job.lengths[j]].tolist() for j in range(3)] == \
        [[0, 1, 2], [1, 2], [2, 3, 4]]
    assert job.prompts[:, 0].tolist() == [0, 1, 2]
    assert job.heads == ("exact",) * 3 and job.max_new.tolist() == [3] * 3
