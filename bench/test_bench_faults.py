"""Whole runs of the harness on the CPU at tiny sizes, past its look for a
card: sound runs come out correct; the control (the reference in the
precision below the configuration's) and a timed path broken underneath
come out not correct."""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1] / "src")]

from l2sbench import harness, tiny  # noqa: E402

# the tiny float32 LSTM needs a larger vocabulary and many positions for
# TF32's rounding to flip a near tie
LSTM = dict(tiny.LSTM, d_model=64, vocab_size=2048,
            screen={"clusters": 8, "blocks_per_cluster": 4, "block": 128})
CLOSED = dict(copy.deepcopy(tiny.CLOSED), judge_requests=24,
              jobs={"requests": 24,
                    "source_length": {"median": 6, "sigma": 0.4, "min": 2,
                                      "max": 8},
                    "prompt_buckets": [4, 8], "block": 2,
                    "output_ratio": [10.0, 14.0]})
# a tiny-size limit: these sizes' sound runs read 0
LIMITS = {"logit_gap": 5e-7, "route_gap": 5e-7, "outside": 0}


def _cell(cfg, mix, floor=None):
    mix = copy.deepcopy(mix)
    if floor is not None:
        mix["accuracy_floor"] = floor
    return harness.Cell(name="tiny", entry={"chips": 1}, cfg=cfg,
                        mix=mix, limits=dict(LIMITS))


CELLS = {"lstm-closed-screened": (LSTM, CLOSED, 0.9),
         "lstm-closed-exact": (LSTM, CLOSED, 1.0)}


def _run(name, seed, control=None):
    cfg, mix, floor = CELLS[name]
    # one job, the same whatever the host's speed
    return harness.run_cell(tiny.BENCH, _cell(cfg, mix, floor), seed, 0.0,
                            False, device="cpu", control=control)


def _altered(orig):
    def next(self, h):
        ids = orig(self, h)
        return torch.where(ids % 7 == 3, ids - 1, ids)
    return next


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    out = _run(name, 2)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,seed,prec", [
    ("lstm-closed-screened", 2, "tf32"), ("lstm-closed-screened", 3, "tf32"),
    ("lstm-closed-screened", 4, "tf32"), ("lstm-closed-exact", 2, "tf32"),
    ("lstm-closed-exact", 3, "tf32"), ("lstm-closed-exact", 4, "tf32")])
def test_control_is_not_correct(name, seed, prec):
    out = _run(name, seed, control=prec)

    def within(numbers):
        return all(numbers[k] <= lim for k, lim in LIMITS.items())
    assert within(out["program"])
    assert not within(out["control"]), out["control"]


def _patch_decode(monkeypatch, fn):
    from repro_torch.models.model import Model
    orig = Model.decode_step

    def decode_step(self, params, token, cache, pos=None):
        return fn(orig, self, params, token, cache, pos)
    monkeypatch.setattr(Model, "decode_step", decode_step)


def _state_unchanged(orig, self, params, token, cache, pos):
    """A step that returns its state unchanged."""
    saved = [t.clone() for t in harness.weights.flatten(cache).values()]
    h, new = orig(self, params, token, cache, pos)
    for t, s in zip(harness.weights.flatten(new).values(), saved):
        t.copy_(s)
    return h, new


def _half_batch(orig, self, params, token, cache, pos):
    """Half of the batch left out: the second half's rows not decoded."""
    h, new = orig(self, params, token, cache, pos)
    h = h.clone()
    h[h.shape[0] // 2:] = 0
    return h, new


def _altered(orig):
    def next(self, h):
        ids = orig(self, h)
        return torch.where(ids % 7 == 3, ids - 1, ids)
    return next


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    if fault == "token_altered":
        # every head class's own next, where the token is produced
        import repro_torch.heads  # noqa: F401  (every head class defined)
        from repro_torch.heads.base import SoftmaxHead
        classes, todo = [], [SoftmaxHead]
        while todo:
            c = todo.pop()
            classes.append(c)
            todo += c.__subclasses__()
        for c in classes:
            if "next" in vars(c):
                monkeypatch.setattr(c, "next", _altered(vars(c)["next"]))
    else:
        _patch_decode(monkeypatch, {"state_unchanged": _state_unchanged,
                                    "half_batch": _half_batch}[fault])
    out = _run(name, 5)
    assert not out["correct"], out["checks"]


def test_the_sample_holds_the_longest_request():
    from l2sbench import judge
    sizes = np.array([(n, 4) for n in (3, 9, 5, 9, 2)])
    rng = np.random.default_rng(0)
    idx = judge.pick_sample(sizes, 3, rng)
    assert idx[0] == 1 and len(set(idx)) == 3
