"""``work.py`` against counts made by hand."""
import sys
from pathlib import Path

import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1] / "src")]

from l2sbench import work  # noqa: E402
from l2sbench.harness import (load_json, reference_module,  # noqa: E402
                              screen_words, ROOT)

LSTM = load_json(ROOT / "bench/configs/nmt-deen-lstm.json")
REF = reference_module(LSTM)


def test_peaks_and_bound():
    assert work.PEAK_FLOPS["float32"] == 67e12
    assert work.PEAK_FLOPS["bfloat16"] == 989e12
    assert work.bound_s(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert work.bound_s(0, 67e12, "float32") == pytest.approx(1.0)
    assert work.bound_s(3.35e9, 989e12, "bfloat16") == pytest.approx(1.0)


def test_lstm_flops_by_hand():
    # 2 layers x (x.Wx + h.Wh), each (1 x 500) @ (500 x 2000): 2 FLOPs a MAC
    per_position = 2 * 2 * (500 * 2000) * 2
    assert REF.model_flops(LSTM, 0, 10) == 10 * per_position
    assert REF.model_flops(LSTM, 4, 2) == 0
    assert work.head_flops(LSTM, "exact", 0) == 2 * 25000 * 500
    assert work.head_flops(LSTM, "screened", 1152) == 2 * (100 + 1152) * 500
    # prompt 16, 3 new: the model over 18 positions, 3 head evaluations
    assert work.request_flops(LSTM, REF, "exact", 0, 16, 3) == \
        18 * per_position + 3 * 2 * 25000 * 500


def test_head_call_work_by_hand():
    b, f = work.head_call_work(LSTM, "exact", 64)
    assert f == 2 * 64 * 25000 * 500
    assert b == 25000 * 501 * 4 + 64 * 500 * 4 + 64 * 4
    b, f = work.head_call_work(LSTM, "screened", 4, tile_words=256,
                               row_words=4 * 1152)
    assert f == 2 * 4 * 100 * 500 + 2 * 4 * 1152 * 500
    assert b == 100 * 500 * 4 + 256 * 501 * 4 + 4 * 500 * 4 + 4 * 4
    bf16 = dict(LSTM, dtype="bfloat16")
    b, f = work.head_call_work(bf16, "exact", 2)
    assert b == 25000 * 501 * 2 + 2 * 500 * 2 + 2 * 4


def test_distinct_tiles_and_screen_words():
    ids = torch.tensor([[0, 3, 3], [7, 0, 9]])
    assert work.distinct_tiles(ids, 8) == 3        # 9 is a sentinel
    # 25,000 words: 195 full tiles and one of 40
    cand = torch.tensor([[194, 195], [0, 1]])
    assert screen_words(cand, 25000, 128).tolist() == [168, 256]
