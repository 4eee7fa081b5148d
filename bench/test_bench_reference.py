"""The plain reference against the port's plain CPU paths at tiny sizes,
its controls, and what ``bench/`` imports."""
import ast
import sys
from pathlib import Path

import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1] / "src")]

from l2sbench import drive, harness, judge, tiny, weights  # noqa: E402

BENCH = Path(__file__).resolve().parent


@pytest.mark.parametrize("cfg", [tiny.LSTM], ids=["lstm"])
def test_reference_matches_the_port_on_cpu(cfg):
    from repro_torch.models.model import Model
    ref = harness.reference_module(cfg)
    flat = weights.make_weights(ref.param_spec(cfg), 7, "cpu")
    weights.check_layout(flat, drive.program_layout(cfg))
    tok = torch.randint(0, cfg["vocab_size"], (3, 40),
                        generator=torch.Generator().manual_seed(0))
    model = Model(drive.port_config(cfg))
    with torch.inference_mode():
        h_port = model.forward(weights.as_tree(flat), {"tokens": tok})[0]
        h_ref = ref.hidden(flat, cfg, tok, harness.precision("float32"))
        scale = float(h_ref.abs().max())
        assert float((h_port.float() - h_ref).abs().max()) <= 1e-5 * scale
        # the controls move h by far more than the port's rounding
        for prec in ("tf32", "fp8"):
            h_c = ref.hidden(flat, cfg, tok, harness.precision(prec))
            assert float((h_c - h_ref).abs().max()) > 1e-4 * scale
        # the port's own next tokens over the same contexts judge clean
        W, b = ref.head(flat, cfg)
        H = h_ref.reshape(-1, h_ref.shape[-1])
        ids = torch.argmax(h_port.reshape(-1, H.shape[1]).float()
                           @ W.float().T + b.float(), dim=1)
        got = judge.judge(H, ids, W, b, None, None,
                          harness.precision("float32"))
        assert got["outside"] == 0 and got["logit_gap"] <= 1e-5 * scale


def test_weights_are_the_seeds():
    spec = harness.reference_module(tiny.LSTM).param_spec(tiny.LSTM)
    a = weights.make_weights(spec, 3, "cpu")
    b = weights.make_weights(spec, 3, "cpu")
    c = weights.make_weights(spec, 4, "cpu")
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[("embed", "embedding")],
                           c[("embed", "embedding")])
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in a.values())
    v, cand = weights.make_screen(tiny.LSTM, 3, "cpu")
    assert cand.shape == (4, 2) and cand.dtype == torch.int32
    assert all(len(set(row.tolist())) == 2 for row in cand)


def test_every_size_of_a_configuration_file_is_applied():
    cfg = harness.load_json(harness.ROOT / "bench/configs/nmt-deen-lstm.json")
    mc = drive.port_config(cfg)
    for key, value in cfg.items():
        if key not in drive.OWN_KEYS:
            assert getattr(mc, key) == value, key
    assert drive.port_config(dict(cfg, d_model=64)).d_model == 64
    # a nested group is applied key by key over the registry entry's
    zamba = {"name": "z", "port_config": "zamba2-2.7b", "ssm": {"chunk": 64}}
    ssm = drive.port_config(zamba).ssm
    assert ssm.chunk == 64 and ssm.state_dim > 0
    for bad in (dict(cfg, num_experts=8), dict(cfg, d_model={"x": 1})):
        with pytest.raises(ValueError):
            drive.port_config(bad)


def test_judge_catches_tokens_off_the_screen():
    cfg = tiny.LSTM
    g = torch.Generator().manual_seed(1)
    V, d = cfg["vocab_size"], cfg["d_model"]
    W, b = torch.randn(V, d, generator=g), torch.zeros(V)
    v = torch.randn(4, d, generator=g)
    cand = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=torch.int32)
    scr = judge.Screen(v, cand, V, 128)
    H = torch.randn(64, d, generator=g)
    f32 = harness.precision("float32")
    ids = judge.control_tokens(H, W, b, scr, f32)
    clean = judge.judge(H, ids, W, b, scr, 1e-6, f32)
    assert clean["logit_gap"] == 0 and clean["route_gap"] == 0
    assert clean["outside"] == 0
    bad = judge.judge(H, torch.full((64,), V), W, b, scr, 1e-6, f32)
    assert bad["outside"] == 64
    shifted = judge.judge(H, (ids + 1) % V, W, b, scr, 1e-6, f32)
    assert shifted["logit_gap"] > 0


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert "repro_torch" not in _imports(f), f
