"""The port's dry run (``launch/dryrun.py``) and what it stands on —
``configs``' input shapes, ``data/loader.py::input_specs`` /
``random_inputs``, ``launch/steps.py``'s prefill / serve steps and
abstract arguments on the meta device — against the JAX package's, on the
CPU:

  * ``ShapeConfig`` / ``INPUT_SHAPES`` / ``shapes_for`` / ``ASSIGNED_ARCHS``,
    ``applicable`` and ``decode_window`` equal the reference's;
  * ``input_specs``: the reference's keys, shapes and dtypes for every
    family and the four shapes; ``random_inputs``: the reference's values;
  * ``lower_combo`` on reduced lstm, dense and moe configs at
    ``ShapeConfig("t", 32, 2, kind)`` against the reference's
    ``lower_combo`` on ``make_test_mesh(model=1)``: ``argument_bytes``
    equal; FLOPs within 6 % for train and prefill (the port's loss chunk is
    recomputed under its checkpoint, XLA's may be CSE'd) and within 16 %
    for decode (the reference's CPU module converts every bf16 cache
    element to float32 and back, one flop each, where the port widens only
    the K/V it attends over);
  * SSM and hybrid (whose reference steps lower interpret-mode Pallas
    loops): their SSD kernel records held to the analytic count, one
    ``ssd_intra`` a layer a prefill and one ``ssd_intra_bwd`` a layer a
    train step;
  * the l2s serve step through the route and fused kernels, with no
    (B, K·128) f32 result;
  * ``main --one-card``: a full-width record that does not fit one card,
    the swa-variant, an encoder's skipped decode, the exit code, and an
    unknown arch refused as the reference refuses it (the mesh records:
    ``test_torch_sharding.py``).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shapes_for as j_shapes_for
from repro.configs.base import ShapeConfig as JShape
from repro.data.loader import input_specs as j_input_specs
from repro.data.loader import random_inputs as j_random_inputs
from repro.launch.mesh import make_test_mesh
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, REGISTRY,
                                 ShapeConfig, get_config, shapes_for)
from repro_torch.data.loader import input_specs, random_inputs
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import count_cost, materializes_f32_buffer
from repro_torch.launch.steps import (abstract_params, abstract_screen,
                                      make_prefill_step, make_serve_step)
from repro_torch.models.model import Model

FLOPS_TOL = {"train": 0.06, "prefill": 0.06, "decode": 0.16}


@pytest.fixture(scope="module")
def jdry():
    """The reference's ``launch/dryrun.py``. Importing it appends a
    512-device count to XLA_FLAGS for its own process; here JAX's backend
    is brought up first (conftest's host devices stay as they are) and
    XLA_FLAGS is restored after, so no later backend or subprocess of the
    test process sees the change."""
    n = len(jax.devices())
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    assert len(jax.devices()) == n
    return module


def test_shapes_and_archs_equal_the_references(jdry):
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert {k: tuple(vars(v).values()) for k, v in INPUT_SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in J_SHAPES.items()}
    for name in REGISTRY:
        cfg, jcfg = get_config(name), j_get_config(name)
        assert shapes_for(cfg) == j_shapes_for(jcfg)
        for s in INPUT_SHAPES:
            assert dryrun.applicable(cfg, INPUT_SHAPES[s]) == \
                jdry.applicable(jcfg, J_SHAPES[s])
            assert dryrun.decode_window(cfg, INPUT_SHAPES[s]) == \
                jdry.decode_window(jcfg, J_SHAPES[s])


FAMILY_ARCHS = ["ptb-small-lstm", "gemma-2b", "mixtral-8x7b", "mamba2-1.3b",
                "zamba2-2.7b", "qwen2-vl-2b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_input_specs_equal_the_references(arch):
    """Keys, shapes and dtypes, every family × the four shapes, on meta."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for s in INPUT_SHAPES:
        if not cfg.supports_decode and INPUT_SHAPES[s].kind == "decode":
            with pytest.raises(ValueError):
                input_specs(cfg, s)
            continue
        got = input_specs(cfg, s)
        want = j_input_specs(jcfg, s)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).split(".")[1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-2b",
                                  "hubert-xlarge"])
def test_random_inputs_equal_the_references(arch):
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    kinds = ("train", "decode") if cfg.supports_decode else ("train",)
    for kind in kinds:
        got = random_inputs(cfg, ShapeConfig("t", 16, 2, kind), seed=4,
                            device="cpu")
        want = j_random_inputs(jcfg, JShape("t", 16, 2, kind), seed=4)
        assert list(got) == list(want)
        for k, t in got.items():
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(want[k], np.float32))


@pytest.fixture(scope="module")
def test_mesh():
    return make_test_mesh(model=1)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["nmt-deen-lstm", "gemma-2b",
                                  "mixtral-8x7b"])
def test_lower_combo_equals_the_references(arch, kind, test_mesh, jdry):
    """argument_bytes equal to the reference's memory analysis; FLOPs
    within FLOPS_TOL of its trip-count-aware HLO count."""
    shape = ShapeConfig("t", 32, 2, kind)
    got = dryrun.lower_combo(get_config(arch).reduced(), shape)
    want = jdry.lower_combo(j_get_config(arch).reduced(),
                            JShape("t", 32, 2, kind), test_mesh)
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    gf, wf = (r["roofline"]["flops_per_dev"] for r in (got, want))
    assert abs(gf - wf) / wf < FLOPS_TOL[kind], (gf, wf)
    assert set(got) >= {"arch", "shape", "head", "memory", "roofline",
                        "fits_one_card"}
    assert got["fits_one_card"] is True
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_steps_hold_to_the_analytic_kernel_counts(arch):
    """Prefill: one ``ssd_intra`` a layer, its FLOPs the analytic count of
    the chunks; train: one ``ssd_intra_bwd`` a layer (remat recomputes
    forwards, each recorded)."""
    cfg = get_config(arch).reduced()
    T, B = 32, 2
    rec = {}
    for kind in ("prefill", "train"):
        step, args, grad = dryrun._step_and_args(
            Model(cfg), ShapeConfig("t", T, B, kind), "full")
        with torch.set_grad_enabled(grad):
            _, rec[kind] = count_cost(step, *args)
    s = cfg.ssm
    H, P, N, Q = s.expand * cfg.d_model // s.head_dim, s.head_dim, \
        s.state_dim, s.chunk
    nc = T // Q
    pairs = Q * (Q + 1) // 2
    flops = B * nc * H * (2 * pairs * (N + P) + 2 * Q * N * P)
    fwd = rec["prefill"].by_name()["ssd_intra"]
    assert fwd["count"] == cfg.num_layers
    assert fwd["flops"] == cfg.num_layers * flops
    bwd = rec["train"].by_name()
    assert bwd["ssd_intra_bwd"]["count"] == cfg.num_layers
    assert bwd["ssd_intra"]["count"] >= cfg.num_layers


def test_l2s_serve_step_runs_the_kernels():
    """The l2s decode step records the route and the fused kernel once a
    step, no (B, K·128) f32 tile and no (B, V) logit row, which the full
    head's step writes; its arguments are the full step's and the
    screen's."""
    cfg = get_config("gemma-2b").reduced()
    shape = ShapeConfig("t", 32, 4, "decode")
    l2s = dryrun.lower_combo(cfg, shape, head="l2s")
    full = dryrun.lower_combo(cfg, shape)
    v, cand = abstract_screen(cfg, dryrun.L2SConfig())
    assert l2s["memory"]["argument_bytes"] == (
        full["memory"]["argument_bytes"] + v.numel() * 4 + cand.numel() * 4)
    model = Model(cfg)
    params = abstract_params(model)
    # 13 blocks a cluster: a (4, 13·128) f32 size no other op's result has
    v, cand = abstract_screen(cfg, dryrun.L2SConfig(budget=800))
    assert cand.shape[1] == 13
    cache = model.init_cache(4, 32, device="meta")
    tok = torch.empty((4,), dtype=torch.int32, device="meta")
    with torch.no_grad():
        (ids, vals, _), c = count_cost(make_serve_step(model, head="l2s"),
                                       params, v, cand, cache, tok, 3)
    names = [r.name for r in c.ops]
    assert names.count("cluster_route") == 1
    assert names.count("fused_screened_topk") == 1
    assert not materializes_f32_buffer(c, 4, cand.shape[1], 128)
    assert not materializes_f32_buffer(c, 4, cfg.vocab_size)
    assert tuple(ids.shape) == (4, 5) and ids.dtype == torch.int32
    with torch.no_grad():
        _, cf = count_cost(make_serve_step(model), params, cache, tok, 3)
    assert materializes_f32_buffer(cf, 4, cfg.vocab_size)
    assert "cluster_route" not in [r.name for r in cf.ops]


def test_prefill_step_on_the_cpu_equals_meta_shapes():
    """The prefill step runs for real on the CPU: top-5 ids and values of
    the last position, the shapes its meta count records."""
    cfg = get_config("smollm-360m").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = random_inputs(cfg, ShapeConfig("t", 8, 2, "prefill"), seed=1,
                          device="cpu")
    with torch.no_grad():
        ids, vals = make_prefill_step(model)(params, batch)
        h, _ = model.forward(params, batch)
        full = model.logits(params, h[:, -1]).float()
    assert torch.equal(vals, torch.sort(full, dim=-1,
                                        descending=True).values[:, :5])
    assert torch.equal(full.gather(1, ids.long()), vals)


def test_main_records_every_kind(tmp_path, capsys):
    """A full-width decode that does not fit one card is a record, not an
    error; the dense long context runs the swa-variant; an encoder's decode
    is skipped; the exit code is 0 with no error."""
    out = tmp_path / "dry.jsonl"
    one = ["--one-card", "--json", str(out)]
    assert dryrun.main(["--arch", "qwen1.5-110b", "--shape", "decode_32k",
                        *one]) == 0
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                        *one]) == 0
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        *one]) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    big, swa, enc = recs
    assert big["fits_one_card"] is False
    assert big["memory"]["argument_bytes"] > 80e9
    assert big["roofline"]["dominant"] == "memory"
    assert swa["variant"] == "swa-variant" and swa["fits_one_card"] is True
    assert "skipped" in enc
    assert all("error" not in r for r in recs)
    with pytest.raises(KeyError, match="unknown arch"):
        dryrun.main(["--arch", "no-such-arch"])
