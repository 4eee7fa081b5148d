"""The port's sharded dry run against the JAX package's, on the CPU:
``launch/sharding.py``'s rules, ``launch/mesh.py``'s counting meshes,
``utils/shard.py``'s pins and ``launch/dryrun.py::lower_combo`` on a mesh.

  * (a) ``param_spec`` / ``_augment_fsdp`` through ``params_shardings``:
    for every registry config and every param path, the reference's spec
    at model size 16 (with and without expert parallelism) and data size
    16 and 32; the six cases of ``tests/test_sharding_rules.py`` on the
    port's specs;
  * (b) ``cache_shardings`` and ``batch_shardings`` at the (2, 4) mesh of
    the 8 host devices, ``baseline_cache`` and ``force_seq_shard`` both
    ways; ``placements`` of a spec;
  * (c) ``lower_combo`` at ``make_test_mesh(model=4, data=2)`` against
    the reference's on the same mesh: per-device ``argument_bytes`` equal
    (the l2s step's screens differ in shape by design: each side's screen
    bytes are taken out); per-device FLOPs within the bounds below;
    collectives recorded by kind, nonzero where the reference's are, their
    ratio printed (not held equal: another partitioner);
  * (d) the l2s head's route and fused records count each device's rows:
    half the batch at data = 2;
  * (e) no mesh, no change: the pins return their input object, the
    one-card records are the ones the port gave before the mesh existed;
    every counting mesh leaves no process group behind.
"""
import json
import os

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch.sharding import _augment_fsdp as j_augment_fsdp
from repro.launch.sharding import batch_shardings as j_batch_shardings
from repro.launch.sharding import cache_shardings as j_cache_shardings
from repro.launch.sharding import param_spec as j_param_spec
from repro.launch.steps import abstract_cache as j_abstract_cache
from repro.launch.steps import abstract_screen as j_abstract_screen
from repro.data.loader import input_specs as j_input_specs
from repro.models import build_model
from repro_torch.configs import (INPUT_SHAPES, REGISTRY, L2SConfig,
                                 ShapeConfig, get_config)
from repro_torch.data.loader import input_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (CountingMesh, data_axes,
                                     make_production_mesh, make_test_mesh,
                                     mesh_axis_sizes)
from repro_torch.launch.op_cost import count_cost
from repro_torch.launch.sharding import (NamedSharding, _augment_fsdp,
                                         batch_shardings, cache_shardings,
                                         param_spec, params_shardings,
                                         placements)
from repro_torch.launch.steps import (abstract_cache, abstract_params,
                                      abstract_screen)
from repro_torch.models.model import Model
from repro_torch.utils import shard

MSIZE = 16


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module and its (2, 4) mesh of the 8 host
    devices. Importing the module appends a 512-device count to XLA_FLAGS
    for its own process: JAX's backend is brought up first and XLA_FLAGS
    restored after, so nothing later sees the change."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8 host devices tests/conftest.py forces")
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    from repro.launch.mesh import make_test_mesh as j_make_test_mesh
    return module, j_make_test_mesh(model=4, data=2)


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-name tuple entry as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def _paths(tree, prefix=""):
    """{path: leaf} of a port tree, paths joined as the reference's."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _paths(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _paths(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _j_paths(tree) -> dict:
    from repro.launch.sharding import _path_str
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: out.__setitem__(_path_str(p), x), tree)
    return out


# -- (a) the rules -----------------------------------------------------------


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_param_specs_equal_the_references(arch):
    """Every param path of every registry config: the port's
    ``params_shardings`` (``param_spec`` + ``_augment_fsdp``) equals the
    reference's rules, path for path."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    aparams = abstract_params(Model(cfg))
    want = {p: (tuple(x.shape)) for p, x in
            _j_paths(build_model(jcfg).init_shapes()).items()}
    got = _paths(aparams)
    assert set(got) == set(want)
    for ep in (False, True):
        plain = _paths(params_shardings(
            CountingMesh((1, MSIZE), ("data", "model")), cfg, aparams,
            expert_parallel=ep, fsdp=False))
        for path, shape in want.items():
            spec = j_param_spec(path, shape, jcfg, MSIZE, ep)
            assert plain[path].spec == _norm(spec), (path, ep)
            assert param_spec(path, shape, cfg, MSIZE, ep) == _norm(spec)
        for dsize in (16, 32):
            fsdp = _paths(params_shardings(
                CountingMesh((dsize, MSIZE), ("data", "model")), cfg,
                aparams, expert_parallel=ep))
            for path, shape in want.items():
                spec = j_augment_fsdp(j_param_spec(path, shape, jcfg, MSIZE,
                                                   ep), path, shape, dsize)
                assert fsdp[path].spec == _norm(spec), (path, ep, dsize)


def _specs(arch, expert_parallel=False, fsdp=False):
    """{path: (spec, shape)} at model and data size 16 (the reference's
    ``tests/test_sharding_rules.py::_specs_for``)."""
    cfg = get_config(arch)
    aparams = abstract_params(Model(cfg))
    out = {}
    for path, x in _paths(aparams).items():
        spec = param_spec(path, tuple(x.shape), cfg, MSIZE, expert_parallel)
        if fsdp:
            spec = _augment_fsdp(spec, path, tuple(x.shape), MSIZE)
        out[path] = (spec, tuple(x.shape))
    return out


def _divisible(specs):
    for path, (spec, shape) in specs.items():
        for ax, s in enumerate(spec):
            assert s is None or shape[ax] % MSIZE == 0, (path, shape, spec)


def _qwen110b_fully_sharded():
    specs = _specs("qwen1.5-110b", fsdp=True)
    _divisible(specs)
    spec, _ = specs["embed/embedding"]
    assert spec[0] == "model" and spec[1] == "data"
    assert "model" in specs["stack/blocks/attn/wq"][0]
    for path, (spec, _) in specs.items():
        if path.startswith("stack/blocks"):
            assert spec[0] is None, (path, spec)


def _smollm_attention_replicated():
    specs = _specs("smollm-360m")
    for name in ("wq", "wk", "wv", "wo"):
        spec, _ = specs[f"stack/blocks/attn/{name}"]
        assert all(s is None for s in spec), (name, spec)
    assert "model" in specs["stack/blocks/mlp/w_gate"][0]


def _moe_expert_parallel_toggle():
    spec, shape = _specs("phi3.5-moe-42b-a6.6b",
                         expert_parallel=True)["stack/blocks/moe/w_up"]
    assert spec[1] == "model" and shape[1] == 16
    spec, _ = _specs("mixtral-8x7b",
                     expert_parallel=True)["stack/blocks/moe/w_up"]
    assert spec[1] is None and spec[-1] == "model"


def _ssm_sharding():
    specs = _specs("mamba2-1.3b")
    assert specs["stack/blocks/ssm/in_proj"][0][-1] == "model"
    assert specs["stack/blocks/ssm/out_proj"][0][-2] == "model"
    _divisible(specs)


def _fsdp_never_shards_layer_axis():
    spec = _augment_fsdp((None, None, "model"), "stack/blocks/mlp/w_gate",
                         (32, 4096, 14336), MSIZE)
    assert spec[0] is None and spec[1] == "data"


def _lstm_sharding():
    spec, shape = _specs("ptb-large-lstm")["lstm/layers/0/wx"]
    for ax, s in enumerate(spec):
        assert s is None or shape[ax] % MSIZE == 0


RULE_CASES = {"qwen110b_fully_sharded": _qwen110b_fully_sharded,
              "smollm_attention_replicated": _smollm_attention_replicated,
              "moe_expert_parallel_toggle": _moe_expert_parallel_toggle,
              "ssm_sharding": _ssm_sharding,
              "fsdp_never_shards_layer_axis": _fsdp_never_shards_layer_axis,
              "lstm_sharding": _lstm_sharding}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_sharding_rule_cases(case):
    """The reference's six rule tests, on the port's specs."""
    RULE_CASES[case]()


# -- (b) caches, batches, placements ----------------------------------------

CACHE_COMBOS = [("gemma-2b", "decode_32k"), ("smollm-360m", "long_500k"),
                ("qwen1.5-110b", "decode_32k"), ("zamba2-2.7b", "decode_32k"),
                ("mamba2-1.3b", "long_500k"), ("nmt-deen-lstm", "decode_32k"),
                ("mixtral-8x7b", "long_500k")]


@pytest.mark.multidevice
@pytest.mark.parametrize("arch,shape", CACHE_COMBOS)
def test_cache_and_batch_shardings_equal_the_references(arch, shape, ref,
                                                        monkeypatch):
    jdry, jmesh = ref
    cfg, jcfg = get_config(arch), j_get_config(arch)
    s = INPUT_SHAPES[shape]
    window, _ = dryrun.decode_window(cfg, s)
    got_cache = abstract_cache(Model(cfg), s.global_batch, s.seq_len,
                               window=window)
    want_cache = j_abstract_cache(build_model(jcfg), s.global_batch,
                                  s.seq_len, window=window)
    mesh = make_test_mesh(4, data=2)
    for baseline in (False, True):
        monkeypatch.setenv("REPRO_BASELINE_CACHE", "1" if baseline else "0")
        for force in (False, True):
            got = _paths(cache_shardings(mesh, cfg, got_cache,
                                         force_seq_shard=force,
                                         baseline_cache=baseline))
            want = _j_paths(j_cache_shardings(jmesh, jcfg, want_cache,
                                              force_seq_shard=force))
            assert set(got) == set(want)
            for path, sh in want.items():
                assert _norm(got[path].spec) == _norm(sh.spec), (path, baseline,
                                                          force)
    got = batch_shardings(mesh, cfg, input_specs(cfg, s))
    want = j_batch_shardings(jmesh, jcfg, j_input_specs(jcfg, s))
    assert {k: _norm(v.spec) for k, v in got.items()} == \
        {k: _norm(v.spec) for k, v in want.items()}


def test_placements_of_a_spec():
    """One placement per mesh dim, a tuple entry sharding one tensor dim
    over several mesh dims in mesh order; a size-1 axis replicates."""
    from torch.distributed.tensor import Replicate, Shard
    with make_production_mesh(multi_pod=True) as mesh:
        assert mesh_axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
        assert data_axes(mesh) == ("pod", "data")
        assert placements(((("pod", "data")), None, "model"), mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert placements((None,), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh order"):
            placements(((("data", "pod")),), mesh)
        with pytest.raises(ValueError, match="no mesh axis"):
            placements(("seq",), mesh)
    with make_test_mesh(1, data=1) as mesh:
        assert NamedSharding(mesh, ("data", "model")).placements == \
            (Replicate(), Replicate())


HEAD_RULES = ["head_shardings", "adaptive_head_shardings", "vocab_sharded",
              "screen_shardings"]


@pytest.mark.multidevice
@pytest.mark.parametrize("name", HEAD_RULES)
def test_head_and_screen_shardings_equal_the_references(name, ref):
    """The sharded heads' and the screen's rules at the (2, 4) mesh: the
    same keys and specs as the reference's, and the placements those
    specs give (the port's sharded heads place their shards by
    ``n_shards`` / ``devices``; these are the rules a mesh would use)."""
    import repro.launch.sharding as js
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import sharding as ps
    _, jmesh = ref
    cfg = get_config("gemma-2b").reduced()
    with make_test_mesh(4, data=2) as mesh:
        if name == "vocab_sharded":
            pairs = [(ps.vocab_sharded(mesh, n, a),
                      js.vocab_sharded(jmesh, n, a))
                     for n, a in ((1, 0), (2, 0), (3, 0), (3, 1))]
        elif name == "screen_shardings":
            got = ps.screen_shardings(mesh, abstract_screen(cfg, L2SConfig()))
            from repro.configs import L2SConfig as JL2S
            want = js.screen_shardings(jmesh, j_abstract_screen(
                j_get_config("gemma-2b").reduced(), JL2S()))
            pairs = list(zip(got, want))
        else:
            got, want = getattr(ps, name)(mesh), getattr(js, name)(jmesh)
            assert set(got) == set(want)
            pairs = [(got[k], want[k]) for k in sorted(want)]
        assert pairs
        for g, w in pairs:
            assert _norm(g.spec) == _norm(w.spec)
            want_pl = tuple(Shard(_norm(g.spec).index(a)) if a in _norm(g.spec)
                            else Replicate() for a in ("data", "model"))
            assert g.placements == want_pl


# -- (c) lower_combo on the (2, 4) mesh ---------------------------------------

# per-device FLOPs against the reference's: the one-card bounds of
# test_torch_dryrun.py (train and prefill 6 %, decode 16 %), and where the
# two sides' steps differ by design the port's partition ratio (mesh ÷ one
# card) against the reference's: the l2s head (a 128-word block screen
# through the fused kernel against a word-granular gather) and SSM/hybrid
# steps (the reference's count includes its interpret-mode Pallas loops).
# The l2s ratio: 25 %: the port's route runs on each device's rows
# against the whole (replicated) screen, and on meta the fused kernel's
# record takes every slot for valid on each vocab shard (the most it
# could compute), where GSPMD splits the reference's candidate gather
# over "model".
COMBOS = [("gemma-2b", "train", "full", {}, 0.06, False),
          ("zamba2-2.7b", "prefill", "full", {}, 0.06, True),
          ("phi3.5-moe-42b-a6.6b", "decode", "full", {}, 0.16, False),
          ("nmt-deen-lstm", "decode", "l2s", {}, 0.25, True),
          ("gemma-2b", "decode", "full", {"serve_2d": True}, 0.16, False),
          ("phi3.5-moe-42b-a6.6b", "prefill", "full", {"fsdp": False}, 0.06,
           False)]


def _screen_bytes(screen) -> int:
    return sum(t.numel() * t.element_size() for t in screen)


def _j_screen_bytes(jcfg) -> int:
    from repro.configs import L2SConfig as JL2S
    return sum(int(x.size) * x.dtype.itemsize
               for x in j_abstract_screen(jcfg, JL2S()))


@pytest.mark.multidevice
@pytest.mark.parametrize("arch,kind,head,kw,tol,by_ratio", COMBOS)
def test_lower_combo_on_a_mesh_equals_the_references(arch, kind, head, kw,
                                                     tol, by_ratio, ref):
    jdry, jmesh = ref
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    shape, jshape = ShapeConfig("t", 32, 4, kind), JShape("t", 32, 4, kind)
    want = jdry.lower_combo(jcfg, jshape, jmesh, head=head, **kw)
    with make_test_mesh(4, data=2) as mesh:
        got = dryrun.lower_combo(cfg, shape, mesh, head=head, **kw)
    assert got["mesh"] == want["mesh"] == "2x4"
    ga, wa = got["memory"]["argument_bytes"], want["memory"]["argument_bytes"]
    if head == "l2s":      # the screens are replicated, whole on each device
        ga -= _screen_bytes(abstract_screen(cfg, L2SConfig()))
        wa -= _j_screen_bytes(jcfg)
    assert ga == wa
    gf, wf = (r["roofline"]["flops_per_dev"] for r in (got, want))
    if by_ratio:
        one = dryrun.lower_combo(cfg, shape, head=head)
        jone = jdry.lower_combo(jcfg, jshape, jdry_mesh_1(jdry), head=head)
        gf, wf = gf / one["roofline"]["flops_per_dev"], \
            wf / jone["roofline"]["flops_per_dev"]
    assert abs(gf - wf) / wf < tol, (gf, wf)
    gc, wc = (r["roofline"]["collectives"] for r in (got, want))
    print(f"\n{arch} {kind} {head} {kw}: FLOPs ratio {gf / wf:.4f}; "
          "collective bytes port / reference: " + ", ".join(
              f"{k} {gc[k]['bytes']:.0f} / {wc[k]['bytes']:.0f}"
              for k in gc))
    assert got["roofline"]["collective_bytes_per_dev"] > 0
    assert want["roofline"]["collective_bytes_per_dev"] > 0
    assert set(got) >= {"arch", "shape", "head", "mesh", "memory",
                        "roofline", "fits_one_card"}
    assert json.loads(json.dumps(got)) == got


def jdry_mesh_1(jdry):
    from repro.launch.mesh import make_test_mesh as j_make_test_mesh
    return j_make_test_mesh(model=1)


# -- (d) the kernels count one device's rows -----------------------------------


def test_l2s_kernels_count_each_devices_rows():
    """At data = 2 the route and fused records hold half the batch's rows
    and half its FLOPs; unsharded, the whole batch."""
    cfg = get_config("gemma-2b").reduced()
    shape = ShapeConfig("t", 32, 8, "decode")
    recs = {}
    orig = dryrun.count_cost

    def capture(fn, *a):
        out, c = orig(fn, *a)
        recs[len(recs)] = c
        return out, c
    dryrun.count_cost = capture
    try:
        dryrun.lower_combo(cfg, shape, head="l2s")
        with make_test_mesh(4, data=2) as mesh:
            dryrun.lower_combo(cfg, shape, mesh, head="l2s")
    finally:
        dryrun.count_cost = orig
    one, per_dev = (c.by_name() for c in (recs[0], recs[1]))
    for name in ("cluster_route", "fused_screened_topk"):
        assert per_dev[name]["count"] == one[name]["count"] == 1
        assert per_dev[name]["flops"] == one[name]["flops"] / 2, name
    route = [r for r in recs[1].ops if r.name == "cluster_route"][0]
    assert route.shapes == ((4,),)
    ids = [r for r in recs[1].ops if r.name == "fused_screened_topk"][0]
    assert ids.shapes == ((4, 5), (4, 5), (4,))


def _dt(mesh, shape, placements, dtype=torch.float32):
    """A meta DTensor of global ``shape`` at ``placements``."""
    from torch.distributed.tensor import DTensor, Shard
    loc = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            loc[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(loc, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _wrapper_call(name, mesh):
    """(call, its kernel record's name, the local result shapes it must
    record, the global result shapes) of one kernel wrapper on DTensors
    at the (2, 4) mesh: B = 8 rows split over data."""
    from torch.distributed.tensor import Replicate as R, Shard as S
    from repro_torch.kernels import cache_update, fused_topk, route, screen
    from repro_torch.kernels import ssd
    B, d, r, K, n_blk = 8, 64, 16, 3, 8
    h = _dt(mesh, (B, d), (S(0), R()))
    ids = _dt(mesh, (B, K), (S(0), R()), torch.int32)
    head = lambda pl: (_dt(mesh, (n_blk, 128, d), pl),      # noqa: E731
                       _dt(mesh, (n_blk, 128), pl))
    if name == "cluster_route":
        return (lambda: route.cluster_route(h, _dt(mesh, (r, d), (R(), R()))),
                name, [(4,)], [(B,)])
    if name == "screened_logits":
        return (lambda: screen.screened_logits(*head((R(), S(0))), h, ids),
                name, [(4, K, 128)], [(B, K, 128)])
    if name in ("fused_screened_topk", "fused_vocab_split"):
        pl = (R(), R()) if name == "fused_screened_topk" else (R(), S(0))
        return (lambda: fused_topk.fused_screened_topk(*head(pl), h, ids, 5),
                "fused_screened_topk", [(4, 5), (4, 5), (4,)],
                [(B, 5), (B, 5), (B,)])
    cache = (8, 32, 4, 16)                     # (B, S, KV, hd)
    if name in ("cache_kv_update", "cache_kv_update_seq"):
        pl = (S(0), S(2)) if name == "cache_kv_update" else (S(0), S(1))
        up = (S(0), S(1)) if name == "cache_kv_update" else (S(0), R())
        ck, cv = _dt(mesh, cache, pl), _dt(mesh, cache, pl)
        uk, uv = _dt(mesh, (8, 4, 16), up), _dt(mesh, (8, 4, 16), up)
        rows = (4, 1, 16) if name == "cache_kv_update" else (4, 4, 16)
        return (lambda: cache_update.cache_kv_update(ck, uk, cv, uv, 3),
                "cache_slot_update", [rows, rows], [cache, cache])
    if name == "cache_slot_update":
        c = _dt(mesh, cache, (S(0), S(2)))
        return (lambda: cache_update.cache_slot_update(
            c, _dt(mesh, (8, 4, 16), (S(0), S(1))),
            _dt(mesh, (8,), (S(0), R()), torch.int32)),
            name, [(4, 1, 16)], [cache])
    xw = _dt(mesh, (8, 2, 16, 8, 4), (S(0), R()))   # (B, nc, Q, H, P)
    Bm = _dt(mesh, (8, 2, 16, 1, 4), (S(0), R()))   # G = 1, N = 4
    l_ = _dt(mesh, (8, 2, 16, 8), (S(0), R()))
    if name == "ssd_intra":
        return (lambda: ssd.ssd_intra(xw, Bm, Bm, l_), name,
                [(4, 2, 16, 2, 4), (4, 2, 2, 4, 4)],
                [(8, 2, 16, 8, 4), (8, 2, 8, 4, 4)])
    dS = _dt(mesh, (8, 2, 8, 4, 4), (S(0), R()))
    return (lambda: ssd.ssd_intra_bwd(xw, Bm, Bm, l_, xw, dS), name,
            [(4, 2, 16, 2, 4), (4, 2, 16, 1, 4), (4, 2, 16, 1, 4),
             (4, 2, 16, 2)],
            [(8, 2, 16, 8, 4), (8, 2, 16, 1, 4), (8, 2, 16, 1, 4),
             (8, 2, 16, 8)])


WRAPPERS = ["cluster_route", "screened_logits", "fused_screened_topk",
            "fused_vocab_split", "cache_kv_update", "cache_kv_update_seq",
            "cache_slot_update", "ssd_intra", "ssd_intra_bwd"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_run_per_device(name):
    """Each kernel wrapper given DTensors runs on each device's shard
    (``local_map``): its record holds the local shapes (half the rows at
    data = 2; the SSD heads and a cache's KV heads over model = 4; a
    sequence-split cache writes the update rows it holds) and its results
    are DTensors of the global shapes. The vocab-split fused call records
    one launch over its own tiles and merges the shards' candidates."""
    with make_test_mesh(4, data=2) as mesh:
        call, rec, local, glob = _wrapper_call(name, mesh)
        with shard.use_mesh(mesh):
            out, cost = count_cost(call)
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(t.shape) for t in outs] == glob
    assert all(shard.is_dtensor(t) for t in outs)
    recs = [r for r in cost.ops if r.name == rec]
    assert len(recs) == 1 and [tuple(x) for x in recs[0].shapes] == local


# -- (e) no mesh, no change ---------------------------------------------------

# the one-card records of the parent tree (before the mesh existed)
ONE_CARD = {
    ("gemma-2b", "decode", "l2s"): (3551356.0, 1922200.0, {
        "param_bytes": 1380864, "argument_bytes": 1468052,
        "output_bytes": 32928, "temp_bytes": 36240}),
    ("zamba2-2.7b", "train", "full"): (637952294.0, 244983088.0, {
        "param_bytes": 1640576, "argument_bytes": 4922756,
        "output_bytes": 4921740, "temp_bytes": 3912776}),
    ("phi3.5-moe-42b-a6.6b", "prefill", "full"): (191029938.0, 28037220.0, {
        "param_bytes": 4205568, "argument_bytes": 4206080,
        "output_bytes": 160, "temp_bytes": 2374056}),
}


@pytest.mark.parametrize("arch,kind,head", list(ONE_CARD))
def test_no_mesh_records_are_unchanged(arch, kind, head):
    rec = dryrun.lower_combo(get_config(arch).reduced(),
                             ShapeConfig("t", 32, 4, kind), head=head)
    flops, nbytes, memory = ONE_CARD[(arch, kind, head)]
    assert "mesh" not in rec
    assert rec["memory"] == memory
    assert rec["roofline"]["flops_per_dev"] == flops
    assert rec["roofline"]["bytes_per_dev"] == nbytes
    assert rec["roofline"]["collective_bytes_per_dev"] == 0


def test_pins_return_their_input_without_a_mesh():
    x = torch.zeros((4, 8, 6))
    assert shard.shard_batch(x) is x
    assert shard.shard_axis(x, 1) is x
    assert shard.model_axis_size() == 1
    assert shard.ambient_mesh() is None
    with make_test_mesh(4, data=2) as mesh:
        from torch.distributed.tensor import DTensor, Replicate
        d = DTensor.from_local(torch.empty((4, 8, 6), device="meta"), mesh,
                               (Replicate(), Replicate()), run_check=False)
        # a DTensor outside use_mesh, a plain tensor inside it
        assert shard.shard_batch(d) is d
        with shard.use_mesh(mesh):
            assert shard.shard_batch(x) is x
            assert shard.model_axis_size() == 4
            pinned = shard.shard_batch(d)
            assert pinned.to_local().shape == (2, 8, 6)
            assert shard.shard_axis(d, 1).to_local().shape == (2, 2, 6)
        assert shard.ambient_mesh() is None
    assert not dist.is_initialized()


def test_a_collective_counts_its_result_bytes_per_device():
    """An all-gather and an all-reduce that DTensor runs: one record
    each, under the reference's kinds, their result bytes per device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with make_test_mesh(4, data=2) as mesh:
        x = DTensor.from_local(torch.empty((2, 16), device="meta"), mesh,
                               (Shard(0), Replicate()), run_check=False)
        w = DTensor.from_local(torch.empty((4, 8), device="meta"), mesh,
                               (Replicate(), Shard(0)), run_check=False)

        def f(x, w):
            y = (x @ w).redistribute(mesh, (Shard(0), Replicate()))
            return y.redistribute(mesh, (Replicate(), Replicate()))
        _, cost = count_cost(f, x, w)
    names = [r.name for r in cost.ops]
    assert names.count("all-reduce") == 1 and names.count("all-gather") == 1
    assert cost.collectives["all-reduce"]["bytes"] == 2 * 8 * 4
    assert cost.collectives["all-gather"]["bytes"] == 4 * 8 * 4
    assert cost.collective_bytes == 2 * 8 * 4 + 4 * 8 * 4
    mm = [r for r in cost.ops if r.name == "mm"]
    assert mm[0].shapes == ((2, 8),)          # the local shard's product


def test_main_counts_on_the_production_meshes(tmp_path):
    """The default mesh is the reference's 16x16, ``--multi-pod`` its
    2x16x16; a record per device fits where the one-card record does not;
    an encoder's decode is skipped on the mesh too; a failing combination
    is an error record and exit code 1."""
    out = tmp_path / "dry.jsonl"
    args = ["--arch", "smollm-360m", "--shape", "long_500k", "--json",
            str(out)]
    assert dryrun.main(args) == 0
    assert dryrun.main(args + ["--multi-pod", "--serve-2d", "--no-fsdp"]) == 0
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--json", str(out)]) == 0
    mesh, pod, enc = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert mesh["mesh"] == "16x16" and pod["mesh"] == "2x16x16"
    assert mesh["variant"] == "swa-variant"
    # without FSDP a device holds more of the weights
    assert mesh["memory"]["param_bytes"] < pod["memory"]["param_bytes"]
    assert "skipped" in enc and enc["mesh"] == "16x16"
    with pytest.raises(SystemExit):
        dryrun.main(["--one-card", "--multi-pod"])
    orig = dryrun.lower_combo

    def broken(*a, **kw):
        raise RuntimeError("no sharding strategy")
    dryrun.lower_combo = broken
    try:
        assert dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                            "--json", str(out)]) == 1
    finally:
        dryrun.lower_combo = orig
    err = json.loads(out.read_text().splitlines()[-1])
    assert err["error"].startswith("RuntimeError") and err["mesh"] == "16x16"
