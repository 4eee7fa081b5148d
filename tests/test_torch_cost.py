"""The port's op-level cost counter (``launch/op_cost.py``), its roofline
(``launch/roofline.py``, peaks from ``launch/mesh.py``) and
``utils/pytree.py`` against the JAX package's ``launch/hlo_cost.py``,
``launch/roofline.py`` and ``utils/pytree.py``, on the CPU and on the meta
device:

  * twins of ``tests/test_hlo_cost.py``: matmul FLOPs within 1 % of 2·256³
    and of ``analyze_hlo`` of the compiled product; a loop of 12 trips
    (and 3 × 4 nested) within 1 % of ``analyze_hlo``'s trip-count-scaled
    scan; a gather's bytes far below the table's; the roofline's terms are
    1 s at the H100's peaks;
  * the fused L2S path's memory contract at B = 32, K = 16, d = 512: the
    unfused path records a (B, K, 128) float32 result, the fused path none,
    and the fused path's bytes are below the unfused path's; its twin for
    the adaptive head's short tier;
  * each kernel wrapper records ONE op under its kernel's name, the same on
    the CPU and on meta, and the plain version it runs on the CPU leaves
    no record; the wrappers raise on a device they do not take;
  * the vocab-sharded heads' collectives: kinds, counts and result bytes of
    ``exact-sharded`` at 8 shards equal ``parse_collectives`` of the
    reference's compiled calls on conftest's 8 host devices;
  * the storage tracker's peak, and the meta trip-count shortcut equal to
    running every trip;
  * ``tree_size`` / ``tree_bytes`` / ``tree_norm`` / ``cast_tree`` equal to
    the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import heads as jheads
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.mesh import make_test_mesh
from repro.launch.roofline import parse_collectives
from repro.utils import pytree as jtree
from repro_torch import heads
from repro_torch.kernels import ops
from repro_torch.kernels.cache_update import cache_kv_update, cache_slot_update
from repro_torch.kernels.fused_topk import fused_screened_topk
from repro_torch.kernels.route import cluster_route
from repro_torch.kernels.screen import screened_logits
from repro_torch.kernels.ssd import ssd_intra, ssd_intra_bwd
from repro_torch.launch import mesh
from repro_torch.launch.op_cost import (count_cost, materializes_f32_buffer,
                                        trips)
from repro_torch.launch.roofline import Roofline, roofline_from_cost
from repro_torch.utils import cast_tree, tree_bytes, tree_norm, tree_size

DEVICES = ["cpu", "meta"]


def _hlo_flops(f, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(f).lower(*specs).compile().as_text()).flops


@pytest.mark.parametrize("device", DEVICES)
def test_matmul_flops_exact(device):
    """Within 1 % of 2·256³ and of the reference's count."""
    a = torch.ones((256, 256), device=device)
    _, c = count_cost(lambda x, y: x @ y, a, a)
    assert abs(c.flops - 2 * 256 ** 3) / (2 * 256 ** 3) < 0.01
    ref = _hlo_flops(lambda x, y: x @ y, (256, 256), (256, 256))
    assert abs(c.flops - ref) / ref < 0.01
    assert c.bytes_accessed == 3 * 256 * 256 * 4


@pytest.mark.parametrize("device", DEVICES)
def test_loop_flops_trip_count(device):
    """12 trips count 12× (the reference's scan, its trip count parsed);
    a 3 × 4 nest 12×. Within 1 % of the reference's count."""
    def port(ws, x):
        for w in ws:
            x = x @ w
        return x

    def ref(ws, x):
        return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]

    ws = torch.ones((12, 128, 128), device=device)
    x = torch.ones((128, 128), device=device)
    _, c = count_cost(port, ws, x)
    assert abs(c.flops - 2 * 128 ** 3 * 12) / (2 * 128 ** 3 * 12) < 0.01
    r = _hlo_flops(ref, (12, 128, 128), (128, 128))
    assert abs(c.flops - r) / r < 0.01

    def nested(ws, x):
        for wo in ws:
            for wi in wo:
                x = x @ wi
        return x

    def ref_nested(ws, x):
        def outer(c, wo):
            return jax.lax.scan(lambda ci, wi: (ci @ wi, None), c, wo)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    x = torch.ones((64, 64), device=device)
    _, c = count_cost(nested, torch.ones((3, 4, 64, 64), device=device), x)
    r = _hlo_flops(ref_nested, (3, 4, 64, 64), (64, 64))
    assert abs(c.flops - 2 * 64 ** 3 * 12) / (2 * 64 ** 3 * 12) < 0.01
    assert abs(c.flops - r) / r < 0.02


@pytest.mark.parametrize("device", DEVICES)
def test_gather_bytes_not_full_table(device):
    """An embedding-style gather counts its slice and ids, not the 12.8 MB
    table."""
    table = torch.zeros((50_000, 64), device=device)
    ids = torch.zeros((8,), dtype=torch.long, device=device)
    _, c = count_cost(lambda t, i: t[i], table, ids)
    assert c.bytes_accessed == 8 * 64 * 4 + 8 * 8
    _, c = count_cost(torch.nn.functional.embedding, ids, table)
    assert c.bytes_accessed < 1e6 and c.flops == 0


def test_slice_write_counts_the_update():
    """An in-place write into a slice of a large cache counts the update
    read and written (and its indices), not the cache."""
    cache = torch.zeros((4, 4096, 64))
    upd = torch.ones((4, 64))
    rows = torch.arange(4)
    slot = torch.full((4,), 7)

    def write(c, u):
        c[rows, slot] = u
        c[:, 9].copy_(u)
        return c

    _, c = count_cost(write, cache, upd)
    assert c.bytes_accessed == 2 * (2 * 4 * 64 * 4) + 2 * 4 * 8


def test_roofline_terms():
    """Each term is 1 s at the H100's peaks; float32 work at 67 TFLOP/s."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW,
            mesh.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    r = Roofline(flops=989e12, bytes_accessed=3.35e12, collective_bytes=450e9)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 1.0) < 1e-9
    r2 = Roofline(flops=1, bytes_accessed=3.35e12 * 5, collective_bytes=1)
    assert r2.dominant == "memory" and r2.bound_time_s == r2.memory_s
    _, c = count_cost(lambda x: x @ x, torch.ones((64, 64)))
    f32 = roofline_from_cost(c, torch.float32)
    bf16 = roofline_from_cost(c, "bfloat16")
    assert f32.compute_s == c.flops / 67e12
    assert bf16.compute_s == c.flops / 989e12
    assert set(f32.as_dict()) == {"flops_per_dev", "bytes_per_dev",
                                  "collective_bytes_per_dev", "compute_s",
                                  "memory_s", "collective_s", "dominant",
                                  "collectives"}


def _l2s(device, B=32, K=16, d=512, L=4000, r=8, seed=0):
    rng = np.random.default_rng(seed)
    W = torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(L), dtype=torch.float32)
    Wb, bb = ops.pack_head_blocks(W, b)
    v = torch.as_tensor(rng.standard_normal((r, d)), dtype=torch.float32)
    cand = torch.as_tensor(rng.integers(0, Wb.shape[0] + 2, (r, K)),
                           dtype=torch.int32)
    h = torch.as_tensor(rng.standard_normal((B, d)), dtype=torch.float32)
    return [t.to(device) for t in (Wb, bb, v, cand, h)]


@pytest.mark.parametrize("device", DEVICES)
def test_fused_kernel_materializes_no_candidate_logit_buffer(device):
    """The memory contract at B = 32, K = 16, d = 512 (the twin of
    ``test_hlo_cost.py``'s): the unfused path writes the (B, K, V_BLK) f32
    tile, the fused path no f32 result of that size in any layout, and
    moves fewer bytes."""
    B, K, k = 32, 16, 5
    args = _l2s(device)
    with torch.inference_mode():
        _, unfused = count_cost(ops.screened_topk, *args, k=k)
        _, fused = count_cost(ops.screened_fused_topk, *args, k=k)
    assert materializes_f32_buffer(unfused, B, K, 128)
    assert materializes_f32_buffer(unfused, B, K * 128)
    assert not materializes_f32_buffer(fused, B, K, 128)
    assert fused.bytes_accessed < unfused.bytes_accessed
    names = [r.name for r in fused.ops]
    assert names.count("cluster_route") == 1
    assert names.count("fused_screened_topk") == 1
    assert "screened_logits" not in names


@pytest.mark.parametrize("device", DEVICES)
def test_adaptive_short_tier_materializes_no_full_vocab_buffer(device):
    """Twin of ``test_heads_parity.py``'s: the fused adaptive path records
    no full-vocab (N, L) nor packed (N, n_blk·128) f32 result; with no
    tails the unfused path does record its packed short-tier row (so the
    probe is not vacuous) and the fused path does not."""
    N, LS, D, k = 16, 203, 32, 5
    rng = np.random.default_rng(7)
    W = torch.as_tensor(rng.standard_normal((LS, D)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(LS) * 0.1, dtype=torch.float32)
    h = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32)
    tiered = heads.get("adaptive", device="cpu", W=W, b=b, shortlist=50,
                       n_tails=3)
    full = heads.get("adaptive", device="cpu", W=W, b=b, shortlist=LS)
    unf = heads.get("adaptive", device="cpu", W=W, b=b, shortlist=LS,
                    fused=False)
    for hd in (tiered, full, unf):
        hd.prepare()
    with torch.inference_mode():
        if device == "meta":
            # the counted step on meta: the same head over meta tables
            for hd in (tiered, full, unf):
                for a in ("_Wb", "_bb", "_gid", "_short_blocks", "_tail_tab",
                          "_g", "_gb"):
                    t = getattr(hd, a, None)
                    if isinstance(t, torch.Tensor):
                        setattr(hd, a, t.to("meta"))
            h = h.to("meta")
        _, ct = count_cost(tiered.topk, h, k)
        _, cf = count_cost(full.topk, h, k)
        _, cu = count_cost(unf.topk, h, k)
    n_blk = tiered._Wb.shape[0]
    assert not materializes_f32_buffer(ct, N, LS)
    assert not materializes_f32_buffer(ct, N, n_blk * 128)
    nb = full._Wb.shape[0]
    assert materializes_f32_buffer(cu, N, nb * 128)
    assert not materializes_f32_buffer(cf, N, nb * 128)


def _kernel_calls(device, dtype=torch.float32):
    """One call of each wrapper, at a small shape with distinct valid tile
    ids (so the CPU's distinct-tile count equals meta's every-slot one)."""
    g = torch.Generator().manual_seed(3)
    n_blk, d, B, K, r = 12, 64, 3, 4, 5
    Wb = torch.randn((n_blk, 128, d), generator=g).to(dtype)
    bb = torch.randn((n_blk, 128), generator=g).to(dtype)
    h = torch.randn((B, d), generator=g).to(dtype)
    ids = torch.arange(B * K, dtype=torch.int32).reshape(B, K) % n_blk
    v = torch.randn((r, d), generator=g)
    cache = torch.zeros((B, 16, 2, 32), dtype=dtype)
    upd = torch.ones((B, 2, 32), dtype=dtype)
    xw, Bm, Cm = (torch.randn(s, generator=g) for s in
                  ((2, 1, 8, 4, 16), (2, 1, 8, 2, 8), (2, 1, 8, 2, 8)))
    l = -torch.rand((2, 1, 8, 4), generator=g).cumsum(2)
    dy, dS = torch.randn((2, 1, 8, 4, 16)), torch.randn((2, 1, 4, 8, 16))
    on = {k_: t.to(device) for k_, t in dict(
        Wb=Wb, bb=bb, h=h, ids=ids, v=v, cache=cache, cache_v=cache.clone(),
        upd=upd, xw=xw, Bm=Bm,
        Cm=Cm, l=l, dy=dy, dS=dS).items()}
    o = type("I", (), on)
    calls = {
        "cluster_route": lambda: cluster_route(o.h, o.v),
        "screened_logits": lambda: screened_logits(o.Wb, o.bb, o.h, o.ids),
        "fused_screened_topk": lambda: fused_screened_topk(o.Wb, o.bb, o.h,
                                                           o.ids, 5),
        "cache_slot_update": lambda: cache_slot_update(o.cache, o.upd, 3),
    }
    if dtype == torch.float32:
        calls.update({
            "cache_kv_update": lambda: cache_kv_update(
                o.cache, o.upd, o.cache_v, o.upd, 3),
            "ssd_intra": lambda: ssd_intra(o.xw, o.Bm, o.Cm, o.l),
            "ssd_intra_bwd": lambda: ssd_intra_bwd(o.xw, o.Bm, o.Cm, o.l,
                                                   o.dy, o.dS)})
    return calls


def _record(call):
    with torch.inference_mode():
        _, c = count_cost(call)
    return [(r.name, r.shapes, r.dtypes, r.flops, r.bytes) for r in c.ops]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_wrapper_records_one_op_on_cpu_and_meta(dtype):
    """One record per call, under the kernel's name (``_bf16`` for the
    bf16 bodies), equal on the CPU and on meta; the CPU's plain version
    leaves none. The cache pair is one launch, one record."""
    cpu, meta = _kernel_calls("cpu", dtype), _kernel_calls("meta", dtype)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    for name in cpu:
        got = _record(cpu[name])
        assert got == _record(meta[name]), name
        assert len(got) == 1, (name, got)
        want = {"cache_kv_update": "cache_slot_update"}.get(name, name)
        if name in ("cluster_route", "screened_logits", "fused_screened_topk"):
            want += sfx
        assert got[0][0] == want
    # the results each kernel writes, and nothing else
    assert _record(cpu["fused_screened_topk"])[0][1] == ((3, 5), (3, 5), (3,))
    assert _record(cpu["screened_logits"])[0][1:3] == (((3, 4, 128),),
                                                       (torch.float32,))
    assert _record(cpu["cache_slot_update"])[0][1] == ((3, 2, 32),)


def test_kernel_bytes_count_each_distinct_tile_once():
    """PERF.md §6's bound convention: a tile read by several slots counts
    once; the gather's sentinel slots read tile 0, the fused kernel's none.
    FLOPs are the card's: the gather computes every slot, the fused kernel
    the valid slots alone."""
    calls = _kernel_calls("cpu")
    d, esz = 64, 4
    tile = 128 * (d + 1) * esz
    (_, _, _, flops, nbytes), = _record(calls["fused_screened_topk"])
    assert nbytes == 12 * tile + esz * 3 * d + 4 * 3 * 4 + 4 * (2 * 3 * 5 + 3)
    assert flops == 2 * 3 * 4 * 128 * d
    g = torch.Generator().manual_seed(3)
    Wb = torch.randn((12, 128, d), generator=g)
    bb = torch.randn((12, 128), generator=g)
    h = torch.randn((3, d), generator=g)
    ids = torch.tensor([[1, 1, 12, 13], [1, 2, 12, 12], [2, 2, 2, 2]],
                       dtype=torch.int32)
    (_, _, _, ff, fb), = _record(lambda: fused_screened_topk(Wb, bb, h, ids,
                                                              5))
    (_, _, _, sf, sb), = _record(lambda: screened_logits(Wb, bb, h, ids))
    rest = esz * 3 * d + 4 * 3 * 4
    assert fb == 2 * tile + rest + 4 * (2 * 3 * 5 + 3)
    assert sb == 3 * tile + rest + 4 * 3 * 4 * 128
    assert ff == 2 * 8 * 128 * d            # 8 valid slots of 12
    assert sf == 2 * 12 * 128 * d


def test_wrappers_raise_on_other_devices():
    """cuda, cpu and meta only: anything else is refused, not run plainly."""
    with pytest.raises(ValueError, match="cuda / cpu / meta"):
        ops.check_tensor(torch.zeros(2), "h", torch.float32, 1,
                         torch.device("xpu"))


def test_peak_bytes_tracks_live_storage():
    """The peak counts each new result's storage while it (or a view of it)
    lives, and frees it when the last goes."""
    def chain(x):
        a = x * 2                 # 4 KB live
        b = a[:, :8]              # a view: nothing new
        del a
        c = b + 1                 # 4 KB + 2 KB
        del b                     # the 4 KB storage freed
        return c * 3              # 2 KB + 2 KB

    x = torch.ones((32, 32))
    _, c = count_cost(chain, x)
    assert c.peak_bytes == 32 * 32 * 4 + 32 * 8 * 4


def test_meta_trips_count_every_trip():
    """``trips(n, x)`` on meta runs one trip and counts it n times: the same
    totals as running every trip, and every trip on the CPU."""
    def loop(x, w, n):
        acc = torch.zeros_like(x)
        for _ in trips(n, x):
            acc = acc + torch.tanh(x @ w)
        return acc

    x, w = torch.ones((8, 16)), torch.ones((16, 16))
    _, cpu = count_cost(loop, x, w, 5)
    _, meta = count_cost(loop, x.to("meta"), w.to("meta"), 5)
    assert (cpu.flops, cpu.bytes_accessed) == (meta.flops, meta.bytes_accessed)
    assert sum(r.name == "mm" for r in cpu.ops) == 5
    assert sum(r.name == "mm" for r in meta.ops) == 1


@pytest.mark.parametrize("method", ["next", "topk", "topk_logprobs"])
def test_sharded_collectives_equal_the_references(method):
    """``exact-sharded`` at 8 shards: each collective's kind, count and
    result bytes equal ``parse_collectives`` of the reference's compiled
    call (8 host devices), though the port's shards share one device."""
    L, d, B, k = 203, 32, 4, 5
    rng = np.random.default_rng(5)
    W = rng.standard_normal((L, d)).astype(np.float32)
    b = rng.standard_normal(L).astype(np.float32)
    h = rng.standard_normal((B, d)).astype(np.float32)
    jh = jheads.get("exact-sharded", W=jnp.asarray(W), b=jnp.asarray(b),
                    mesh=make_test_mesh(8))
    th = heads.get("exact-sharded", device="cpu", W=torch.as_tensor(W),
                   b=torch.as_tensor(b), n_shards=8)
    kw = {} if method == "next" else {"k": k}
    text = jax.jit(lambda x: getattr(jh, method)(x, **kw)).lower(
        jnp.asarray(h)).compile().as_text()
    want = {n: v for n, v in parse_collectives(text).items() if v["count"]}
    with torch.inference_mode():
        _, c = count_cost(getattr(th, method), torch.as_tensor(h), **kw)
    got = {n: {"bytes": int(v["bytes"]), "count": int(v["count"])}
           for n, v in c.collectives.items() if v["count"]}
    assert got == want
    assert c.collective_bytes == sum(v["bytes"] for v in want.values())


def _trees():
    rng = np.random.default_rng(2)
    arrays = {"embed": {"embedding": rng.standard_normal((7, 3)),
                        "lm_bias": rng.standard_normal(7)},
              "layers": [{"w": rng.standard_normal((3, 5)),
                          "step": np.arange(4, dtype=np.int32)}]}
    jt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.int32 if a.dtype == np.int32
                              else jnp.float32), arrays)
    tt = jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), jt)
    return jt, tt


def test_pytree_helpers_equal_the_references():
    jt, tt = _trees()
    assert tree_size(tt) == jtree.tree_size(jt) == 7 * 3 + 7 + 3 * 5 + 4
    assert tree_bytes(tt) == jtree.tree_bytes(jt)
    np.testing.assert_allclose(float(tree_norm(tt)),
                               float(jtree.tree_norm(jt)), rtol=1e-6)
    jc, tc = jtree.cast_tree(jt, jnp.bfloat16), cast_tree(tt, torch.bfloat16)
    assert tree_bytes(tc) == jtree.tree_bytes(jc)
    assert tc["layers"][0]["step"].dtype == torch.int32
    assert tc["embed"]["embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tc["layers"][0]["w"].float().numpy(),
        np.asarray(jc["layers"][0]["w"].astype(jnp.float32)))
    # meta trees count their shapes, as ShapeDtypeStructs do
    meta = cast_tree(tt, torch.float32)
    meta = {"embed": {k: v.to("meta") for k, v in meta["embed"].items()}}
    assert tree_bytes(meta) == 4 * (7 * 3 + 7)
