"""One rank of a real (2, 4) ("data", "model") mesh of eight CPU processes,
a gloo group over this machine's loopback: each case runs once on DTensors
at the sharding rules' placements, every collective really exchanged, and
once on the same plain tensors without a mesh. Rank 0 saves both results
of every case, and the per-device paths each case went through, for
``tests/test_torch_sharding_exchange.py``:

    python tests/torch_mesh_worker.py RANK STORE_FILE OUT_FILE

Imports torch and the port, never JAX or the reference.
"""
from __future__ import annotations

import sys
import traceback
from dataclasses import replace
from datetime import timedelta

import torch
import torch.distributed as dist

WORLD = 8
MESH = (2, 4)
SEED = 0


def _full(tree):
    """Every leaf of ``tree`` whole: a DTensor gathered (a collective every
    rank joins), a plain tensor as it is."""
    from repro_torch.tree import tree_flatten
    from repro_torch.utils import shard
    return [t.full_tensor() if shard.is_dtensor(t) else t
            for t in tree_flatten(tree)]


def _clone(tree):
    from repro_torch.tree import tree_flatten, tree_unflatten
    return tree_unflatten(tree, [t.clone() for t in tree_flatten(tree)])


def _on_mesh(fn, mesh, args, grad=False):
    """``fn(*args)`` with ``mesh`` ambient, as the dry run runs a step."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.utils import shard
    with torch.set_grad_enabled(grad), shard.use_mesh(mesh), \
            implicit_replication():
        return fn(*args)


def _dist(mesh, tensors, placements):
    from torch.distributed.tensor import distribute_tensor
    return [distribute_tensor(t, mesh, p) for t, p in zip(tensors, placements)]


# -- the per-device paths each case went through ---------------------------------

SEEN: set = set()


def _spy():
    """Record each per-device path a case goes through, with the split it
    was given, so that a test can tell a split that ran from a call that
    fell back to replicated inputs."""
    from torch.distributed.tensor import Shard

    from repro_torch.kernels import cache_update, fused_topk, route, screen
    from repro_torch.kernels import ssd
    from repro_torch.layers import attention, moe, ssm
    from repro_torch.utils import shard

    def wrap(module, name, tag):
        orig = getattr(module, name)

        def spied(*a, **kw):
            t = tag(*a, **kw)
            if t:
                SEEN.add(t)
            return orig(*a, **kw)
        setattr(module, name, spied)

    def split(t, dim):
        return shard.is_dtensor(t) and Shard(dim) in t.placements

    wrap(route, "cluster_route", lambda h, v: "route rows split"
         if split(h, 0) else None)
    wrap(screen, "screened_logits", lambda W, b, h, ids: "screen rows split"
         if split(h, 0) else None)
    wrap(ssd, "ssd_intra", lambda xw, *a: "ssd_intra heads split"
         if split(xw, 3) else None)
    wrap(fused_topk, "_per_device", lambda W, *a: "fused vocab split"
         if split(W, 0) else "fused")
    wrap(cache_update, "_per_device", lambda fn, caches, *a, **kw:
         "cache seq split" if split(caches[0], 1) else "cache")
    # attention's one per-device call: a KV group's heads per device
    wrap(attention, "per_device", lambda *a, **kw: "kv group")
    wrap(moe, "_moe_per_device", lambda params, x, cfg:
         "moe expert split" if split(params["w_up"], 0) else
         "moe ff split" if split(params["w_up"], 2) else "moe")
    def ssd_tag(x, Bm, *a, **kw):
        m = x.device_mesh.size(x.device_mesh.mesh_dim_names.index("model"))
        H, G = x.shape[2], Bm.shape[2]
        return "ssd heads split" if H % m == 0 and (G == 1 or G % m == 0) \
            else "ssd"
    wrap(ssm, "_ssd_per_device", ssd_tag)
    wrap(shard, "lookup", lambda table, ids: "lookup vocab split"
         if split(table, 0) else None)
    wrap(shard, "gather_last", lambda x, idx: "gather_last vocab split"
         if split(x, x.dim() - 1) else None)
    wrap(shard, "logsumexp_last", lambda x: "logsumexp_last vocab split"
         if split(x, x.dim() - 1) else None)


# -- kernel wrappers and helpers: the same inputs on and off the mesh ----------


def case_fused_vocab_split(mesh):
    """The fused top-k over a head whose 8 tiles split over "model" (2 a
    device), the batch over "data": each device's k best over its own
    tiles, their ids made global, merged; a row of sentinels, and
    sentinels among the others."""
    from torch.distributed.tensor import Replicate as R, Shard as S

    from repro_torch.kernels.fused_topk import fused_screened_topk
    g = torch.Generator().manual_seed(SEED)
    n_blk, d, B, K, k = 8, 32, 8, 5, 40
    W = torch.randn((n_blk, 128, d), generator=g)
    b = torch.randn((n_blk, 128), generator=g)
    h = torch.randn((B, d), generator=g)
    ids = torch.randint(0, n_blk + 2, (B, K), generator=g).to(torch.int32)
    ids[0] = n_blk
    plain = fused_screened_topk(W, b, h, ids, k)
    on = _on_mesh(fused_screened_topk, mesh, (*_dist(
        mesh, (W, b, h, ids),
        ((R(), S(0)), (R(), S(0)), (S(0), R()), (S(0), R()))), k))
    return list(plain), _full(on)


def case_route_and_screen(mesh):
    """The route's cluster ids and the screened logits of a batch split
    over "data", the screen and the head replicated."""
    from torch.distributed.tensor import Replicate as R, Shard as S

    from repro_torch.kernels.route import cluster_route
    from repro_torch.kernels.screen import screened_logits
    g = torch.Generator().manual_seed(SEED + 6)
    n_blk, d, B, K, r = 6, 32, 8, 3, 16
    W = torch.randn((n_blk, 128, d), generator=g)
    b = torch.randn((n_blk, 128), generator=g)
    h = torch.randn((B, d), generator=g)
    v = torch.randn((r, d), generator=g)
    ids = torch.randint(0, n_blk + 1, (B, K), generator=g).to(torch.int32)

    def run(W, b, h, v, ids):
        return cluster_route(h, v), screened_logits(W, b, h, ids)
    plain = run(W, b, h, v, ids)
    rep, rows = (R(), R()), (S(0), R())
    on = _on_mesh(run, mesh, _dist(mesh, (W, b, h, v, ids),
                                   (rep, rep, rows, rep, rows)))
    return list(plain), _full(on)


def case_ssd_intra(mesh):
    """``ssd_intra`` on rows split over "data" and 8 heads over "model",
    one B/C group (G = 1, read by every device): y, S, and the gradients
    of both through all four inputs (the group's dB and dC summed over
    the devices' heads); then ``ssd_intra_bwd`` called on the same
    split."""
    from torch.distributed.tensor import Replicate as R, Shard as S

    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_bwd
    g = torch.Generator().manual_seed(SEED + 7)
    B, nc, Q, H, P, N = 4, 2, 16, 8, 8, 4
    xw = torch.randn((B, nc, Q, H, P), generator=g)
    Bm, Cm = (torch.randn((B, nc, Q, 1, N), generator=g) for _ in range(2))
    l = -torch.cumsum(torch.rand((B, nc, Q, H), generator=g), dim=2)
    gy = torch.randn((B, nc, Q, H, P), generator=g)
    gS = torch.randn((B, nc, H, N, P), generator=g)

    def run(xw, Bm, Cm, l, gy, gS):
        ins = [t.detach().requires_grad_(True) for t in (xw, Bm, Cm, l)]
        y, S_ = ssd_intra(*ins)
        ((y * gy).sum() + (S_ * gS).sum()).backward()
        return [y, S_] + [t.grad for t in ins] + list(
            ssd_intra_bwd(xw, Bm, Cm, l, gy, gS))
    plain = run(xw, Bm, Cm, l, gy, gS)
    heads, rows = (S(0), S(3)), (S(0), R())
    on = _on_mesh(run, mesh, _dist(mesh, (xw, Bm, Cm, l, gy, gS),
                                   (heads, rows, rows, heads, heads,
                                    (S(0), S(2)))), grad=True)
    return plain, _full(on)


def case_lookup(mesh):
    """The embedding lookup from a table split over "model" on its vocab
    and over "data" on d (FSDP), and the table's gradient."""
    from torch.distributed.tensor import Replicate as R, Shard as S

    from repro_torch.utils import shard
    g = torch.Generator().manual_seed(SEED + 1)
    V, d, B, T = 64, 32, 8, 6
    table = torch.randn((V, d), generator=g)
    ids = torch.randint(0, V, (B, T), generator=g).to(torch.int32)
    gy = torch.randn((B, T, d), generator=g)

    def run(table, ids, gy):
        table = table.detach().requires_grad_(True)
        y = shard.lookup(table, ids)
        (y * gy).sum().backward()
        return y, table.grad
    plain = run(table, ids, gy)
    on = _on_mesh(run, mesh, _dist(mesh, (table, ids, gy),
                                   ((S(1), S(0)), (S(0), R()), (S(0), R()))),
                  grad=True)
    return list(plain), _full(on)


def case_loss_terms(mesh):
    """log Z (``logsumexp_last``) and the gold logit (``gather_last``) of
    logits split over "data" on the batch and "model" on the vocab, and
    the logits' gradient of their difference, the loss."""
    from torch.distributed.tensor import Replicate as R, Shard as S

    from repro_torch.utils import shard
    g = torch.Generator().manual_seed(SEED + 2)
    B, T, V = 8, 3, 64
    x = 4 * torch.randn((B, T, V), generator=g)
    idx = torch.randint(0, V, (B, T), generator=g).to(torch.int32)

    def run(x, idx):
        x = x.detach().requires_grad_(True)
        lse, gold = shard.logsumexp_last(x), shard.gather_last(x, idx.long())
        (lse - gold).sum().backward()
        return lse, gold, x.grad
    plain = run(x, idx)
    on = _on_mesh(run, mesh, _dist(mesh, (x, idx),
                                   ((S(0), S(2)), (S(0), R()))), grad=True)
    return list(plain), _full(on)


def case_cache_seq_split(mesh):
    """``cache_kv_update`` into K/V caches whose sequence splits over
    ("data", "model") (the ``serve_2d`` layout, 4 slots a device), the
    batch replicated: the slot, 13 and then a slot per row, written by the
    one device that holds it, at its local index."""
    from torch.distributed.tensor import Replicate as R, Shard as S

    from repro_torch.kernels.cache_update import cache_kv_update
    g = torch.Generator().manual_seed(SEED + 3)
    B, S_, KV, hd = 4, 32, 2, 16
    ck, cv = (torch.randn((B, S_, KV, hd), generator=g) for _ in range(2))
    uk, uv = (torch.randn((B, KV, hd), generator=g) for _ in range(2))
    uk2, uv2 = (torch.randn((B, KV, hd), generator=g) for _ in range(2))
    rows = torch.tensor([0, 5, 13, 31], dtype=torch.int32)

    def run(ck, uk, cv, uv, uk2, uv2, rows):
        ck, cv = cache_kv_update(ck, uk, cv, uv, 13)
        return cache_kv_update(ck, uk2, cv, uv2, rows)
    plain = run(*_clone([ck, uk, cv, uv, uk2, uv2, rows]))
    rep, seq = (R(), R()), (S(1), S(1))
    on = _on_mesh(run, mesh, _dist(mesh, (ck, uk, cv, uv, uk2, uv2, rows),
                                   (seq, rep, seq, rep, rep, rep, rep)))
    return list(plain), _full(on)


def _moe_case(mesh, expert_parallel: bool):
    """``moe_apply`` with its experts split over "model" as the rules put
    them (E / 4 whole experts a device, or each expert's ff slice), the
    batch over "data": the output, the aux loss, and the gradients of
    both through x and every weight."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import param_spec
    from repro_torch.layers.moe import moe_apply, moe_init
    from repro_torch.utils.shard import placements
    from torch.distributed.tensor import Replicate as R, Shard as S
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    g = torch.Generator().manual_seed(SEED + 4)
    params = moe_init(g, cfg)
    x = torch.randn((8, 16, cfg.d_model), generator=g)
    gy = torch.randn(x.shape, generator=g)
    keys = list(params)

    def run(x, gy, *ws):
        ws = [w.detach().requires_grad_(True) for w in ws]
        x = x.detach().requires_grad_(True)
        out, aux = moe_apply(dict(zip(keys, ws)), x, cfg)
        ((out * gy).sum() + 100 * aux).backward()
        return [out, aux, x.grad] + [w.grad for w in ws]
    plain = run(x, gy, *params.values())
    pls = [placements(param_spec("moe/" + k, tuple(w.shape),
                                 cfg, 4, expert_parallel), mesh)
           for k, w in params.items()]
    on = _on_mesh(run, mesh, _dist(mesh, (x, gy, *params.values()),
                                   ((S(0), R()), (S(0), R()), *pls)),
                  grad=True)
    return plain, _full(on)


def case_moe_expert_split(mesh):
    return _moe_case(mesh, True)


def case_moe_ff_split(mesh):
    return _moe_case(mesh, False)


# -- whole steps: the dry run's step and shardings on real tensors -------------

# (arch, kind, head, lower_combo's keywords); phi3.5-moe with 2 KV heads of
# its 4, so that each device's heads fall in one KV group (model = 4)
STEPS = {
    "gemma-2b decode l2s": ("gemma-2b", "decode", "l2s", {}),
    "gemma-2b decode l2s serve_2d": ("gemma-2b", "decode", "l2s",
                                     {"serve_2d": True}),
    "gemma-2b train": ("gemma-2b", "train", "full", {}),
    "phi3.5-moe kv2 prefill": ("phi3.5-moe-kv2", "prefill", "full", {}),
    "phi3.5-moe kv2 train ff split": ("phi3.5-moe-kv2", "train", "full",
                                      {"expert_parallel": False}),
    "zamba2-2.7b train": ("zamba2-2.7b", "train", "full", {}),
    "nmt-deen-lstm decode l2s": ("nmt-deen-lstm", "decode", "l2s", {}),
}


def step_config(arch: str):
    from repro_torch.configs import get_config
    if arch == "phi3.5-moe-kv2":
        return replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                       num_kv_heads=2)
    return get_config(arch).reduced()


def _materialize(cfg, shape, head, args):
    """Real tensors for the dry run's meta arguments: the model's own
    initial weights, a zero optimiser state, tokens and labels in the
    vocabulary, a random cache, the screen's blocks in [0, n_blk] (n_blk
    the sentinel), the position mid-cache."""
    from repro_torch.configs.base import V_BLK
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map
    g = torch.Generator().manual_seed(SEED + 5)
    params = Model(cfg).init(g, device="cpu")
    V = cfg.vocab_size

    def tokens(t):
        return torch.randint(0, V, t.shape, generator=g).to(t.dtype)
    if shape.kind == "train":
        return [params, adamw_init(params),
                {k: tokens(t) for k, t in args[2].items()}]
    if shape.kind == "prefill":
        return [params, {k: tokens(t) for k, t in args[1].items()}]
    cache, token, pos = args[-3:]
    tail = [tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                     cache),
            tokens(token), torch.tensor(shape.seq_len // 2, dtype=pos.dtype)]
    if head == "l2s":
        v, cand = args[1:3]
        n_blk = -(-V // V_BLK)
        return [params, torch.randn(v.shape, generator=g),
                torch.randint(0, n_blk + 1, cand.shape,
                              generator=g).to(cand.dtype)] + tail
    return [params] + tail


def case_step(mesh, name):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import distribute
    arch, kind, head, kw = STEPS[name]
    cfg = step_config(arch)
    shape = ShapeConfig("t", 32, 8, kind)
    step, args, in_sh, out_sh, grad = dryrun.mesh_step(cfg, shape, mesh,
                                                       head, **kw)
    real = _materialize(cfg, shape, head, args)
    with torch.set_grad_enabled(grad):
        plain = _full(step(*_clone(real)))
    dargs = [distribute(a, s) for a, s in zip(_clone(real), in_sh)]
    return plain, _full(_on_mesh(step, mesh, dargs, grad))


CASES = {
    "route and screen": case_route_and_screen,
    "fused vocab split": case_fused_vocab_split,
    "ssd_intra heads split": case_ssd_intra,
    "lookup": case_lookup,
    "loss terms": case_loss_terms,
    "cache seq split": case_cache_seq_split,
    "moe expert split": case_moe_expert_split,
    "moe ff split": case_moe_ff_split,
    **{name: (lambda mesh, name=name: case_step(mesh, name))
       for name in STEPS},
}


def main(rank: int, store: str, out: str) -> int:
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=120))
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(MESH),
                      mesh_dim_names=("data", "model"))
    _spy()
    results = {}
    for name, case in CASES.items():
        SEEN.clear()
        try:
            plain, on = case(mesh)
            results[name] = {"plain": [t.detach() for t in plain],
                             "mesh": [t.detach() for t in on],
                             "paths": sorted(SEEN)}
        except Exception:                 # noqa: BLE001 (reported by rank 0)
            results[name] = {"error": traceback.format_exc()}
        dist.barrier()
    if rank == 0:
        torch.save(results, out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2], sys.argv[3]))
