"""Dry run: count one step of every (arch × input shape) on the ``meta``
device, with no card and no allocation, and report one device's memory and
roofline: one device of the reference's production mesh (16×16, or
2×16×16 with ``--multi-pod``), or one unsharded H100 (``--one-card``).

Twin of ``repro/launch/dryrun.py``, which lowers and compiles each
combination for a TPU mesh and reads XLA's memory and cost analyses. The
port runs the step itself on meta tensors (shapes and dtypes only) under
``launch/op_cost.count_cost``:

* ``params`` / ``memory.param_bytes`` — the weights' count, and the bytes
  one device holds;
* ``memory.argument_bytes`` — the step's arguments on one device: params,
  plus the AdamW state for train, plus the decode cache, plus the inputs
  (and the screen for the l2s head), less an input the step never reads,
  as the reference's jit drops it;
* ``memory.output_bytes`` — the step's results;
* ``memory.temp_bytes`` — the peak of the storage the step allocates, its
  results included while they live (``OpCost.peak_bytes``);
* ``roofline`` — ``launch/roofline.py`` over the count, at the peak of the
  config's dtype, its collective term over NVLink;
* ``fits_one_card`` — argument + temp bytes within the H100's 80 GB. A
  step that does not fit is a record like any other, not an error.

On a mesh (``lower_combo(..., mesh)``, ``mesh`` a counting ``DeviceMesh``
from ``launch/mesh.py``) the step's arguments are DTensors placed by the
reference's rules (``launch/sharding.py``: params with FSDP unless
``--no-fsdp``, batches, caches, the replicated screen), the step runs under
``utils/shard.py::use_mesh`` and DTensor's ``implicit_replication()``,
its results are redistributed to the reference's out shardings, and the
count is what one device holds, computes and receives (its collectives by
kind). ``--serve-2d`` is the reference's weight-stationary decode: the
batch replicated, the cache sequence-split over every axis. The record
gains ``"mesh": "16x16"``. Train steps run donated (the params and
moments updated in place, as ``launch.train`` runs them) with the
reference's microbatch count for the mesh's data size.

Where the port's partitioning departs from GSPMD's (the module docstrings
say why): the l2s head's kernels run on each device's rows with the head
gathered whole; attention whose KV heads do not divide "model" (phi3.5,
mixtral, qwen1.5-110b) runs replicated over "model"; DTensor gathers a
split product where a split op has no rule (the LSTM's gates, the SSM's
in_proj), where GSPMD may send less.

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all [--multi-pod] \\
      [--head l2s] [--no-fsdp] [--serve-2d] [--one-card] [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from typing import Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, L2SConfig,
                                 TrainConfig, get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.loader import input_specs
from repro_torch.launch.mesh import (HBM_BYTES, data_axes,
                                     make_production_mesh, mesh_axis_sizes,
                                     mesh_name)
from repro_torch.launch.op_cost import count_cost
from repro_torch.launch.roofline import roofline_from_cost
from repro_torch.launch.sharding import (NamedSharding, batch_shardings,
                                        cache_shardings, distribute,
                                        params_shardings, screen_shardings)
from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, abstract_screen,
                                      default_microbatches, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_flatten, tree_unflatten
from repro_torch.utils import shard
from repro_torch.utils.pytree import tree_bytes, tree_size

# long_500k on pure full-attention dense archs runs the sliding-window
# DECODE VARIANT, the reference's: a ring-buffer cache of this size.
SWA_VARIANT_WINDOW = 4096


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no decode step (DESIGN §5)"
    return True, ""


def decode_window(cfg: ModelConfig, shape: ShapeConfig):
    """(window, variant_tag) for decode shapes."""
    if shape.name != "long_500k":
        return cfg.sliding_window, ""
    if cfg.supports_long_context():
        return cfg.sliding_window, ""
    return SWA_VARIANT_WINDOW, "swa-variant"


def _step_and_args(model: Model, shape: ShapeConfig, head: str):
    """(step, its arguments on meta, autograd on) for one combination."""
    cfg = model.cfg
    aparams = abstract_params(model)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        mb = default_microbatches(cfg, shape.global_batch, shape.seq_len, 1)
        step = make_train_step(model, TrainConfig(microbatch=mb), donate=True)
        return step, (aparams, abstract_opt_state(aparams), specs), True
    if shape.kind == "prefill":
        return make_prefill_step(model), (aparams, specs), False
    window, _ = decode_window(cfg, shape)
    acache = abstract_cache(model, shape.global_batch, shape.seq_len,
                            window=window)
    tail = (acache, specs["token"], specs["pos"])
    if head == "l2s":
        return (make_serve_step(model, head="l2s", window=window),
                (aparams, *abstract_screen(cfg, L2SConfig()), *tail), False)
    return make_serve_step(model, head="full", window=window), \
        (aparams, *tail), False


def lower_combo(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                head: str = "full", expert_parallel: Optional[bool] = None,
                fsdp: bool = True, serve_2d: bool = False):
    """Count one step of (``cfg``, ``shape``) on meta. → a result record.

    ``mesh`` None: one card, the record as it always was. A ``DeviceMesh``
    (``launch/mesh.py``, entered): the step's arguments are DTensors at the
    reference's placements and the count is one device's (the module
    docstring); ``expert_parallel`` None is automatic (the experts divide
    "model"), ``fsdp`` adds the data-axis weight sharding, ``serve_2d``
    replicates the decode batch and sequence-shards the cache."""
    if mesh is not None:
        return _lower_on_mesh(cfg, shape, mesh, head, expert_parallel, fsdp,
                              serve_2d)
    model = Model(cfg)
    step, args, grad = _step_and_args(model, shape, head)
    unread = _unread(cfg, shape, args)
    arg_bytes = tree_bytes(list(args)) - tree_bytes(unread)
    t0 = time.time()
    with torch.set_grad_enabled(grad):
        out, cost = count_cost(step, *args)
    rec = _record(cfg, shape, head, time.time() - t0)
    rec["params"] = tree_size(args[0])
    rec["memory"] = {
        "param_bytes": tree_bytes(args[0]),
        "argument_bytes": arg_bytes,
        "output_bytes": _out_bytes(out, _nbytes),
        "temp_bytes": cost.peak_bytes,
    }
    rl = roofline_from_cost(cost, cfg.dtype)
    rec["roofline"] = {**rl.as_dict(), "bound_s": rl.bound_time_s}
    rec["fits_one_card"] = arg_bytes + cost.peak_bytes <= HBM_BYTES
    return rec


def _unread(cfg: ModelConfig, shape: ShapeConfig, args) -> list:
    """The reference's jit drops an argument its step never reads: the
    decode position, which the LSTM and SSM layers ignore."""
    return args[-1:] if shape.kind == "decode" and \
        cfg.family in ("lstm", "ssm") else []


def _record(cfg: ModelConfig, shape: ShapeConfig, head: str,
            seconds: float) -> dict:
    rec = {"arch": cfg.name, "shape": shape.name, "head": head,
           "count_s": round(seconds, 1)}
    if shape.kind == "decode":
        _, variant = decode_window(cfg, shape)
        if variant:
            rec["variant"] = variant
    return rec


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_nbytes(t: torch.Tensor) -> int:
    """One device's bytes of a tensor: a DTensor's local shard."""
    return _nbytes(t.to_local() if shard.is_dtensor(t) else t)


def _out_bytes(out, nbytes) -> int:
    # a donated step returns its arguments' own tensors: count each once
    outs = {id(t): t for t in tree_flatten(list(out))
            if isinstance(t, torch.Tensor)}
    return sum(nbytes(t) for t in outs.values())


def mesh_step(cfg: ModelConfig, shape: ShapeConfig, mesh, head: str = "full",
              expert_parallel: Optional[bool] = None, fsdp: bool = True,
              serve_2d: bool = False):
    """The reference's ``lower_combo`` logic on a mesh: → (step, its
    arguments on meta, their shardings, its results' shardings, autograd
    on)."""
    model = Model(cfg)
    sizes = mesh_axis_sizes(mesh)
    daxes = data_axes(mesh)
    dsize = math.prod(sizes[a] for a in daxes)
    if expert_parallel is None:
        # automatic: expert-parallel where the experts divide the model axis
        expert_parallel = (cfg.moe is not None and
                           cfg.moe.num_experts % sizes["model"] == 0)
    aparams = abstract_params(model)
    psh = params_shardings(mesh, cfg, aparams,
                           expert_parallel=expert_parallel, fsdp=fsdp)
    specs = input_specs(cfg, shape)
    bsh = batch_shardings(mesh, cfg, specs)
    rep = NamedSharding(mesh, ())
    B = shape.global_batch
    if shape.kind == "train":
        mb = default_microbatches(cfg, B, shape.seq_len, dsize)
        step = make_train_step(model, TrainConfig(microbatch=mb), donate=True)
        aopt = abstract_opt_state(aparams)
        osh = AdamWState(step=rep, mu=psh, nu=psh)
        args = (aparams, aopt, specs)
        in_sh = (psh, osh, bsh)
        out_sh = (psh, osh, {"loss": rep, "gnorm": rep})
        grad = True
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        args, in_sh = (aparams, specs), (psh, bsh)
        out_sh = (NamedSharding(mesh, (daxes,)),) * 2
        grad = False
    else:
        window, _ = decode_window(cfg, shape)
        acache = abstract_cache(model, B, shape.seq_len, window=window)
        csh = cache_shardings(mesh, cfg, acache, force_seq_shard=serve_2d)
        tok_sh = rep if serve_2d else bsh["token"]
        vec = NamedSharding(mesh, (daxes,) if B % dsize == 0 and B > 1 and
                            not serve_2d else ())
        tail = (acache, specs["token"], specs["pos"])
        tail_sh = (csh, tok_sh, rep)
        if head == "l2s":
            ascreen = abstract_screen(cfg, L2SConfig())
            step = make_serve_step(model, head="l2s", window=window)
            args = (aparams, *ascreen, *tail)
            in_sh = (psh, *screen_shardings(mesh, ascreen), *tail_sh)
        else:
            step = make_serve_step(model, head="full", window=window)
            args, in_sh = (aparams, *tail), (psh, *tail_sh)
        out_sh = (vec, vec, csh)
        grad = False
    return step, args, in_sh, out_sh, grad


def _lower_on_mesh(cfg, shape, mesh, head, expert_parallel, fsdp, serve_2d):
    """``lower_combo`` on a mesh: the step's arguments DTensors at its
    in shardings, its results redistributed to its out shardings, counted
    on one device."""
    from torch.distributed.tensor.experimental import implicit_replication
    step, args, in_sh, out_sh, grad = mesh_step(
        cfg, shape, mesh, head, expert_parallel, fsdp, serve_2d)
    dargs = [distribute(a, s) for a, s in zip(args, in_sh)]
    unread = _unread(cfg, shape, dargs)
    arg_bytes = sum(_local_nbytes(t) for t in tree_flatten(dargs)) - \
        sum(_local_nbytes(t) for t in tree_flatten(unread))

    def sharded_step(*a):
        # the reference's out_shardings: each result redistributed to its
        # placements, inside the count
        out = step(*a)
        return tree_unflatten(out, [
            t.redistribute(t.device_mesh, sh.placements)
            if shard.is_dtensor(t) and tuple(t.placements) != sh.placements
            else t for t, sh in zip(tree_flatten(out), tree_flatten(out_sh))])

    t0 = time.time()
    with torch.set_grad_enabled(grad), shard.use_mesh(mesh), \
            implicit_replication():
        out, cost = count_cost(sharded_step, *dargs)
    rec = _record(cfg, shape, head, time.time() - t0)
    rec["mesh"] = mesh_name(mesh)
    rec["params"] = tree_size(args[0])
    rec["memory"] = {
        "param_bytes": sum(_local_nbytes(t) for t in tree_flatten(dargs[0])),
        "argument_bytes": arg_bytes,
        "output_bytes": _out_bytes(out, _local_nbytes),
        "temp_bytes": cost.peak_bytes,
    }
    rl = roofline_from_cost(cost, cfg.dtype)
    rec["roofline"] = {**rl.as_dict(), "bound_s": rl.bound_time_s}
    rec["fits_one_card"] = arg_bytes + cost.peak_bytes <= HBM_BYTES
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (default 16x16)")
    ap.add_argument("--one-card", action="store_true",
                    help="one unsharded card, no mesh")
    ap.add_argument("--head", default="full", choices=["full", "l2s"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--serve-2d", action="store_true",
                    help="weight-stationary 2D decode sharding")
    ap.add_argument("--json", default=None, help="append records to this file")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    if args.one_card and (args.multi_pod or args.no_fsdp or args.serve_2d):
        ap.error("--one-card takes no mesh option")

    records = []
    with (contextlib.nullcontext() if args.one_card else
          make_production_mesh(multi_pod=args.multi_pod)) as mesh:
        where = {} if mesh is None else {"mesh": mesh_name(mesh)}
        for a in archs:
            cfg = get_config(a)
            for s in shapes:
                shape = INPUT_SHAPES[s]
                ok, why = applicable(cfg, shape)
                if not ok:
                    rec = {"arch": a, "shape": s, "skipped": why, **where}
                    print(json.dumps(rec), flush=True)
                    records.append(rec)
                    continue
                if args.head == "l2s" and shape.kind != "decode":
                    continue
                try:
                    rec = lower_combo(cfg, shape, mesh, head=args.head,
                                      fsdp=not args.no_fsdp,
                                      serve_2d=args.serve_2d)
                except Exception as e:
                    rec = {"arch": a, "shape": s, "head": args.head, **where,
                           "error": f"{type(e).__name__}: {e}"[:300]}
                print(json.dumps(rec), flush=True)
                records.append(rec)
    if args.json:
        with open(args.json, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    errs = [r for r in records if "error" in r]
    print(f"\n[dryrun] {len(records)} combos, {len(errs)} errors",
          file=sys.stderr)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
