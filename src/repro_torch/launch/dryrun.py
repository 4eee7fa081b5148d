"""Dry run: count one step of every (arch × input shape) on the ``meta``
device, with no card and no allocation, and report its memory and its
roofline on one H100.

Twin of ``repro/launch/dryrun.py``, which lowers and compiles each
combination for a TPU mesh and reads XLA's memory and cost analyses. The
port runs the step itself on meta tensors (shapes and dtypes only) under
``launch/op_cost.count_cost``:

* ``params`` / ``memory.param_bytes`` — the weights' count and bytes;
* ``memory.argument_bytes`` — the step's arguments: params, plus the AdamW
  state for train, plus the decode cache, plus the inputs (and the screen
  for the l2s head), less an input the step never reads, as the
  reference's jit drops it;
* ``memory.output_bytes`` — the step's results;
* ``memory.temp_bytes`` — the peak of the storage the step allocates, its
  results included while they live (``OpCost.peak_bytes``);
* ``roofline`` — ``launch/roofline.py`` over the count, at the peak of the
  config's dtype;
* ``fits_one_card`` — argument + temp bytes within the H100's 80 GB. A
  step that does not fit is a record like any other, not an error.

There is no mesh: one step on one card, as the port's launchers run. The
reference's ``--multi-pod``, ``--no-fsdp`` and ``--serve-2d`` choose TPU
meshes and GSPMD partitionings (``launch/sharding.py``), which the port
does not have (``launch/mesh.py`` says why). Train steps run donated (the
params and moments updated in place, as ``launch.train`` runs them) with
the reference's microbatch count for one data shard.

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all [--head l2s] \\
      [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, L2SConfig,
                                 TrainConfig, get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.loader import input_specs
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.launch.op_cost import count_cost
from repro_torch.launch.roofline import roofline_from_cost
from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, abstract_screen,
                                      default_microbatches, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.model import Model
from repro_torch.tree import tree_flatten
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


def lower_combo(cfg: ModelConfig, shape: ShapeConfig, head: str = "full"):
    """Count one step of (``cfg``, ``shape``) on meta. → a result record."""
    model = Model(cfg)
    step, args, grad = _step_and_args(model, shape, head)
    # the reference's jit drops an argument its step never reads: the
    # decode position, which the LSTM and SSM layers ignore
    unread = args[-1:] if shape.kind == "decode" and \
        cfg.family in ("lstm", "ssm") else []
    arg_bytes = tree_bytes(list(args)) - tree_bytes(unread)
    t0 = time.time()
    with torch.set_grad_enabled(grad):
        out, cost = count_cost(step, *args)
    rec = {"arch": cfg.name, "shape": shape.name, "head": head,
           "count_s": round(time.time() - t0, 1)}
    if shape.kind == "decode":
        _, variant = decode_window(cfg, shape)
        if variant:
            rec["variant"] = variant
    # a donated step returns its arguments' own tensors: count each once
    outs = {id(t): t for t in tree_flatten(list(out))
            if isinstance(t, torch.Tensor)}
    rec["params"] = tree_size(args[0])
    rec["memory"] = {
        "param_bytes": tree_bytes(args[0]),
        "argument_bytes": arg_bytes,
        "output_bytes": sum(t.numel() * t.element_size()
                            for t in outs.values()),
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
    ap.add_argument("--head", default="full", choices=["full", "l2s"])
    ap.add_argument("--json", default=None, help="append records to this file")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]

    records = []
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            shape = INPUT_SHAPES[s]
            ok, why = applicable(cfg, shape)
            if not ok:
                rec = {"arch": a, "shape": s, "skipped": why}
                print(json.dumps(rec), flush=True)
                records.append(rec)
                continue
            if args.head == "l2s" and shape.kind != "decode":
                continue
            try:
                rec = lower_combo(cfg, shape, head=args.head)
            except Exception as e:
                rec = {"arch": a, "shape": s, "head": args.head,
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
