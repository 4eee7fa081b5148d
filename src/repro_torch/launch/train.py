"""Training launcher: ``python -m repro_torch.launch.train --arch
ptb-small-lstm ...``. Twin of ``repro/launch/train.py``, LSTM families only.

Trains on the synthetic Zipf–Markov corpus on ``--device`` (the card by
default; ``--device cpu`` with ``--reduced`` is the CPU smoke), printing the
reference's ``[train]`` lines, and saves / resumes ``(params, opt_state)``
under ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ptb-small-lstm")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke variant (CPU-friendly)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family != "lstm":
        raise NotImplementedError(
            f"{cfg.name}: repro_torch trains the LSTM family only so far "
            f"(got {cfg.family!r}; SSM and hybrid training: ROADMAP.md, "
            f"Queue 1)")
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = Model(cfg)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1),
                       remat="none", loss_chunk=None)
    params = model.init(torch.Generator().manual_seed(args.seed), device=dev)
    opt_state = adamw_init(params)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), meta = load_checkpoint(args.ckpt_dir,
                                                    (params, opt_state))
        start = meta.get("step", 0)
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(model, tcfg)
    corpus = ZipfMarkovCorpus(cfg.vocab_size,
                              branching=min(64, cfg.vocab_size // 4),
                              seed=args.seed)
    batches = BatchLoader(make_lm_batches(corpus, args.steps - start,
                                          args.batch, args.seq,
                                          seed=args.seed + start), dev)
    t0 = time.time()
    for i, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        step = start + i + 1
        if step % args.log_every == 0 or step == args.steps:
            print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} "
                  f"({(time.time() - t0) / max(i + 1, 1):.2f}s/step)")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, (params, opt_state),
                        {"step": args.steps, "arch": cfg.name})
        print(f"[train] saved checkpoint at step {args.steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
