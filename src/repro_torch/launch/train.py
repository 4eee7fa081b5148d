"""Training launcher: ``python -m repro_torch.launch.train --arch
ptb-small-lstm ...``. Twin of ``repro/launch/train.py`` for every ported
family: the LSTMs, the dense transformers (``smollm-360m``, ``gemma-2b``,
``starcoder2-3b``, ``qwen1.5-110b``), the moe transformers
(``mixtral-8x7b``, ``phi3.5-moe-42b-a6.6b``; the loss carries their
load-balance aux), ``mamba2-1.3b`` (ssm), ``zamba2-2.7b`` (hybrid),
``qwen2-vl-2b`` (vlm: each batch adds ``patches`` (B, P, d), the loss over
the text) and ``hubert-xlarge`` (audio: ``frames`` (B, seq, d) float32 and
the corpus's labels mod the 504 units). Patches and frames are drawn from
``np.random.default_rng(seed + i)`` for the i-th batch of the run, as the
reference's launcher draws them.

Trains on the synthetic Zipf–Markov corpus on ``--device`` (the card by
default; ``--device cpu`` with ``--reduced`` is the CPU smoke), printing the
reference's ``[train]`` lines, and saves / resumes ``(params, opt_state)``
under ``--ckpt-dir`` (a resumed run with no step left saves nothing).
Weights are float32 whatever the config's dtype, and
``remat="none"``, ``loss_chunk=None``, as the reference's launcher sets them;
they are drawn from a CPU generator, so a seed gives the same weights on any
device (a full-width zamba2-2.7b takes tens of seconds to draw). The step
updates params and optimizer state in place (``donate=True``). The
corpus's host build time is printed (``[train] corpus``): gemma-2b's
256,000 words go through the fast draw of ``data/synthetic.py``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
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
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = Model(cfg)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1),
                       remat="none", loss_chunk=None)
    params = model.init(torch.Generator().manual_seed(args.seed), device=dev,
                        dtype=torch.float32)
    opt_state = adamw_init(params)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), meta = load_checkpoint(args.ckpt_dir,
                                                    (params, opt_state))
        start = meta.get("step", 0)
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(model, tcfg, donate=True)
    t0 = time.time()
    corpus = ZipfMarkovCorpus(cfg.vocab_size,
                              branching=min(64, cfg.vocab_size // 4),
                              seed=args.seed)
    print(f"[train] corpus of {cfg.vocab_size} words built in "
          f"{time.time() - t0:.1f} s")
    batches = BatchLoader(family_batches(
        cfg, make_lm_batches(corpus, args.steps - start, args.batch,
                             args.seq, seed=args.seed + start), args.seed),
        dev)
    t0 = time.time()
    for i, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        step = start + i + 1
        if step % args.log_every == 0 or step == args.steps:
            print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} "
                  f"({(time.time() - t0) / max(i + 1, 1):.2f}s/step)")
    # a resumed run with no step left to train writes nothing: its
    # checkpoint would be the one it loaded (27.8 GB for zamba2-2.7b)
    if args.ckpt_dir and args.steps > start:
        save_checkpoint(args.ckpt_dir, args.steps, (params, opt_state),
                        {"step": args.steps, "arch": cfg.name})
        print(f"[train] saved checkpoint at step {args.steps}")
    return 0


def family_batches(cfg, batches, seed: int):
    """The LM batches as the family trains on them (numpy, the reference's
    launcher's arrays): audio takes float32 frames (B, seq, d) and the
    labels mod its vocabulary, vlm adds patches (B, P, d) float32, each
    drawn from ``default_rng(seed + i)`` for the run's i-th batch."""
    for i, batch in enumerate(batches):
        if cfg.family in ("audio", "vlm"):
            rng = np.random.default_rng(seed + i)
            B, T = batch["tokens"].shape
            if cfg.family == "audio":
                batch = {"frames": rng.standard_normal(
                            (B, T, cfg.d_model)).astype(np.float32),
                         "labels": batch["labels"] % cfg.vocab_size}
            else:
                batch = dict(batch, patches=rng.standard_normal(
                    (B, cfg.num_patch_tokens, cfg.d_model)).astype(
                        np.float32))
        yield batch


if __name__ == "__main__":
    raise SystemExit(main())
