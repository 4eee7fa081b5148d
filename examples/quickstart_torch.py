"""Quickstart on the PyTorch port: the paper end-to-end, the twin of
``examples/quickstart.py`` at the same sizes.

1. train a small LSTM LM on the synthetic Zipf–Markov corpus
2. harvest context vectors + exact top-5 labels (Algorithm 1 line 2)
3. fit L2S (spherical-kmeans init → Gumbel-ST + knapsack alternation)
4. compare screened vs exact softmax: precision@k and wall-clock speedup

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the card by default).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import heads
from repro_torch.configs import L2SConfig, TrainConfig, get_config
from repro_torch.core import collect_contexts, fit_l2s, precision_at_k
from repro_torch.core.evaluate import (avg_candidate_size, exact_topk,
                                       speedup_model)
from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw_init

VOCAB, D = 4000, 128


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)

    # ---- 1. train a small LM ----------------------------------------------
    cfg = dataclasses.replace(get_config("ptb-small-lstm"), vocab_size=VOCAB,
                              d_model=D, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    corpus = ZipfMarkovCorpus(VOCAB, branching=64, seed=0)
    tcfg = TrainConfig(lr=2e-3, total_steps=300, warmup_steps=20,
                       remat="none", loss_chunk=None)
    step = make_train_step(model, tcfg)
    opt = adamw_init(params)
    print("training LM ...")
    for batch in BatchLoader(make_lm_batches(corpus, 300, 16, 64, seed=1),
                             dev):
        params, opt, m = step(params, opt, batch)
    print(f"  final loss {float(m['loss']):.3f}")

    # ---- 2. harvest contexts ------------------------------------------------
    H, y = collect_contexts(
        model, params,
        [b["tokens"] for b in BatchLoader(
            make_lm_batches(corpus, 40, 16, 64, seed=99), dev)],
        max_vectors=30_000)
    Htr, Hte = H[:25_000], H[25_000:]
    print(f"harvested {len(H)} context vectors")

    # ---- 3. fit L2S (the paper's Algorithm 1) ------------------------------
    t0 = time.time()
    state = fit_l2s(Htr, y[:25_000], VOCAB,
                    L2SConfig(num_clusters=100, budget=150, outer_iters=3,
                              sgd_steps=200), verbose=True, device=dev)
    print(f"L2S fitted in {time.time() - t0:.0f}s")

    # ---- 4. evaluate (decode heads from the registry) -----------------------
    W, b = model.softmax_weights(params)
    head = heads.get("screened", W=W, b=b, screen=state.screen, device=dev)
    ex = exact_topk(W, b, Hte, 5)
    with torch.inference_mode():
        pred = head.topk(torch.as_tensor(Hte, device=dev), 5)[0].cpu().numpy()
    p1 = precision_at_k(pred[:, :1], ex[:, :1])
    p5 = precision_at_k(pred, ex)
    lbar = avg_candidate_size(state.screen, Hte)

    hq = torch.as_tensor(Hte[:256], device=dev)
    exact_head = heads.get("exact", W=W, b=b, device=dev)
    times = {}
    with torch.inference_mode():
        for hd in (exact_head, head):       # warmup
            hd.topk(hq, 5)
        for hd in (exact_head, head):
            sync(dev)
            t0 = time.perf_counter()
            hd.topk(hq, 5)
            sync(dev)
            times[hd.name] = time.perf_counter() - t0

    print(f"\nP@1={p1:.3f}  P@5={p5:.3f}  L̄={lbar:.0f} words "
          f"(budget 150, vocab {VOCAB})")
    print(f"measured speedup {times['exact'] / times['screened']:.1f}x on "
          f"{dev.type} | analytic O(L·d)/O((r+L̄)·d) "
          f"= {speedup_model(VOCAB, D, 100, lbar):.1f}x")
    print(f"head cost models (flops/query): "
          f"exact={exact_head.flops_per_query:.0f} "
          f"screened={head.flops_per_query:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
