"""Serving launcher: batched generation with optional L2S screened softmax.
Twin of ``repro/launch/serve.py``.

``python -m repro_torch.launch.serve --arch ptb-small-lstm --reduced --l2s
--device cpu`` trains a tiny LM on the synthetic corpus, fits the screen
(Algorithm 1; a word-level screen, so the fast head is ``screened``), and
serves ``ServeRequest`` batches through both heads via
``DecodeEngine.serve_batch`` + ``StaticPolicy``, reporting decode time and
token agreement. ``--device`` is ``cuda`` (the default) or ``cpu``.

``--scheduler`` serves the same traffic through the continuous-batching
``ContinuousScheduler`` instead: mixed latency tiers, a ``BudgetAdmission``
policy against the head catalog's flops numbers, and a ``ServerStats``
report (admit/reject/downgrade counts, per-head tokens/s, p50/p95
latency). It serves with no paged KV pool on every family: the pool is
not ported yet (ROADMAP.md, Queue 1 item 8), and neither is speculative
decoding, so ``--draft-head`` exits 2.

A fast head that needs a screen (``--head screened`` without ``--l2s``)
fails BEFORE training with exit code 2 and the fix-it message — the
screening factories raise a typed ``MissingScreenError``.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch import heads as heads_registry
from repro_torch.configs import L2SConfig, TrainConfig, get_config
from repro_torch.core import collect_contexts, fit_l2s
from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
from repro_torch.device import resolve_device
from repro_torch.heads import MissingScreenError
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw_init
from repro_torch.serving import (BudgetAdmission, ContinuousScheduler,
                                 DecodeEngine, ServeRequest, ServeResult,
                                 StaticPolicy, TierPolicy)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ptb-small-lstm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--l2s", action="store_true")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the continuous-batching "
                         "ContinuousScheduler (admission control + live "
                         "ServerStats) instead of one serve_batch call")
    ap.add_argument("--head", default=None,
                    help="registry name of the fast decode head served "
                         "against exact (screened, screened-cuda); "
                         "defaults to screened when --l2s fits a screen")
    ap.add_argument("--draft-head", default=None,
                    help="speculative decoding's draft head: not ported yet "
                         "(exits 2)")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="--scheduler only: write one structured JSON "
                         "record per scheduler tick (numeric stats deltas "
                         "+ breaker states) to PATH; the human-readable "
                         "summary lines are unchanged")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--clusters", type=int, default=50)
    ap.add_argument("--budget", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family != "lstm":
        raise NotImplementedError(
            f"{cfg.name}: the launcher trains its LM first, and repro_torch "
            f"trains the LSTM family only so far (got {cfg.family!r}; "
            f"ROADMAP.md, Queue 1 item 5b)")
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), device=dev)

    # fail FAST on a screening head without --l2s: probe the factory with a
    # tiny weight slice BEFORE spending time on training. Screening heads
    # raise MissingScreenError from their constructor regardless of shapes;
    # any other failure is inconclusive at probe scale (the head may just
    # need the real tables) and is re-raised properly after training.
    head_name = args.head if args.head is not None else \
        ("screened" if args.l2s else None)
    # an unknown head name is conclusive NOW (the registry is static) — a
    # typo must not cost a full training run before the KeyError surfaces
    if head_name is not None and head_name not in heads_registry.names():
        print(f"[serve] unknown head {head_name!r}; registered: "
              f"{heads_registry.names()}")
        return 2
    if head_name not in (None, "exact") and not args.l2s:
        W0, b0 = model.softmax_weights(params)
        try:
            heads_registry.get(head_name, W=W0[:8], b=b0[:8], screen=None,
                               device=dev)
        except MissingScreenError as e:
            print(f"[serve] cannot build head {head_name!r}: {e} "
                  f"(pass --l2s to fit one)")
            return 2
        except Exception:
            pass
    if args.draft_head is not None:
        print("[serve] --draft-head: speculative decoding is not ported to "
              "repro_torch yet (ROADMAP.md, Queue 1 item 8)")
        return 2
    if args.log_jsonl is not None and not args.scheduler:
        print("[serve] --log-jsonl needs --scheduler: the per-tick records "
              "come from the ContinuousScheduler's tick loop")
        return 2

    corpus = ZipfMarkovCorpus(cfg.vocab_size,
                              branching=min(64, cfg.vocab_size // 4),
                              seed=args.seed)

    # quick train so context vectors are meaningful
    tcfg = TrainConfig(lr=1e-3, total_steps=args.train_steps,
                       warmup_steps=10, remat="none", loss_chunk=None)
    step_fn = make_train_step(model, tcfg)
    opt_state = adamw_init(params)
    for batch in BatchLoader(make_lm_batches(corpus, args.train_steps, 16,
                                             64, seed=1), dev):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
    print(f"[serve] trained {args.train_steps} steps, loss "
          f"{float(metrics['loss']):.3f}")

    screen = None
    if args.l2s:
        batches = [b["tokens"] for b in BatchLoader(
            make_lm_batches(corpus, 16, 16, 64, seed=7), dev)]
        H, y = collect_contexts(model, params, batches, max_vectors=15_000)
        state = fit_l2s(H, y, cfg.vocab_size,
                        L2SConfig(num_clusters=args.clusters,
                                  budget=args.budget, outer_iters=2,
                                  sgd_steps=100), device=dev)
        screen = state.screen
        print(f"[serve] L2S fitted: r={args.clusters} "
              f"C_max={screen.c_max} block={screen.block}")

    engine = DecodeEngine(model, params, screen=screen,
                          max_len=args.prompt_len + args.max_new, device=dev)
    prompts = corpus.sample_batch(args.requests, args.prompt_len, seed=42)
    requests = [ServeRequest(prompt=p, max_new=args.max_new)
                for p in prompts]

    if args.scheduler:
        return _serve_scheduler(engine, requests, head_name,
                                log_jsonl=args.log_jsonl)

    t0 = time.time()
    exact = engine.serve_batch(requests, policy=StaticPolicy("exact"))
    t_exact = time.time() - t0
    print(f"[serve] exact decode: {args.requests}×{args.max_new} tokens "
          f"in {t_exact:.2f}s")
    if head_name is not None and head_name != "exact":
        try:
            engine.resolve_head(head_name)
        except MissingScreenError as e:       # safety net — probed above
            print(f"[serve] cannot build head {head_name!r}: {e} "
                  f"(pass --l2s to fit one)")
            return 2
        t0 = time.time()
        fast = engine.serve_batch(requests, policy=StaticPolicy(head_name))
        t_fast = time.time() - t0
        agree = float(np.mean([
            (f.tokens == e.tokens).mean() for f, e in zip(fast, exact)]))
        print(f"[serve] {head_name} decode:  {t_fast:.2f}s  "
              f"token agreement {agree:.3f}")
    return 0


def _tick_delta(prev: dict, cur: dict) -> dict:
    """Numeric top-level deltas between two ``ServerStats.snapshot()``s —
    the per-tick payload of ``--log-jsonl`` (counters that didn't move are
    omitted, so quiet ticks stay one short line)."""
    out = {}
    for k, v in cur.items():
        p = prev.get(k, 0)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if not isinstance(p, (int, float)) or not math.isfinite(v) \
                or not math.isfinite(p):
            continue
        if v != p:
            out[k] = v - p
    return out


def _serve_scheduler(engine, requests, head_name, log_jsonl=None):
    """--scheduler mode: continuous batching with admission control.

    Traffic is the launcher's request set re-tiered round-robin
    (realtime / standard / batch); the fast head (when available) serves
    the realtime tier, "exact" everything else. The flops budget is sized
    to the catalog so a burst sheds load through the typed reject path.
    Every family serves without a paged KV pool (not ported yet)."""
    import dataclasses

    fast = head_name if head_name not in (None, "exact") else None
    candidates = tuple(dict.fromkeys(filter(None, (fast, "exact"))))
    catalog = engine.head_catalog(candidates)
    if fast is not None and fast not in catalog:
        fast = None                      # unbuildable in this engine
    policy = TierPolicy({"realtime": fast or "exact"}, default="exact")
    budget = 4.0 * max(m["flops_per_query"] for m in catalog.values())
    tiers = ["realtime", "standard", "batch"]
    traffic = [dataclasses.replace(r, latency_tier=tiers[i % 3])
               for i, r in enumerate(requests)]
    print("[serve] scheduler: no paged KV pool (serving/kvpool is not "
          "ported yet: ROADMAP.md, Queue 1 item 8)")
    sched = ContinuousScheduler(engine, policy=policy,
                                admission=BudgetAdmission(flops_budget=budget),
                                max_slots=4)
    t0 = time.time()
    if log_jsonl is None:
        results = sched.serve(traffic)
    else:
        # submit-all + explicit tick loop so every tick emits one
        # structured record (stats delta + breaker states); identical
        # serving behavior to sched.serve(traffic)
        for r in traffic:
            sched.submit(r)
        prev = sched.stats.snapshot()
        with open(log_jsonl, "w") as f:
            while sched.busy:
                sched.step()
                snap = sched.stats.snapshot()
                rz = snap.get("resilience") or {}
                rec = {"tick": snap["ticks"],
                       "delta": _tick_delta(prev, snap),
                       "queue_depth": snap["queue_depth"],
                       "breaker_states": rz.get("breaker_states", {})}
                f.write(json.dumps(rec) + "\n")
                prev = snap
        results = sched.results()
        print(f"[serve] per-tick JSONL log: {log_jsonl}")
    wall = time.time() - t0
    snap = sched.stats.snapshot()
    tokens = sum(len(r.tokens) for r in results if isinstance(r, ServeResult))
    print(f"[serve] scheduler: {tokens} tokens in {wall:.2f}s = "
          f"{tokens / max(wall, 1e-9):.0f} tok/s | admitted "
          f"{snap['admitted']}/{snap['submitted']} rejected "
          f"{snap['rejected']} downgraded {snap['downgraded']} "
          f"preempted {snap['preempted']}")
    print(f"[serve] scheduler: latency p50 {snap['latency']['p50_s']:.3f}s "
          f"p95 {snap['latency']['p95_s']:.3f}s | per-head "
          + ", ".join(f"{h}: {d['requests']} req {d['tokens_per_s']:.0f} "
                      f"tok/s" for h, d in snap["per_head"].items()))
    if snap.get("resilience"):
        rz = snap["resilience"]
        states = ", ".join(f"{h}: {s}" for h, s in
                           rz["breaker_states"].items()) or "all closed"
        print(f"[serve] scheduler: resilience "
              f"{rz['faults_transient']}+{rz['faults_permanent']} faults "
              f"(transient+permanent) | {rz['retries']} retries "
              f"{rz['fallbacks']} fallbacks {rz['faulted']} faulted "
              f"{rz['timed_out']} timed out | breakers {states} "
              f"(trips {rz['breaker_trips']}, half-opens "
              f"{rz['breaker_half_opens']}, closes {rz['breaker_closes']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
