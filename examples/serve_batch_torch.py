"""Mixed-traffic serving demo on the PyTorch port: one DecodeEngine, many
ServeRequests, a RoutingPolicy deciding per request which softmax head
decodes it. Twin of ``examples/serve_batch.py``: it trains a small LM,
fits an L2S screen (Algorithm 1), then serves.

Run: PYTHONPATH=src python examples/serve_batch_torch.py            # on the card
     PYTHONPATH=src python examples/serve_batch_torch.py --reduced --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import L2SConfig, TrainConfig, get_config
from repro_torch.core import collect_contexts, fit_l2s
from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw_init
from repro_torch.serving import (AdmissionRejected, BudgetAdmission,
                                 ContinuousScheduler, CostAwarePolicy,
                                 DecodeEngine, ServeRequest, TierPolicy)

ap = argparse.ArgumentParser()
ap.add_argument("--reduced", action="store_true",
                help="tiny model + short decode for CI smoke runs")
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()
dev = resolve_device(args.device)

if args.reduced:
    VOCAB, D, STEPS, BATCH, NEW = 600, 64, 60, 8, 8
else:
    VOCAB, D, STEPS, BATCH, NEW = 3000, 128, 250, 16, 48

cfg = dataclasses.replace(get_config("ptb-small-lstm"), vocab_size=VOCAB,
                          d_model=D, dtype="float32")
model = Model(cfg)
params = model.init(torch.Generator().manual_seed(0), device=dev,
                    dtype=torch.float32)
corpus = ZipfMarkovCorpus(VOCAB, branching=64, seed=0)
tcfg = TrainConfig(lr=2e-3, total_steps=STEPS, warmup_steps=20,
                   remat="none", loss_chunk=None)
step_fn = make_train_step(model, tcfg, donate=True)
opt = adamw_init(params)
print("training ...")
for batch in BatchLoader(make_lm_batches(corpus, STEPS, 16, 64, seed=1), dev):
    params, opt, _ = step_fn(params, opt, batch)

H, y = collect_contexts(
    model, params,
    [b["tokens"] for b in BatchLoader(make_lm_batches(corpus, 30, 16, 64,
                                                      seed=9), dev)],
    max_vectors=20_000)
state = fit_l2s(H, y, VOCAB, L2SConfig(num_clusters=100 if not args.reduced
                                       else 16,
                                       budget=150 if not args.reduced else 48,
                                       outer_iters=2, sgd_steps=150),
                device=dev)
engine = DecodeEngine(model, params, screen=state.screen, max_len=16 + NEW,
                      device=dev)

# -- mixed traffic: every request carries its own latency tier / accuracy
#    floor, and the policy resolves each to a head. One engine, one batch.
prompts = corpus.sample_batch(BATCH, 16, seed=11)
requests = []
for i, p in enumerate(prompts):
    if i % 4 == 0:       # quality tier: caller demands exact decode
        requests.append(ServeRequest(prompt=p, max_new=NEW,
                                     latency_tier="batch",
                                     accuracy_floor=1.0))
    elif i % 4 == 1:     # explicit override: escape hatch past the policy
        requests.append(ServeRequest(prompt=p, max_new=NEW, head="exact"))
    else:                # latency tier: cheapest acceptable head
        requests.append(ServeRequest(prompt=p, max_new=NEW,
                                     latency_tier="realtime"))

policy = CostAwarePolicy(["screened", "exact"])
engine.serve_batch(requests, policy=policy)          # warmup: graphs captured
t0 = time.perf_counter()
results = engine.serve_batch(requests, policy=policy)
t_mixed = time.perf_counter() - t0
by_head = {}
for r in results:
    by_head.setdefault(r.head, []).append(r)
total_tokens = sum(len(r.tokens) for r in results)
print(f"mixed batch : {total_tokens / t_mixed:8.0f} tok/s over "
      f"{len(results)} requests -> "
      + ", ".join(f"{k}×{len(v)}" for k, v in sorted(by_head.items())))

# routed results agree with solo exact decode on most tokens
agree = np.mean([
    (r.tokens == engine.generate(r.request.prompt[None], r.request.max_new,
                                 head="exact").tokens[0]).mean()
    for r in results])
print(f"agreement vs exact: {agree:.3f}  "
      f"(screened requests trade a little fidelity for speed)")

# same engine still answers tier-mapped traffic with no new step
tier_policy = TierPolicy({"realtime": "screened", "batch": "exact"},
                         default="screened")
res2 = engine.serve_batch(requests, policy=tier_policy)
print(f"tier policy routes: "
      + ", ".join(sorted({r.head for r in res2}))
      + f"; cached steps: {engine._cache_size()}")

# -- continuous batching: the same traffic as a live stream ------------------
#    The scheduler admits each request against a flops budget from the head
#    catalog, joins it into running fixed-width decode streams and retires
#    it when done. Greedy tokens equal the serve_batch results above.
catalog = engine.head_catalog(("screened", "exact"))
sched = ContinuousScheduler(
    engine, policy=tier_policy,
    admission=BudgetAdmission(
        flops_budget=8 * max(m["flops_per_query"] for m in catalog.values())),
    max_slots=4)
t0 = time.perf_counter()
res3 = sched.serve(requests)
t_sched = time.perf_counter() - t0
snap = sched.stats.snapshot()
served = [r for r in res3 if not isinstance(r, AdmissionRejected)]
for r2, r3 in zip(res2, res3):
    if isinstance(r3, AdmissionRejected) or r3.request.temperature is not None:
        continue
    if r3.head == r2.head:                # admission may have downgraded
        assert np.array_equal(r2.tokens, r3.tokens)   # continuous == batch
print(f"scheduler   : {snap['tokens'] / t_sched:8.0f} tok/s over "
      f"{len(served)} requests (admitted {snap['admitted']}, rejected "
      f"{snap['rejected']}, downgraded {snap['downgraded']}); "
      f"p50 latency {snap['latency']['p50_s'] * 1e3:.0f}ms, "
      f"p95 {snap['latency']['p95_s'] * 1e3:.0f}ms; "
      f"cached steps: {engine._cache_size()}")
