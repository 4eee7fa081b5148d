"""repro_torch.heads — the pluggable decode-head API.

    from repro_torch import heads
    head = heads.get("screened-cuda", W=W, b=b, screen=screen)
    ids, logprobs = head.topk_logprobs(h, k=5)

Registered backends (the reference's, ``screened-pallas`` as
``screened-cuda``):

  exact           full-vocab softmax (torch GEMV)          O(L·d)
  exact-sharded   vocab-sharded exact: per-shard top-k     O(L/n·d) per shard
                  + shard-major gather and merge
  screened        L2S route + candidate softmax (torch)    O((r+L̄)·d)
  screened-sharded L2S with candidates split by the shard  O((r+L̄/n)·d) per shard
                  owning their vocab range (local="torch"
                  word path, or "cuda": the fused kernel
                  once per shard)
  screened-cuda   L2S on the hand-written CUDA kernels     O((r+L̄)·d)
  screened-cpu    L2S per-query numpy (paper timing)       O((r+L̄)·d)
  adaptive        frequency-tiered adaptive softmax        O((F+C+p·T̄)·d)
                  (short-list + lazily-gated rare tails,
                  two fused CUDA top-k launches a step)
  adaptive-sharded adaptive with the tail region split    O((F+C+p·T̄/n)·d)
                  by vocab range, the short-list           per shard
                  replicated (one fused launch per shard
                  for the tail)
  svd             SVD-softmax preview + rerank             O(d·ρ + L·ρ + Ñ·d)
  shortlist       adaptive-softmax frequent shortlist      O((n_head+τ)·d)
  greedy-mips     budgeted per-dimension screening         O(B·d)
  lsh-mips        SimHash bands + bucket rerank            O(bands·bits·d + pool·d)
  pca-mips        PCA-tree leaf + rerank                   O(depth·d + leaf·d)

The last six are numpy on the host (``is_jittable = False``): the serving
engine runs them between replays of the model's decode step.

The sharded heads take ``n_shards`` (every shard on the weights' device:
one card holds them all) or ``devices`` (shard s on ``devices[s]``); one
process drives the shards (``heads/sharded.py``).
"""
from repro_torch.heads.base import (NEG_INF, MissingScreenError,
                                    ScreenBlockError, SoftmaxHead,
                                    adjust_logits, require_screen,
                                    sample_from_logits,
                                    screened_flops_per_query,
                                    tiered_flops_per_query)
from repro_torch.heads.registry import get, names, register
from repro_torch.heads.exact import ExactHead
from repro_torch.heads.screened import ScreenedHead
from repro_torch.heads.cuda import ScreenedCudaHead
from repro_torch.heads.sharded import ExactShardedHead, ScreenedShardedHead
from repro_torch.heads.adaptive import AdaptiveHead, AdaptiveShardedHead
from repro_torch.heads.adapters import (BaselineHead, GreedyMIPSHead,
                                        LSHHead, PCAHead, ScreenedNumpyHead,
                                        ShortlistHead, SVDHead)

register("exact", lambda W, b, **_: ExactHead(W, b))
register("exact-sharded",
         lambda W, b, n_shards=None, devices=None, **_:
         ExactShardedHead(W, b, n_shards=n_shards, devices=devices))
register("screened", lambda W, b, screen=None, **_: ScreenedHead(W, b, screen))
register("screened-sharded",
         lambda W, b, screen=None, n_shards=None, devices=None, local="torch",
         **_:
         ScreenedShardedHead(W, b, screen, n_shards=n_shards, devices=devices,
                             local=local))
register("screened-cuda",
         lambda W, b, screen=None, fused=True, **_:
         ScreenedCudaHead(W, b, screen, fused=fused))
register("screened-cpu",
         lambda W, b, screen=None, **_: ScreenedNumpyHead(W, b, screen))
register("adaptive",
         lambda W, b, counts=None, shortlist=None, n_tails=4, fused=True, **_:
         AdaptiveHead(W, b, counts=counts, shortlist=shortlist,
                      n_tails=n_tails, fused=fused))
register("adaptive-sharded",
         lambda W, b, counts=None, shortlist=None, n_tails=4, n_shards=None,
         devices=None, **_:
         AdaptiveShardedHead(W, b, counts=counts, shortlist=shortlist,
                             n_tails=n_tails, n_shards=n_shards,
                             devices=devices))
register("svd", lambda W, b, rho=16, n_top=None, **_:
         SVDHead(W, b, rho=rho, n_top=n_top))
register("shortlist",
         lambda W, b, freq_order=None, n_head=None, n_tails=4, **_:
         ShortlistHead(W, b, freq_order=freq_order, n_head=n_head,
                       n_tails=n_tails))
register("greedy-mips", lambda W, b, budget=512, **_:
         GreedyMIPSHead(W, b, budget=budget))
register("lsh-mips", lambda W, b, bands=8, bits=10, seed=0, **_:
         LSHHead(W, b, bands=bands, bits=bits, seed=seed))
register("pca-mips", lambda W, b, depth=6, **_: PCAHead(W, b, depth=depth))
