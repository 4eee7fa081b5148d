"""repro_torch.heads — the pluggable decode-head API.

    from repro_torch import heads
    head = heads.get("screened-cuda", W=W, b=b, screen=screen)
    ids, logprobs = head.topk_logprobs(h, k=5)

Registered backends:

  exact           full-vocab softmax (torch GEMV)          O(L·d)
  screened        L2S route + candidate softmax (torch)    O((r+L̄)·d)
  screened-cuda   L2S on the hand-written CUDA kernels     O((r+L̄)·d)
"""
from repro_torch.heads.base import (NEG_INF, MissingScreenError,
                                    ScreenBlockError, SoftmaxHead,
                                    adjust_logits, require_screen,
                                    sample_from_logits,
                                    screened_flops_per_query)
from repro_torch.heads.registry import get, names, register
from repro_torch.heads.exact import ExactHead
from repro_torch.heads.screened import ScreenedHead
from repro_torch.heads.cuda import ScreenedCudaHead

register("exact", lambda W, b, **_: ExactHead(W, b))
register("screened", lambda W, b, screen=None, **_: ScreenedHead(W, b, screen))
register("screened-cuda",
         lambda W, b, screen=None, fused=True, **_:
         ScreenedCudaHead(W, b, screen, fused=fused))
