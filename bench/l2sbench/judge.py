"""What decides ``correct``: the served tokens held to the plain reference.

After the window the harness takes a sample of the finished requests
(drawn from the seed, the one with the most served tokens always in it),
and the reference runs once over each prompt with its served tokens,
float32, from weights and a screen it draws again from the seed. At each
served position it holds the token the program chose against the
reference's logits z = W·h + b:

* ``exact`` head: ``logit_gap`` = the reference's best logit minus the
  served token's.
* ``screened-cuda`` head (a route to one cluster, then its candidate
  blocks): ``route_gap`` = how far the best-scoring cluster that holds the
  token lies below the reference's best route score, in units of the
  spread (standard deviation) of that position's route scores; with
  clusters within the route limit counted as routes the program may have
  taken, ``logit_gap`` = the least, over those clusters, of their best
  candidate logit minus the served token's.

Both count in ``outside`` the tokens that lie outside the vocabulary or,
screened, that no cluster's candidates hold.

The numbers of a cell are the widest over its positions. Each has its
limit in ``bench/limits/<workload>.json``, set from the program's
readings over a dozen seeds and the control's (``calibrate.py``).

The control (``control_tokens``) is the reference in the program's place,
in the precision below the configuration's: at each of the same positions
it takes the token its own logits (and, screened, its own route) put
first, and that token is judged in the same way.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

ROWS = 256          # positions scored at a time


def teacher_forced_hidden(ref, w, cfg, samples, prec, device,
                          rows: int = 64) -> torch.Tensor:
    """The reference's h at every served position of ``samples`` (each a
    (prompt, served tokens) pair), in sample order → (positions, d): the
    h that predicts each served token, from the prompt and the tokens
    served before it. Runs ``rows`` samples at a time, right-padded."""
    outs = []
    with prec.scope(), torch.inference_mode():
        for i in range(0, len(samples), rows):
            part = samples[i:i + rows]
            seqs = [np.concatenate([p, t[:-1]]).astype(np.int64)
                    for p, t in part]
            T = max(len(s) for s in seqs)
            toks = np.zeros((len(seqs), T), np.int64)
            for j, s in enumerate(seqs):
                toks[j, :len(s)] = s
            h = ref.hidden(w, cfg, torch.as_tensor(toks, device=device),
                           prec)
            for j, (p, t) in enumerate(part):
                outs.append(h[j, len(p) - 1:len(p) - 1 + len(t)])
    return torch.cat(outs)


def _logits(H, W, b, prec):
    return prec.mm(H, W.float().T) + b.float()


class Screen:
    """The screen as the reference reads it: v (r, d), the candidate
    blocks per cluster, and which clusters hold each block."""

    def __init__(self, v, cand, vocab: int, block: int):
        self.v = v.float()
        self.cand = cand.long()
        self.vocab, self.block = int(vocab), int(block)
        n_blk = -(-self.vocab // self.block)
        member = torch.zeros((v.shape[0], n_blk), dtype=torch.bool,
                             device=v.device)
        member.scatter_(1, self.cand, True)
        self.member = member                              # (r, n_blk)
        lane = torch.arange(self.block, device=v.device)
        words = self.cand[:, :, None] * self.block + lane  # (r, K, blk)
        self.words = words.reshape(v.shape[0], -1)
        self.real = self.words < self.vocab


def judge(H, tokens, W, b, screen: Optional[Screen],
          route_limit: Optional[float], prec) -> Dict[str, float]:
    """The widest gaps of ``tokens`` (positions,) at the reference hidden
    states ``H`` (positions, d); ``screen`` None for the exact head."""
    tok = torch.as_tensor(tokens, device=H.device).long()
    V = W.shape[0]
    # a token outside the vocabulary (a sentinel id) is a wrong answer
    bad = (tok < 0) | (tok >= V)
    out = {"positions": int(tok.numel()), "logit_gap": 0.0,
           "outside": int(bad.sum())}
    if screen is not None:
        out["route_gap"] = 0.0
    H, tok = H[~bad], tok[~bad]
    with prec.scope(), torch.inference_mode():
        for i in range(0, tok.numel(), ROWS):
            h, t = H[i:i + ROWS].float(), tok[i:i + ROWS]
            z = _logits(h, W, b, prec)
            zt = z.gather(1, t[:, None])[:, 0]
            if screen is None:
                gap = z.max(dim=1).values - zt
                out["logit_gap"] = max(out["logit_gap"], float(gap.max()))
                continue
            s = prec.mm(h, screen.v.T)                         # (n, r)
            rel = (s.max(dim=1, keepdim=True).values - s) \
                / s.std(dim=1, keepdim=True)
            holds = screen.member[:, t // screen.block].T      # (n, r)
            inf = torch.full_like(rel, float("inf"))
            rgap = torch.where(holds, rel, inf).min(dim=1).values
            outside = ~holds.any(dim=1)
            out["outside"] += int(outside.sum())
            if bool((~outside).any()):
                out["route_gap"] = max(out["route_gap"],
                                       float(rgap[~outside].max()))
            # best candidate logit of every cluster at every position
            zw = z.gather(1, screen.words.clamp(max=z.shape[1] - 1)
                          .reshape(1, -1).expand(z.shape[0], -1))
            zw = zw.reshape(z.shape[0], screen.words.shape[0], -1)
            zw = torch.where(screen.real[None], zw, float("-inf"))
            best = zw.max(dim=2).values                        # (n, r)
            allowed = holds & (rel <= (route_limit if route_limit is not None
                                       else float("inf")))
            # a token held only by clusters past the route limit is judged
            # against the nearest of them
            near = holds & (rel <= rgap[:, None])
            use = torch.where(allowed.any(dim=1, keepdim=True), allowed, near)
            gap = torch.where(use, best - zt[:, None], inf).min(dim=1).values
            gap = gap[~outside]
            if gap.numel():
                out["logit_gap"] = max(out["logit_gap"], float(gap.max()))
    return out


def control_tokens(Hc, W, b, screen: Optional[Screen], prec) -> torch.Tensor:
    """The tokens the control puts first at hidden states ``Hc`` (the
    reference's, computed in the control's precision)."""
    outs = []
    with prec.scope(), torch.inference_mode():
        for i in range(0, Hc.shape[0], ROWS):
            h = Hc[i:i + ROWS].float()
            z = _logits(h, W, b, prec)
            if screen is None:
                outs.append(z.argmax(dim=1))
                continue
            c = prec.mm(h, screen.v.T).argmax(dim=1)          # (n,)
            words = screen.words[c]                            # (n, K·blk)
            zw = z.gather(1, words.clamp(max=z.shape[1] - 1))
            zw = torch.where(screen.real[c], zw, float("-inf"))
            outs.append(words.gather(1, zw.argmax(dim=1, keepdim=True))[:, 0])
    return torch.cat(outs)


def pick_sample(sizes: np.ndarray, n: int, rng) -> List[int]:
    """Indices of ``n`` finished requests drawn with ``rng``, ``sizes``
    their (served tokens, prompt length) rows: the one with the most
    served tokens (then the longest prompt) always among them."""
    if len(sizes) == 0:
        return []
    first = -np.arange(len(sizes))             # ties: the first of them
    longest = int(np.lexsort((first, sizes[:, 1], sizes[:, 0]))[-1])
    rest = [i for i in range(len(sizes)) if i != longest]
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[int(j)] for j in sorted(take)]
