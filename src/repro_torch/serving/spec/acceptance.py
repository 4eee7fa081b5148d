"""Speculative-decoding acceptance math — pure numpy, host-side. Twin of
``repro/serving/spec/acceptance.py``, kept as the port's own copy: given
the same arrays and the same ``np.random.Generator`` it draws the same bits.

Two regimes, both yielding output indistinguishable from decoding with the
TARGET (verify) head alone:

  greedy   accept the longest prefix where draft argmax == exact argmax;
           the first mismatch is replaced by the exact token. Every emitted
           token is the exact head's greedy choice — BIT-identical.

  sampled  the standard speculative rejection rule (Leviathan et al. 2023;
           Chen et al. 2023): the draft token d ~ q is accepted with
           probability min(1, p(d)/q(d)); on rejection a replacement is
           drawn from the residual normalize(max(p − q, 0)). Per position
           the emitted-token law is exactly p:

               P(emit t) = min(q(t), p(t))
                         + (1 − Σ min(q, p)) · max(p(t) − q(t), 0) / Z
                         = min(q(t), p(t)) + max(p(t) − q(t), 0) = p(t)

           (Z = Σ max(p − q, 0) = 1 − Σ min(q, p).) ``emission_distribution``
           computes the left-hand side directly so tests can pin the
           identity without Monte Carlo noise.

−inf convention: a logit row that is entirely ≤ NEG_INF/2 is the
EMPTY distribution — probability 0 everywhere, never a fake uniform (which
is what a max-shifted softmax would silently produce). An empty DRAFT row
(q = 0: the screen routed to a cluster with no candidates) auto-rejects and
the replacement is drawn from the residual max(p − 0, 0)/Z = p itself, so
emission still follows the target exactly.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.heads.base import NEG_INF


def row_probs(logits_row: np.ndarray) -> np.ndarray:
    """Softmax of one logit row in float64, honoring the empty-row
    convention: all entries ≤ NEG_INF/2 → the ZERO distribution."""
    row = np.asarray(logits_row, np.float64)
    m = float(np.max(row)) if row.size else NEG_INF
    if m <= NEG_INF / 2:
        return np.zeros_like(row)
    p = np.exp(row - m)                    # masked entries underflow to 0.0
    return p / p.sum()


def greedy_accept_lengths(draft: np.ndarray, exact: np.ndarray) -> np.ndarray:
    """(B, n) drafted ids vs (B, n) exact ids → (B,) longest matched prefix
    length per row (0..n)."""
    draft = np.asarray(draft)
    exact = np.asarray(exact)
    return np.cumprod(draft == exact, axis=1).sum(axis=1).astype(np.int64)


def accept_step(rng: np.random.Generator, d: int, q_row: np.ndarray,
                p_row: np.ndarray) -> Tuple[bool, int]:
    """One position of the rejection rule. Returns ``(accepted, token)`` —
    ``token`` is ``d`` itself on acceptance, a residual draw otherwise."""
    q = row_probs(q_row)
    p = row_probs(p_row)
    accept_prob = 0.0
    if q[d] > 0.0:
        accept_prob = min(1.0, p[d] / q[d])
    if accept_prob >= 1.0 or rng.random() < accept_prob:
        return True, int(d)
    r = np.maximum(p - q, 0.0)
    z = r.sum()
    if z <= 0.0:
        # p ≤ q everywhere after a rejection can only be float round-off
        # (exact p == q rejects with probability 0); fall back to p itself
        r, z = p, p.sum()
    if z <= 0.0:
        raise ValueError("rejection sampling with an EMPTY target "
                         "distribution (all-NEG_INF p row) — the verify "
                         "head must always produce a real distribution")
    return False, int(rng.choice(len(r), p=r / z))


def accept_draft(rng: np.random.Generator, draft: np.ndarray,
                 q_rows: np.ndarray, p_rows: np.ndarray
                 ) -> Tuple[List[int], int]:
    """One slot's whole round: drafted ids (n,), draft/target logit rows
    (n, V). Returns ``(emitted tokens, n_accepted)`` — emitted is the
    accepted prefix plus, after a rejection, one residual replacement
    (``len(emitted) == n_accepted + 1`` then, ``n_accepted`` on a full
    accept)."""
    emitted: List[int] = []
    for i in range(len(draft)):
        ok, tok = accept_step(rng, int(draft[i]), q_rows[i], p_rows[i])
        emitted.append(tok)
        if not ok:
            return emitted, i
    return emitted, len(draft)


def emission_distribution(q_row: np.ndarray, p_row: np.ndarray) -> np.ndarray:
    """The analytic per-position emitted-token law of ``accept_step`` —
    equal to ``row_probs(p_row)`` (the correctness identity the property
    tests pin)."""
    q = row_probs(q_row)
    p = row_probs(p_row)
    accept_mass = np.minimum(q, p)
    r = np.maximum(p - q, 0.0)
    z = r.sum()
    if z <= 0.0:
        return accept_mass                  # q == p: rejection never fires
    return accept_mass + (1.0 - accept_mass.sum()) * (r / z)
