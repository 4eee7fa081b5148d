"""Synthetic Zipf–Markov corpus (PTB/IWSLT are not in the repository). A
numpy copy of ``repro/data/synthetic.py``: the same seed gives the same
``succ``, ``probs`` and batches, bit for bit.

A first-order Markov chain over the vocabulary whose
  * unigram marginal is Zipfian (rank-frequency ~ 1/rank^alpha), and
  * each context concentrates transition mass on a small successor set
    (`branching` successors, Dirichlet-skewed),
reproducing the natural-language property the paper exploits: "when a
specific combination appears, the next word is almost surely within a small
subset of the vocabulary".

The reference draws each context's successors with ``rng.choice(V,
branching, replace=False, p=pop)``, O(V) a context and O(V²) in all (about
1,900 s on a host core at gemma-2b's V = 256,000). ``_choice_fast`` draws
the same words from the same generator state, bit for bit, faster: numpy's
sampler draws ``size − found`` uniforms a round, takes ``searchsorted`` on
the normalised cumsum of ``p`` with the words found so far zeroed, and keeps
each new word's first draw. Round 0's cdf is the same for every context, so
it is computed once. A retry round's cdf differs from the adjusted
``(S_i − removed mass up to i) / (1 − removed mass)``, with ``S`` round 0's
cumsum, by at most about 4·V·2⁻⁵³ / (its total); the word is taken from
the adjusted cdf (a search over the few segments between removed words,
O(|found| + log V)) when the draw lies more than twice that from both
edges of its bucket, where the exact cdf must give the same word. Otherwise
the exact cumsum is taken, as numpy does (a chance of about 1e-10 a draw).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import bisect
import math

import numpy as np

_U = 2.0 ** -53                 # unit roundoff of float64


def _first_unique(new: np.ndarray) -> np.ndarray:
    """``new``'s distinct values in the order of their first occurrence."""
    return np.fromiter(dict.fromkeys(new.tolist()), np.int64)


def _retry_exact(pop: np.ndarray, found: np.ndarray,
                 x: np.ndarray) -> np.ndarray:
    """numpy's retry round as numpy computes it: the cumsum of ``pop`` with
    the found words zeroed, normalised, searched."""
    p = pop.copy()
    p[found] = 0
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    return cdf.searchsorted(x, side="right")


def _retry_adjusted(pop: list, S: list, found: np.ndarray, x: np.ndarray):
    """The retry round's words from the adjusted cdf, or None where a draw
    lies too near a bucket's edge to be sure of the exact cdf's word.
    ``pop`` and ``S`` as Python lists: a round draws a few words, which
    scalar code serves faster than numpy calls."""
    V = len(S)
    f = sorted(found.tolist())
    removed = [0.0]
    for k in f:
        removed.append(removed[-1] + pop[k])
    total = S[-1] - removed[-1]
    margin = 8.0 * V * _U / total
    # segment j holds indices [start_j, end_j), each at S_i less removed_j;
    # a draw's segment is the first whose last value passes it
    start = [0] + f
    end = f + [V]
    last, top = [], -math.inf
    for j in range(len(start)):
        if end[j] > start[j]:
            top = max(top, S[end[j] - 1] - removed[j])
        last.append(top)

    def adjusted(k):
        return (S[k] - removed[bisect.bisect_right(f, k)]) / total
    out = []
    for xi in x.tolist():
        y = xi * total
        j = bisect.bisect_right(last, y)
        if j == len(last):
            return None
        i = max(bisect.bisect_right(S, y + removed[j]), start[j])
        if not (adjusted(i) - xi > margin and
                (i == 0 or xi - adjusted(i - 1) > margin)):
            return None
        out.append(i)
    return np.asarray(out, np.int64)


def _choice_fast(rng: np.random.Generator, pop: np.ndarray, cdf0: np.ndarray,
                 pop_list: list, S_list: list, size: int,
                 exact: bool = False) -> np.ndarray:
    """``rng.choice(len(pop), size, replace=False, p=pop)``: the same words
    from the same generator draws. ``cdf0``: ``S / S[-1]`` with ``S =
    np.cumsum(pop)``; ``pop_list``, ``S_list``: ``pop`` and ``S`` as Python
    lists. ``exact``: take every retry round's exact cumsum."""
    found = _first_unique(cdf0.searchsorted(rng.random(size), side="right"))
    while found.shape[0] < size:
        x = rng.random(size - found.shape[0])
        new = None if exact else _retry_adjusted(pop_list, S_list, found, x)
        if new is None:
            new = _retry_exact(pop, found, x)
        found = np.concatenate((found, _first_unique(new)))
    return found


@dataclass
class ZipfMarkovCorpus:
    vocab_size: int
    branching: int = 64          # successors per context
    alpha: float = 1.1           # Zipf exponent
    concentration: float = 0.15  # Dirichlet concentration (small → peaky)
    seed: int = 0

    def __post_init__(self):
        self._build(exact=False)

    def _build(self, exact: bool) -> None:
        rng = np.random.default_rng(self.seed)
        V, Bf = self.vocab_size, self.branching
        # Zipfian target popularity used to bias successor choices
        pop = 1.0 / np.arange(1, V + 1, dtype=np.float64) ** self.alpha
        pop /= pop.sum()
        S = np.cumsum(pop)
        cdf0 = S / S[-1]
        pop_list, S_list = pop.tolist(), S.tolist()
        alpha = np.full(Bf, self.concentration)
        # per-context successor sets: Zipf-biased sample, no replacement
        self.succ = np.empty((V, Bf), np.int32)
        probs = np.empty((V, Bf), np.float32)
        for s in range(V):
            self.succ[s] = _choice_fast(rng, pop, cdf0, pop_list, S_list, Bf,
                                        exact)
            probs[s] = rng.dirichlet(alpha)
        self.probs = probs / probs.sum(axis=1, keepdims=True)
        self._rng = rng

    def sample(self, length: int, seed: int | None = None) -> np.ndarray:
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        out = np.empty(length, np.int32)
        s = int(rng.integers(self.vocab_size))
        for i in range(length):
            j = rng.choice(self.branching, p=self.probs[s])
            s = int(self.succ[s, j])
            out[i] = s
        return out

    def sample_batch(self, batch: int, seq_len: int, seed: int = 0) -> np.ndarray:
        """Vectorized batched sampling — (batch, seq_len) int32."""
        rng = np.random.default_rng(seed)
        cum = np.cumsum(self.probs, axis=1)
        s = rng.integers(self.vocab_size, size=batch)
        out = np.empty((batch, seq_len), np.int32)
        for t in range(seq_len):
            u = rng.random(batch)
            j = (u[:, None] > cum[s]).sum(axis=1)
            s = self.succ[s, np.minimum(j, self.branching - 1)]
            out[:, t] = s
        return out


def make_lm_batches(corpus: ZipfMarkovCorpus, n_batches: int, batch: int,
                    seq_len: int, seed: int = 0) -> Iterator[dict]:
    """Yields {"tokens", "labels"} next-token LM batches."""
    for i in range(n_batches):
        seqs = corpus.sample_batch(batch, seq_len + 1, seed=seed + i)
        yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
