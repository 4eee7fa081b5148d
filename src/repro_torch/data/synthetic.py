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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class ZipfMarkovCorpus:
    vocab_size: int
    branching: int = 64          # successors per context
    alpha: float = 1.1           # Zipf exponent
    concentration: float = 0.15  # Dirichlet concentration (small → peaky)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, Bf = self.vocab_size, self.branching
        # Zipfian target popularity used to bias successor choices
        pop = 1.0 / np.arange(1, V + 1, dtype=np.float64) ** self.alpha
        pop /= pop.sum()
        # per-context successor sets: Zipf-biased sample, no replacement
        self.succ = np.empty((V, Bf), np.int32)
        probs = np.empty((V, Bf), np.float32)
        for s in range(V):
            ids = rng.choice(V, Bf, replace=False, p=pop)
            self.succ[s] = ids
            p = rng.dirichlet(np.full(Bf, self.concentration))
            probs[s] = p
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
