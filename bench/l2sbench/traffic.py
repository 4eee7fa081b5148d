"""The one traffic generator: a mix file's parameters + a seed → jobs.

A mix is a JSON file under ``bench/traffic/``. One client sends
``serve_batch`` jobs back to back (a closed loop), as an offline
translation or generation job sends its length-sorted batches. ``jobs``:

* ``requests`` — the rows of a job;
* ``source_length`` — the law of a sentence's length, a log-normal
  {median, sigma, min, max} (words);
* ``prompt_buckets`` — the padded lengths a job's prompts take: a job
  holds sentences of one bucket, the lengths above the next smaller
  bucket up to its own, each prompt padded to the bucket;
* ``block`` — jobs per block: a block's buckets are those of the
  ``block`` stratified quantiles of the length law, so the buckets come
  as often as the law gives them;
* ``output_ratio`` [lo, hi] — a request's ``max_new`` is its sentence's
  length times a ratio, the ratios evenly spaced over [lo, hi]: the
  output is as long as its input, give or take.

The sizes do not depend on the seed: a block holds the same buckets and a
job of a bucket the same ``max_new`` values for every seed; the seed
orders the buckets within each block and the ``max_new`` values over a
job's rows, and draws the prompt tokens. So every seed gives the same
work in another order.

A mix also carries ``accuracy_floor`` (the routing signal every request
sends) and ``heads`` (the candidates of the routing policy).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Request:
    """One request as the client sends it: ``prompt`` (Tp,) int32 ids and
    ``max_new`` tokens."""
    prompt: np.ndarray
    max_new: int


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of one seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1), int(stream)])


def even_uniform(lo: float, hi: float, n: int) -> List[float]:
    """The n evenly spaced quantiles (i + ½)/n of the uniform law on
    [lo, hi]."""
    return [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]


def lognormal_quantiles(spec: dict, n: int, lo_p: float = 0.0,
                        hi_p: float = 1.0) -> List[int]:
    """The n stratified quantiles of a log-normal with median
    ``spec["median"]`` and log-sd ``spec["sigma"]``, at the probabilities
    evenly spaced over (lo_p, hi_p), rounded and clipped to [min, max]."""
    nd = NormalDist()
    mu = math.log(spec["median"])
    out = []
    for p in even_uniform(lo_p, hi_p, n):
        x = math.exp(mu + spec["sigma"] * nd.inv_cdf(min(max(p, 1e-12),
                                                          1 - 1e-12)))
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def lognormal_cdf(spec: dict, x: float) -> float:
    if x <= 0:
        return 0.0
    return NormalDist().cdf((math.log(x) - math.log(spec["median"]))
                            / spec["sigma"])


class ClosedJobs:
    """The endless sequence of a mix's jobs for one seed: ``job(i)`` → its
    requests (all of one prompt bucket)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        jobs = mix["jobs"]
        self.n = int(jobs["requests"])
        self.law = jobs["source_length"]
        self.buckets = sorted(int(b) for b in jobs["prompt_buckets"])
        if self.buckets[-1] < int(self.law["max"]):
            raise ValueError(f"the longest bucket {self.buckets[-1]} is "
                             f"shorter than the longest sentence "
                             f"{self.law['max']}")
        self.block = [self.bucket_of(x) for x in
                      lognormal_quantiles(self.law, int(jobs["block"]))]
        self.ratios = [float(x) for x in jobs["output_ratio"]]
        self._new = {}

    def bucket_of(self, length: int) -> int:
        return next(b for b in self.buckets if b >= length)

    def used_buckets(self) -> List[int]:
        """The buckets a block holds, each once."""
        return sorted(set(self.block))

    def bucket(self, i: int) -> int:
        blk, pos = divmod(i, len(self.block))
        order = rng_for(self.seed, 1_000_000 + blk).permutation(
            len(self.block))
        return self.block[int(order[pos])]

    def max_new(self, T: int) -> List[int]:
        """A job of bucket T: its rows' ``max_new`` (sorted): the
        sentences' lengths — the stratified quantiles of the length law
        over (the next smaller bucket, T] — each times one of the evenly
        spaced ratios, paired in one fixed order for every seed."""
        if T not in self._new:
            k = self.buckets.index(T)
            below = self.buckets[k - 1] if k else 0
            lo_p = lognormal_cdf(self.law, below + 0.5)
            hi_p = 1.0 if T == self.buckets[-1] \
                else lognormal_cdf(self.law, T + 0.5)
            lengths = [min(max(x, below + 1), T) for x in
                       lognormal_quantiles(self.law, self.n, lo_p, hi_p)]
            ratios = rng_for(0, 5).permutation(
                even_uniform(*self.ratios, self.n))
            self._new[T] = sorted(max(1, round(n * r))
                                  for n, r in zip(lengths, ratios))
        return self._new[T]

    def job(self, i: int) -> List[Request]:
        rng = rng_for(self.seed, 2_000_000 + i)
        T = self.bucket(i)
        prompts = rng.integers(0, self.vocab, size=(self.n, T),
                               dtype=np.int32)
        new = rng.permutation(self.max_new(T))
        return [Request(prompt=prompts[j], max_new=int(new[j]))
                for j in range(self.n)]


def longest(mix: dict) -> tuple:
    """(longest prompt, most new tokens) any request of the mix can have:
    what the engine's cache must hold."""
    jobs = ClosedJobs(mix, 0, 2)
    T = jobs.buckets[-1]
    return T, max(max(jobs.max_new(b)) for b in jobs.buckets)
