"""The traffic generator: deterministic from the seed, and the same sizes
for every seed in another order."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1] / "src")]

from l2sbench import traffic  # noqa: E402
from l2sbench.harness import BENCH, load_json  # noqa: E402

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


def _mix(name):
    return load_json(BENCH / "traffic" / f"{name}.json")


MIXES = ["iwslt14-b640-f090", "iwslt14-b640-f100"]


@pytest.mark.parametrize("name", MIXES)
def test_closed_jobs_deterministic_and_seed_invariant(name):
    mix = _mix(name)
    sizes = None
    for seed in SEEDS:
        a, b = traffic.ClosedJobs(mix, seed, 1000), \
            traffic.ClosedJobs(mix, seed, 1000)
        nb = len(a.block)
        for i in range(2 * nb):
            ja, jb = a.job(i), b.job(i)
            assert all(np.array_equal(x.prompt, y.prompt) and
                       x.max_new == y.max_new for x, y in zip(ja, jb))
            assert len(ja) == mix["jobs"]["requests"]
            assert {len(x.prompt) for x in ja} == {a.bucket(i)}
        # a block of jobs holds the same buckets; a job of a bucket the
        # same max_new set, whatever the seed
        got = (sorted(a.bucket(i) for i in range(nb)),
               {T: sorted(r.max_new for r in a.job(i))
                for i in range(nb) for T in [a.bucket(i)]})
        sizes = got if sizes is None else sizes
        assert got == sizes


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_mix(name):
    mix = _mix(name)
    jobs = traffic.ClosedJobs(mix, 3, 1000)
    law, (lo, hi) = mix["jobs"]["source_length"], mix["jobs"]["output_ratio"]
    buckets = sorted(mix["jobs"]["prompt_buckets"])
    # every bucket the law reaches, the short ones more often
    assert jobs.used_buckets() == buckets
    count = {T: jobs.block.count(T) for T in buckets}
    assert count[16] > count[64]
    for k, T in enumerate(buckets):
        new = jobs.max_new(T)
        below = buckets[k - 1] if k else 0
        # each output its input's length times a ratio in [lo, hi]
        assert min(new) >= max(1, round((below + 1) * lo)) - 1
        assert max(new) <= round(T * hi) + 1
    tokens = sum(sum(jobs.max_new(T)) for T in jobs.block)
    mean_out = tokens / (len(jobs.block) * jobs.n)
    mean_in = mean_out / ((lo + hi) / 2)
    assert abs(mean_in - law["median"] * np.exp(law["sigma"] ** 2 / 2)) \
        < 0.1 * law["median"]


def test_closed_jobs_seeds_differ():
    mix = _mix(MIXES[0])
    a, b = traffic.ClosedJobs(mix, 1, 1000), traffic.ClosedJobs(mix, 2, 1000)
    assert not np.array_equal(a.job(0)[0].prompt[:4], b.job(0)[0].prompt[:4]) \
        or a.bucket(0) != b.bucket(0)


def test_quantile_helpers():
    assert traffic.even_uniform(0.0, 1.0, 4) == [0.125, 0.375, 0.625, 0.875]
    q = traffic.lognormal_quantiles({"median": 100, "sigma": 1.0, "min": 10,
                                     "max": 400}, 101)
    assert q[50] == 100 and q == sorted(q) and q[-1] == 400
    assert traffic.lognormal_cdf({"median": 100, "sigma": 1.0}, 100) == \
        pytest.approx(0.5)


def test_longest():
    jobs = traffic.ClosedJobs(_mix(MIXES[0]), 0, 2)
    assert traffic.longest(_mix(MIXES[0])) == (64, max(jobs.max_new(64)))


def test_a_bucket_shorter_than_the_longest_sentence_is_refused():
    mix = _mix(MIXES[0])
    mix["jobs"]["prompt_buckets"] = [8, 16, 32]
    with pytest.raises(ValueError):
        traffic.ClosedJobs(mix, 0, 2)
