"""The traffic generator: a seed repeats exactly, seeds differ in order and
ids, never in the amount of work."""
import itertools
from statistics import NormalDist

import numpy as np

from perfbench import generate, manifest

SERVE = manifest.traffic("serve-16clients")
BIG = 2**31 + 12345


def take(seed: int, n: int):
    return list(itertools.islice(generate.ServeRequests(SERVE, 32064, seed), n))


def test_serve_requests_repeat_for_a_seed_and_differ_across_seeds():
    a, b, c = take(BIG, 100), take(BIG, 100), take(BIG + 1, 100)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
    assert any(len(x[0]) != len(y[0]) or not np.array_equal(x[0], y[0]) for x, y in zip(a, c))


def test_every_seed_gets_the_same_sizes_in_each_block():
    block, clients = SERVE["block"], SERVE["clients"]
    for seed in (0, 7, BIG):
        reqs = take(seed, 4 * block)
        for k in range(1, 4):  # the first block holds the ramp-in's cut outputs
            part = reqs[k * block:(k + 1) * block]
            assert sorted(len(p) for p, _ in part) == list(
                generate.quantile_lengths(SERVE["prompt_tokens"], block))
            assert sorted(o for _, o in part) == list(
                generate.quantile_lengths(SERVE["output_tokens"], block))
        ramp = [o for _, o in reqs[:clients]]
        assert all(1 <= o <= max(generate.quantile_lengths(SERVE["output_tokens"], block))
                   for o in ramp)


def test_lengths_are_the_mixs_normal_quantiles():
    for key in ("prompt_tokens", "output_tokens"):
        dist = SERVE[key]
        q = generate.quantile_lengths(dist, 1000)
        assert abs(q.mean() - dist["mean"]) < 0.5 and abs(q.std() - dist["sd"]) < 0.02 * dist["sd"]
        assert q[0] == round(NormalDist(dist["mean"], dist["sd"]).inv_cdf(0.0005))
    assert generate.quantile_lengths({"mean": 2, "sd": 50}, 8).min() == 1


def test_lengths_stay_in_the_mix():
    reqs = generate.ServeRequests(SERVE, 32064, 3)
    for p, o in itertools.islice(reqs, 200):
        assert len(p) + o <= reqs.max_seq_len and o >= 1
        assert p.min() >= 0 and p.max() < 32064
