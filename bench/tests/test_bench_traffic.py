"""Inputs are a pure function of the seed: the same seed gives the same
corpus, queries, prompts and order; another seed other ones of the same
sizes."""
import numpy as np
import pytest
import torch

from bench.data import (device_corpus, device_queries, make_dataset,
                        subseeds)
from bench.systems import serve

BIG = 2**31 + 123456789  # the driver's seeds exceed 32 signed bits


def test_subseeds_take_large_seeds():
    a, b = subseeds(BIG, 4), subseeds(BIG, 4)
    assert a == b and len(set(a)) == 4
    assert all(0 <= s < 2**31 for s in a)
    assert subseeds(BIG + 1, 4) != a


def test_corpus_and_queries_repeat_by_seed():
    c1, db1 = device_corpus(500, 8, 4, 0.35, 11, "cpu")
    c2, db2 = device_corpus(500, 8, 4, 0.35, 11, "cpu")
    assert torch.equal(db1, db2) and torch.equal(c1, c2)
    _, db3 = device_corpus(500, 8, 4, 0.35, 12, "cpu")
    assert not torch.equal(db1, db3) and db3.shape == db1.shape
    q1, q2 = device_queries(c1, 64, 0.35, 5), device_queries(c1, 64, 0.35, 5)
    assert np.array_equal(q1, q2) and q1.shape == (64, 8)


def test_make_dataset_is_the_ports_generator():
    from repro_torch.vector.dataset import make_dataset as port

    for a, b in zip(make_dataset(300, 16, num_queries=1, seed=BIG),
                    port(300, 16, num_queries=1, seed=BIG)):
        assert np.array_equal(a, b)


class _Plan(serve.Run):
    """The serving run's call plan without a server."""

    def __init__(self, seed, traffic):
        self.traffic = traffic
        self.config = {"vocab_size": 1000}
        self.rng = np.random.default_rng(subseeds(seed, 4)[2])

    def plan(self, cycles):
        out = []
        for _ in range(cycles):
            for S in self.rng.permutation(self.traffic["prompt_lengths"]):
                out.append(self._prompts(int(S)))
        return out


TRAFFIC = {"batch": 3, "prompt_lengths": [4, 8, 12]}


@pytest.mark.parametrize("seed", [0, BIG])
def test_serving_plan_repeats_by_seed(seed):
    a, b = _Plan(seed, TRAFFIC).plan(3), _Plan(seed, TRAFFIC).plan(3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_every_cycle_holds_each_length_once():
    for seed in range(5):
        plan = _Plan(seed, TRAFFIC).plan(4)
        for c in range(4):
            lengths = sorted(p.shape[1] for p in plan[3 * c:3 * c + 3])
            assert lengths == TRAFFIC["prompt_lengths"]


def test_another_seed_other_prompts():
    a, b = _Plan(1, TRAFFIC).plan(1), _Plan(2, TRAFFIC).plan(1)
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(a, b))
