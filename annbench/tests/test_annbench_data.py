"""The device generator of the hard regime is deterministic per seed."""

from __future__ import annotations

import json

import torch

from annbench.core.loader import ANNBENCH
from annbench.data.hard_regime import HardRegime

SPEC = dict(json.loads((ANNBENCH / "configs/hard1m-lira.json").read_text())["data"], dim=32)


def draw(seed, n=5000, queries=(300, 200), spec=SPEC):
    g = HardRegime(spec, seed, "cpu")
    x = g.corpus(n)
    fixed = g.dataset_queries(50)
    return x, [g.queries(m) for m in queries] + [fixed]


def test_same_seed_same_inputs():
    x1, q1 = draw(2**31 + 5)
    x2, q2 = draw(2**31 + 5)
    assert torch.equal(x1, x2) and all(torch.equal(a, b) for a, b in zip(q1, q2))


def test_other_seed_other_traffic_same_dataset():
    x1, (q1, _, f1) = draw(1)
    x2, (q2, _, f2) = draw(2)
    assert torch.equal(x1, x2) and torch.equal(f1, f2)  # the dataset is the data_seed's
    assert not torch.equal(q1, q2)


def test_other_data_seed_other_dataset():
    x1, (q1, _, f1) = draw(1)
    x2, (q2, _, f2) = draw(1, spec=dict(SPEC, data_seed=44))
    assert not torch.equal(x1, x2) and not torch.equal(f1, f2)
    # the rows differ, their statistics do not
    assert torch.allclose(x1.norm(dim=1).mean(), x2.norm(dim=1).mean(), rtol=0.05)


def test_corpus_independent_of_query_sets():
    x1, q1 = draw(9, queries=(100,))
    x2, q2 = draw(9, queries=(100, 50))
    assert torch.equal(x1, x2) and torch.equal(q1[0], q2[0]) and torch.equal(q1[-1], q2[-1])


def test_shapes_and_distinct_queries():
    x, (q, _, _) = draw(3)
    assert x.shape == (5000, 32) and q.shape == (300, 32) and x.dtype == torch.float32
    assert len(torch.unique(q, dim=0)) == 300
