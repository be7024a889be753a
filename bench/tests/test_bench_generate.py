"""The traffic generator: every seed gets the same shard sizes, the seed
draws the data."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench_tiny import ROOT
from bench.harness import generate

IID = json.loads((ROOT / "bench/traffic/iid-20x600.json").read_text())


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_iid_shapes(seed):
    clients = generate.make_clients(IID, seed)
    assert len(clients) == 20
    for c in clients:
        assert c.train[0].shape == (10, 50, 32, 32, 3)
        assert c.test[0].shape == (2, 50, 32, 32, 3)
        assert c.weight == 500.0


def test_seed_draws_the_data():
    a = generate.make_clients(IID, 1)
    b = generate.make_clients(IID, 2)
    again = generate.make_clients(IID, 1)
    assert not np.array_equal(a[0].train[0], b[0].train[0])
    assert np.array_equal(a[0].train[0], again[0].train[0])
