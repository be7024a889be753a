"""The yardstick's counts: MACs, payloads, parameters and K1's bytes,
against hand-worked numbers and the program's own objective."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_tiny import ROOT
from bench.harness import counts

CIFAR = json.loads((ROOT / "bench/configs/cifar-supernet.json").read_text())


@pytest.mark.parametrize("branch,macs", [(0, 8_066_048), (1, 851_121_152),
                                         (2, 391_500_800), (3, 102_523_904)])
def test_uniform_key_macs(branch, macs):
    assert counts.cnn_macs(CIFAR["model"], [branch] * 12) == macs


def test_master_params():
    assert counts.master_params(CIFAR) == 26_119_059


def _program_api(config):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.supernet import make_api
    return make_api(ModelConfig(**config["program"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objective_and_payload_match_the_program(seed):
    rng = np.random.default_rng(seed)
    api = _program_api(CIFAR)
    for _ in range(8):
        key = rng.integers(0, 4, 12)
        assert counts.objective(CIFAR, key) == api.flops(key)
        assert counts.payload_params(CIFAR, key) == api.payload_params(key)


def test_k1_bytes_from_shapes():
    keys = [[1] * 12, [0] * 12]
    p = 26_119_059
    pay = [counts.payload_params(CIFAR, k) for k in keys]
    assert counts.k1_bytes(CIFAR, keys) == 4.0 * (sum(pay) + 2 * p)
    # the all-identity key uploads the stem (64 x 3 x 3 x 3), the
    # classifier (512 x 10 + 10), the nine normal blocks' one-parameter
    # placeholders and the reduction blocks' two 1 x 1 convolutions
    assert pay[1] == 1728 + 5130 + 9 + (128 * 64 + 256 * 128 + 512 * 256)


def test_the_benchmarks_master_has_the_programs_leaves():
    from bench.reference import cnn_supernet
    mine = cnn_supernet.init(CIFAR["model"], 2**31 + 5, "cpu")
    theirs = _program_api(CIFAR).init(torch.Generator().manual_seed(0))
    assert sorted(mine) == sorted(theirs)
    assert all(mine[k].shape == theirs[k].shape for k in mine)
    assert sum(v.numel() for v in mine.values()) == 26_119_059
    bound = 1.0 / (3 * 3 * 3) ** 0.5          # the stem's fan in
    assert 0.9 * bound < float(mine["stem"].abs().max()) <= bound
    assert not mine["fc.b"].any()
    again = cnn_supernet.init(CIFAR["model"], 2**31 + 5, "cpu")
    other = cnn_supernet.init(CIFAR["model"], 2**31 + 6, "cpu")
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    assert not torch.equal(mine["stem"], other["stem"])
