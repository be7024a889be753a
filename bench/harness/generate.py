"""The one traffic generator: a traffic file's parameters and a seed in,
the federation's clients out.

A client is what the program's ``FedEngine`` takes: an object with
``cid``, ``train`` and ``test`` (each a pair of host arrays shaped
``(batches, batch, ...)``), ``n_train`` and ``weight``.  The draws are
frozen copies of the repository's synthetic sources: the class-
conditional image mixture with CIFAR-10's shapes, the IID partition and
the client split (20 % test, shuffled, batched with the ragged tail
dropped).

Every seed gets the same amount of work: the sizes of the shards come
from the traffic file alone (an IID split is even), and the seed draws
the pixels, the labels and every shuffle.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


class Client:
    """One client's pre-batched local shards (host arrays)."""

    def __init__(self, cid: int, x: np.ndarray, y: np.ndarray, batch: int,
                 test_batch: int, test_frac: float, seed: int):
        rng = np.random.default_rng(seed + cid)
        perm = rng.permutation(len(x))
        n_test = max(test_batch, int(len(x) * test_frac))
        n_test = (n_test // test_batch) * test_batch or test_batch
        te, tr = perm[:n_test], perm[n_test:]
        self.cid = cid
        self.train = _batched(x[tr], y[tr], batch, seed + cid)
        self.test = _batched(x[te], y[te], test_batch, seed + cid + 7)
        self.n_train = len(tr)

    @property
    def weight(self) -> float:
        return float(self.n_train)


def _batched(x, y, batch: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = (len(x) // batch) * batch
    if n == 0:
        raise ValueError(f"a shard of {len(x)} samples is under one batch "
                         f"of {batch}")
    perm = rng.permutation(len(x))[:n]
    return (x[perm].reshape((n // batch, batch) + x.shape[1:]),
            y[perm].reshape((n // batch, batch) + y.shape[1:]))


def _prototypes(rng, classes, channels, image):
    low = rng.normal(size=(classes, 4, 4, channels))
    reps = image // 4
    return np.repeat(np.repeat(low, reps, axis=1), reps, axis=2)


def _iid_shards(seed: int, n: int, clients: int) -> List[np.ndarray]:
    perm = np.random.default_rng(seed).permutation(n)
    return [np.sort(s) for s in np.array_split(perm, clients)]


def classification(t: dict, seed: int) -> List[Client]:
    n, classes = t["samples"], t["classes"]
    image, channels = t["image"], t["channels"]
    part = t["partition"]
    if part["kind"] != "iid":
        raise ValueError(f"unknown partition {part['kind']!r}")
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, classes, channels, image)
    y = rng.integers(0, classes, size=n)
    shards = _iid_shards(seed, n, t["clients"])
    x = (protos[y] * t["signal"]
         + rng.normal(size=(n, image, image, channels)) * t["noise"])
    x, y = x.astype(np.float32), y.astype(np.int32)
    return [Client(i, x[s], y[s], t["batch"], t["test_batch"],
                   t["test_frac"], seed) for i, s in enumerate(shards)]


def make_clients(traffic: dict, seed: int) -> List[Client]:
    kind = traffic["kind"]
    if kind == "classification":
        return classification(traffic, seed)
    raise ValueError(f"unknown traffic kind {kind!r}")
