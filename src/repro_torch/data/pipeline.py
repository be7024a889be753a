"""Batching pipeline: shapes client shards into (num_batches, B, ...) numpy
arrays for local training, plus the lazy ``ClientFleet`` (clients
materialized on demand from an index-space ``Partition``).  Shards stay
on the host; the execution backend moves them to the run's device."""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def batched(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffle and reshape to (nb, batch, ...); drops the ragged tail."""
    rng = np.random.default_rng(seed)
    n = (len(x) // batch) * batch
    if n == 0:
        raise ValueError(f"shard of {len(x)} < batch {batch}")
    perm = rng.permutation(len(x))[:n]
    xb = x[perm].reshape((n // batch, batch) + x.shape[1:])
    yb = y[perm].reshape((n // batch, batch) + y.shape[1:])
    return xb, yb


class ClientDataset:
    """One client's local train/test shards, pre-batched."""

    def __init__(self, cid: int, x: np.ndarray, y: np.ndarray,
                 batch: int, test_batch: int, test_frac: float = 0.2,
                 seed: int = 0):
        rng = np.random.default_rng(seed + cid)
        perm = rng.permutation(len(x))
        n_test = max(test_batch, int(len(x) * test_frac))
        n_test = (n_test // test_batch) * test_batch or test_batch
        te, tr = perm[:n_test], perm[n_test:]
        self.cid = cid
        self.train = batched(x[tr], y[tr], batch, seed=seed + cid)
        self.test = batched(x[te], y[te], test_batch, seed=seed + cid + 7)
        self.n_train = len(tr)

    @property
    def weight(self) -> float:
        return float(self.n_train)


def make_clients(x: np.ndarray, y: np.ndarray, shards: List[np.ndarray],
                 batch: int, test_batch: int, seed: int = 0
                 ) -> List[ClientDataset]:
    return [ClientDataset(i, x[s], y[s], batch, test_batch, seed=seed)
            for i, s in enumerate(shards)]


class ArraySource:
    """In-memory sample source for ``ClientFleet``: any object with
    ``take(indices) -> (x, y)`` works (see
    ``repro_torch.data.synthetic.VirtualClassification`` for the
    materialization-free variant)."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x = x
        self.y = y

    def __len__(self) -> int:
        return len(self.x)

    def take(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.x[indices], self.y[indices]


class ClientFleet(Sequence[ClientDataset]):
    """Lazy ``ClientDataset`` population over (sample source, lazy
    partition).

    ``fleet[cid]`` materializes client ``cid`` on first access —
    ``ClientDataset(cid, *source.take(partition[cid]), ...)``, exactly
    what ``make_clients`` builds eagerly, so a fleet over the same
    arrays/shards is bit-identical client for client — and keeps the
    ``cache_size`` most recently used clients alive (true LRU: a hit
    refreshes recency).  Only the clients a round samples ever exist:
    host memory scales with participation x cache depth, never with
    ``len(fleet)``.

    ``materialized`` counts lifetime cache misses (client builds),
    ``hits`` lifetime cache hits, and ``cached`` the currently-live
    entries."""

    def __init__(self, source, partition, batch: int, test_batch: int,
                 seed: int = 0, cache_size: int = 128):
        self.source = source
        self.partition = partition
        self.batch = batch
        self.test_batch = test_batch
        self.seed = seed
        self.cache_size = max(1, int(cache_size))
        self.materialized = 0         # lifetime client builds (cache misses)
        self.hits = 0                 # lifetime cache hits
        self._cache: Dict[int, ClientDataset] = {}

    @property
    def cached(self) -> int:
        return len(self._cache)

    def __len__(self) -> int:
        return len(self.partition)

    def __getitem__(self, cid):
        if isinstance(cid, slice):
            return [self[i] for i in range(*cid.indices(len(self)))]
        cid = int(cid)
        if cid < 0:
            cid += len(self)
        if not 0 <= cid < len(self):
            raise IndexError(f"client {cid} out of range "
                             f"(fleet of {len(self)})")
        cache = self._cache
        if cid in cache:
            cache[cid] = cache.pop(cid)      # refresh recency (true LRU)
            self.hits += 1
        else:
            if len(cache) >= self.cache_size:
                cache.pop(next(iter(cache)))  # evict least-recently-used
            x, y = self.source.take(self.partition[cid])
            cache[cid] = ClientDataset(cid, x, y, self.batch,
                                       self.test_batch, seed=self.seed)
            self.materialized += 1
        return cache[cid]

    def __iter__(self) -> Iterator[ClientDataset]:
        for i in range(len(self)):
            yield self[i]


def make_fleet(x: np.ndarray, y: np.ndarray, shards, batch: int,
               test_batch: int, seed: int = 0,
               cache_size: int = 128) -> ClientFleet:
    """``make_clients``, lazily: same per-client datasets (bit for bit),
    materialized on demand with an LRU of ``cache_size`` clients."""
    return ClientFleet(ArraySource(np.asarray(x), np.asarray(y)), shards,
                       batch, test_batch, seed=seed, cache_size=cache_size)
