"""Federated data partitioners (paper Section IV.C) — lazy, index-space.

IID: even random split, no overlap.  non-IID: each client holds images from
exactly ``classes_per_client`` classes (paper uses 5 of 10).  A Dirichlet
partitioner is included as the standard harder benchmark.

Every partitioner returns a lazy ``Partition`` instead of a list of
per-client index arrays: construction stores only O(dataset) permutations
plus O(num_clients) integer quota/cut vectors, and a client's shard is
assembled on demand by ``indices_for(client_id)`` (``partition[cid]`` /
iteration work too, so existing ``make_clients``-style callers are
unchanged).  That makes ``num_clients`` a cheap axis: a 10^6-client
partition costs megabytes of cut vectors, not 10^6 Python lists, and the
paper's cross-device regime — sample a handful of participants out of a
huge fleet each round — only ever materializes the sampled shards
(``repro_torch.data.pipeline.ClientFleet``).

The lazy shards are **bit-identical** to the historical eager outputs for
the same ``(seed, ...)`` arguments: each partitioner consumes its RNG
stream in exactly the order the eager implementation did, and slicing
reproduces ``np.array_split`` / ``np.split`` semantics cut for cut
(pinned against the JAX package by ``tests/test_torch_host.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class Partition(Sequence):
    """Lazy index-space partition of ``range(n)`` into ``num_clients``
    shards.

    Sequence protocol: ``len(p)`` is the client count, ``p[cid]`` /
    ``p.indices_for(cid)`` materializes client ``cid``'s sorted int64
    sample-index array, iteration yields every shard in order.
    ``shard_sizes()`` answers all shard lengths from the stored cut
    vectors without materializing anything; ``nbytes`` is the host
    memory the partition state actually holds."""

    num_clients: int

    def indices_for(self, client_id: int) -> np.ndarray:
        """Client ``client_id``'s sorted sample indices (materialized on
        demand, O(shard size))."""
        raise NotImplementedError

    def shard_sizes(self) -> np.ndarray:
        """(num_clients,) int64 shard lengths, computed from the cut
        vectors — O(num_clients), no shard is materialized."""
        raise NotImplementedError

    @property
    def nbytes(self) -> int:
        """Host bytes held by the partition's internal arrays."""
        raise NotImplementedError

    def materialize(self) -> List[np.ndarray]:
        """Every shard as an eager list (the historical return type)."""
        return [self.indices_for(i) for i in range(self.num_clients)]

    # -- sequence protocol ---------------------------------------------------

    def __len__(self) -> int:
        return self.num_clients

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.indices_for(j)
                    for j in range(*i.indices(self.num_clients))]
        i = int(i)
        if i < 0:
            i += self.num_clients
        if not 0 <= i < self.num_clients:
            raise IndexError(f"client {i} out of range "
                             f"(num_clients={self.num_clients})")
        return self.indices_for(i)

    def __iter__(self):
        for i in range(self.num_clients):
            yield self.indices_for(i)


def _split_cuts(n: int, parts: int) -> np.ndarray:
    """``np.array_split`` cut points: (parts + 1,) int64 offsets where
    the first ``n % parts`` parts get the extra element."""
    base, extra = divmod(n, parts)
    sizes = np.full(parts, base, dtype=np.int64)
    sizes[:extra] += 1
    return np.concatenate(([0], np.cumsum(sizes)))


class IidPartition(Partition):
    """Even random split: one stored permutation + one cut vector."""

    def __init__(self, perm: np.ndarray, cuts: np.ndarray):
        self.num_clients = len(cuts) - 1
        self._perm = perm
        self._cuts = cuts

    def indices_for(self, client_id: int) -> np.ndarray:
        a, b = self._cuts[client_id], self._cuts[client_id + 1]
        return np.sort(self._perm[a:b])

    def shard_sizes(self) -> np.ndarray:
        return np.diff(self._cuts)

    @property
    def nbytes(self) -> int:
        return self._perm.nbytes + self._cuts.nbytes


class LabelPartition(Partition):
    """Exactly-``cpc``-classes shards from the balanced quota deal: each
    client stores its ``cpc`` (class, holder-slot) assignments; each held
    class stores one permutation of its sample indices, split
    ``array_split``-style over its holders."""

    def __init__(self, num_clients: int, class_pos: np.ndarray,
                 slots: np.ndarray, holder_counts: np.ndarray,
                 members: List[Optional[np.ndarray]]):
        self.num_clients = num_clients
        self._class_pos = class_pos          # (k, cpc) class index
        self._slots = slots                  # (k, cpc) position among holders
        self._holder_counts = holder_counts  # (C,) holders per class
        self._members = members              # per class: permuted sample idx

    def indices_for(self, client_id: int) -> np.ndarray:
        parts = []
        for ci, slot in zip(self._class_pos[client_id],
                            self._slots[client_id]):
            m = self._members[ci]
            base, extra = divmod(len(m), int(self._holder_counts[ci]))
            start = slot * base + min(slot, extra)
            parts.append(m[start:start + base + (1 if slot < extra else 0)])
        return np.sort(np.concatenate(parts).astype(np.int64))

    def shard_sizes(self) -> np.ndarray:
        lens = np.asarray([0 if m is None else len(m)
                           for m in self._members], np.int64)
        holders = np.maximum(self._holder_counts, 1)
        base, extra = lens // holders, lens % holders
        cp = self._class_pos
        return (base[cp] + (self._slots < extra[cp])).sum(axis=1)

    @property
    def nbytes(self) -> int:
        return (self._class_pos.nbytes + self._slots.nbytes
                + self._holder_counts.nbytes
                + sum(m.nbytes for m in self._members if m is not None))


class DirichletPartition(Partition):
    """Dirichlet(alpha) label shards: per class, one permutation of its
    sample indices plus the (num_clients + 1,) proportional cut vector."""

    def __init__(self, num_clients: int,
                 members: List[np.ndarray], cuts: List[np.ndarray]):
        self.num_clients = num_clients
        self._members = members   # per class: permuted sample idx
        self._cuts = cuts         # per class: (k + 1,) int64 offsets

    def indices_for(self, client_id: int) -> np.ndarray:
        parts = [m[c[client_id]:c[client_id + 1]]
                 for m, c in zip(self._members, self._cuts)]
        return np.sort(np.concatenate(parts).astype(np.int64))

    def shard_sizes(self) -> np.ndarray:
        sizes = np.zeros(self.num_clients, np.int64)
        for c in self._cuts:
            sizes += np.diff(c)
        return sizes

    @property
    def nbytes(self) -> int:
        return (sum(m.nbytes for m in self._members)
                + sum(c.nbytes for c in self._cuts))


def partition_iid(seed: int, n: int, num_clients: int) -> IidPartition:
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    rng = np.random.default_rng(seed)
    return IidPartition(rng.permutation(n), _split_cuts(n, num_clients))


def partition_label(seed: int, labels: np.ndarray, num_clients: int,
                    classes_per_client: int = 5) -> LabelPartition:
    """Non-IID label partition: every client holds data from exactly
    ``classes_per_client`` DISTINCT classes (the paper uses 5 of 10).

    Class sets are assigned by a balanced greedy deal: each class starts
    with a quota of ``floor/ceil(k*cpc / C)`` holder slots (the
    remainder spread over a random subset) and each client takes the
    ``cpc`` classes with the largest remaining quota, random tiebreak.
    Taking the maxima keeps the quotas balanced, which guarantees the
    deal never runs out of distinct classes for a client and — whenever
    ``k*cpc >= C`` — that every class ends up with at least one holder,
    i.e. full data coverage.  (The previous stack-based dealer could
    hand a client the same class twice and strand stale classes when
    ``cpc`` did not divide ``C``.)  Only when ``k*cpc < C`` do some
    classes go unheld and their data dropped — the "each client sees
    exactly cpc classes" semantics of the paper win over full coverage
    in that degenerate regime.
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    n_classes = len(classes)
    cpc = classes_per_client
    if not 1 <= cpc <= n_classes:
        raise ValueError(f"classes_per_client must be in [1, {n_classes}] "
                         f"(distinct classes available), got {cpc}")
    base, extra = divmod(num_clients * cpc, n_classes)
    quota = np.full(n_classes, base, dtype=np.int64)
    quota[rng.permutation(n_classes)[:extra]] += 1
    class_pos = np.empty((num_clients, cpc), np.int64)
    slots = np.empty((num_clients, cpc), np.int64)
    holder_counts = np.zeros(n_classes, np.int64)
    for i in range(num_clients):
        # cpc largest remaining quotas, ties broken at random
        pick = np.lexsort((rng.random(n_classes), -quota))[:cpc]
        quota[pick] -= 1
        class_pos[i] = pick
        slots[i] = holder_counts[pick]   # holders accrue in client order
        holder_counts[pick] += 1
    members: List[Optional[np.ndarray]] = []
    for ci, c in enumerate(classes):
        if holder_counts[ci] == 0:
            members.append(None)
            continue
        idx = np.where(labels == c)[0]
        if len(idx) < holder_counts[ci]:
            # an empty split would silently break the exactly-cpc
            # guarantee for some holder — fail loudly instead
            raise ValueError(
                f"class {c} has {len(idx)} samples for "
                f"{int(holder_counts[ci])} holders; reduce num_clients or "
                f"classes_per_client (every holder needs at least one "
                f"sample)")
        members.append(rng.permutation(idx))
    return LabelPartition(num_clients, class_pos, slots, holder_counts,
                          members)


def partition_dirichlet(seed: int, labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, min_samples: int = 0,
                        resample: int = 20) -> DirichletPartition:
    """Dirichlet(alpha) label partition.

    Heavy-tailed draws (small ``alpha``, many clients) can hand a client
    ZERO samples, which used to surface only much later as a confusing
    ``batched``/stack failure.  ``min_samples > 0`` guards against that:
    the partition is redrawn (continuing the same RNG stream, so the
    guard stays deterministic) up to ``resample`` times until every
    shard holds at least ``min_samples`` indices, then fails loudly with
    the offending shard sizes.  The default ``min_samples=0`` keeps the
    historical behavior — and the historical RNG consumption — bit for
    bit."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    class_idx = [np.where(labels == c)[0] for c in classes]
    part = None
    for _ in range(max(1, int(resample))):
        members, cuts = [], []
        for idx in class_idx:
            idx = rng.permutation(idx)
            probs = rng.dirichlet([alpha] * num_clients)
            inner = (np.cumsum(probs)[:-1] * len(idx)).astype(np.int64)
            members.append(idx)
            cuts.append(np.concatenate(([0], inner, [len(idx)])))
        part = DirichletPartition(num_clients, members, cuts)
        if min_samples <= 0:
            return part
        if int(part.shard_sizes().min()) >= min_samples:
            return part
    sizes = part.shard_sizes()
    starved = np.flatnonzero(sizes < min_samples)
    raise ValueError(
        f"partition_dirichlet(alpha={alpha}) could not give every one of "
        f"{num_clients} clients min_samples={min_samples} within "
        f"{resample} redraws over {len(labels)} samples: clients "
        f"{starved[:8].tolist()}{'...' if len(starved) > 8 else ''} hold "
        f"{sizes[starved[:8]].tolist()} — use fewer clients, a larger "
        f"alpha, or more data")
