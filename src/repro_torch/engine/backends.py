"""Client-execution backends for the federated engine.

A backend answers *how* to run local SGD and evaluation, never *what* to
run (sampling, accounting and selection live in the strategies and the
engine, so every backend sees the same inputs):

  * ``train_fill``  — train keys[i]'s sub-model on client group i from a
    shared master and fill-aggregate the uploads (Algorithm 3/4).
  * ``train_fedavg`` / ``train_fedavg_population`` — FedAvg rounds of
    standalone models (Algorithm 1; the baselines).
  * ``eval_shared`` / ``eval_paired`` — weighted test error of K keys on
    one shared master, or of K (params, key) pairs.

``LoopBackend`` is the reference: one local update per (individual,
client) pair, on ``RunConfig.device``.  ``VmapBackend`` stacks the
round's sampled clients' shards on the device (``ClientBatch``, bucketed
by shape), trains each group's clients from its stack one after another
on the loop backend's step, and evaluates tiles of clients together
under ``torch.func.vmap``; with ``RunConfig.fused`` (the
default) a whole ``train_fill`` or evaluation call is one batched call
("dispatch").  ``MeshBackend`` (``engine/mesh_backend.py``) runs the same
bodies with the population axis split over the devices of a mesh.
Every backend counts ``dispatches`` at the places the JAX package's
counts them, so tests can assert the scaling claims.  Algorithm 3 routes
through ``RunConfig.aggregate_backend`` in both.  Each callable that
counts as one dispatch is wrapped by ``repro_torch.obs.traced`` under the
JAX package's program name, so ``trace_counts`` counts its input
signatures as the JAX package counts its traces.

``survivors`` is ``None`` (every client completes) or the set of client
ids whose uploads arrive this round (``ClientSimConfig`` dropout).  The
loop backend skips dead clients; the batched backend keeps them in its
stacks at aggregation weight 0 (the padding mechanism: a zeroed row
contributes exactly nothing) and masks their error counts with an
``alive`` vector, so its call count does not change with dropout.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Protocol, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.aggregate import fedavg, fill_aggregate, \
    fill_aggregate_stacked, fill_partial, stacked_masks
from repro_torch.core.federated import client_update_fn, eval_count_fn, \
    weighted_test_error
from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientBatch, ClientDataset, \
    shape_buckets
from repro_torch.engine.types import RunConfig
from repro_torch.obs import NULL_TELEMETRY, traced

Params = Any


def master_donation_safe(cfg: RunConfig) -> bool:
    """Whether a fused ``train_fill`` may write the new master into the
    previous master's own tensors.

    Every strategy overwrites its master with ``train_fill``'s return
    value, so the only reader of the *old* tensors is ``CodecBackend``:
    with a lossy uplink codec it re-reads the downlinked master to form
    the uplink delta (``raw - sent_down``) after the inner call.  Hence
    donation is safe iff the uplink codec is the identity.
    (``VmapBackend`` further writes only on CUDA, and only into a master
    it returned itself: never into one a caller passed in.)"""
    from repro_torch.comm import make_codec
    return make_codec(cfg.uplink_codec).is_identity


# ---------------------------------------------------------------------------
# Fused-generation program bodies
# ---------------------------------------------------------------------------
#
# Each body consumes ONE shape bucket of group-major stacked arrays (see
# StackedClientBase._group_bucket_arrays).  The choice key stays on the
# host: the CNN's forward picks its branches in Python, so a group's
# clients, which share one key, train from one stack one after another,
# and the groups run one after another (the JAX package's lax.scan over
# keys).  Every (client, batch) keeps its own BatchNorm statistics, under
# vmap too; never merge clients' samples into one forward.

def _expand_rest(trained: Params, master: Params, s: int) -> Params:
    """The stacked uploads of S clients: the trained leaves, and every
    other leaf as an ``expand``ed (S, ...) view of the master."""
    return {k: trained[k] if k in trained
            else v.unsqueeze(0).expand((s,) + v.shape)
            for k, v in master.items()}


def clients_in_turn(upd, master, key, xb, yb, lr) -> Params:
    """Local SGD of one group's S clients from ``master``, one after
    another on the loop backend's step ``upd`` (``client_update_fn``,
    which hands an untrained leaf back as the master's own tensor), over
    the client axis of ``xb``/``yb`` (S, nbat, B, ...) -> {name: (S, ...)}:
    the trained leaves stacked, every other leaf an ``expand``ed view of
    the master."""
    outs = [upd(master, key, xb[i], yb[i], lr) for i in range(xb.shape[0])]
    trained = {k: torch.stack([o[k] for o in outs]) for k in master
               if outs[0][k] is not master[k]}
    return _expand_rest(trained, master, xb.shape[0])


def fill_bucket_partial(train, mask_fn, master, keys, xb, yb, w, lr,
                        acc=None, span=NULL_TELEMETRY.span) -> Params:
    """Fused local SGD + Algorithm 3 partial sum over one shape bucket.

    ``train(master, key, xb, yb, lr)`` is one group's local SGD
    (``clients_in_turn``); ``keys`` (G, num_blocks)
    host ints; ``xb``/``yb`` (G, S, nbat, B, ...) on the device; ``w``
    (G, S) float32 globally normalized (0 = padding or a dropped
    client).  Per group, trains the S clients and adds their uploads
    onto the running float32 sum ``acc`` (zeros when None) with
    ``aggregate.fill_partial`` — the same expression the non-fused
    stacked aggregator uses, under the span ``span("fill_aggregate")``,
    where the JAX package puts its label.  Returns the running sum
    (callers pass it on to the next bucket and cast it back to the
    master dtypes)."""
    for g, key in enumerate(keys):
        outs = train(master, key, xb[g], yb[g], lr)
        with span("fill_aggregate"):
            masks = stacked_masks(mask_fn, outs,
                                  np.stack([key] * xb.shape[1]))
            acc = fill_partial(master, outs, masks, w[g], acc)
    return acc


def train_bucket_uploads(train, master, keys, xb, yb, lr) -> Params:
    """Fused local SGD over one bucket, uploads returned stacked
    (G * S, ...) group-major — the ``aggregate_backend="kernel"`` route,
    where Algorithm 3 runs in the fill-aggregation kernel after it."""
    outs = [train(master, key, xb[g], yb[g], lr)
            for g, key in enumerate(keys)]
    return {k: torch.cat([o[k] for o in outs]) for k in master}


def _tiled_count(ev, params, key, xb, yb, alive, tile) -> torch.Tensor:
    """Wrong count of one (params, key) pair over a stacked test bucket
    (0-d int64 on the device), the client axis consumed ``tile`` shards
    at a time through ``vmap`` (the parameters are shared, so each
    convolution takes the tile's images as one batch) and the tail one
    shard at a time.  ``alive`` is the (S,) survivor mask multiplying
    each client's count.  Counts are integers, so tiling and masking are
    both exact."""
    m = xb.shape[0]
    tile = max(1, min(tile, m))
    full = (m // tile) * tile
    tile_ev = vmap(lambda x, y: ev(params, key, x, y))
    acc = torch.zeros((), dtype=torch.int64, device=xb.device)
    for t in range(0, full, tile):
        acc = acc + torch.sum(alive[t:t + tile]
                              * tile_ev(xb[t:t + tile], yb[t:t + tile]))
    for i in range(full, m):
        acc = acc + alive[i] * ev(params, key, xb[i], yb[i])
    return acc


def eval_bucket_counts(ev, params, keys, xb, yb, alive, tile=1
                       ) -> torch.Tensor:
    """Wrong counts of every key on one shared master over one stacked
    test bucket: ``keys`` (K, num_blocks) -> (K,) int64 on the device.
    The keys run one after another; the client axis is tiled
    (``_tiled_count``) and masked by the (S,) ``alive`` vector."""
    return torch.stack([_tiled_count(ev, params, key, xb, yb, alive, tile)
                        for key in keys])


def eval_paired_bucket_counts(ev, ps, keys, xb, yb, alive, tile=1
                              ) -> torch.Tensor:
    """``eval_bucket_counts`` for (params, key) pairs: ``ps`` is the K
    parameter trees aligned with ``keys`` (kept apart: stacking them
    would copy every model)."""
    return torch.stack([_tiled_count(ev, p, key, xb, yb, alive, tile)
                        for p, key in zip(ps, keys)])


def fedavg_population_bucket(train, ps, keys, xb, yb, wn, lr
                             ) -> List[Params]:
    """Per-individual FedAvg partial sums over one train bucket: ``ps``
    the P parameter trees, ``keys`` their (P, nb) host keys; ``xb``/
    ``yb`` (S, nbat, B, ...) and ``wn`` (S,) normalized weights shared by
    every individual.  Each individual trains all S clients (``train``,
    as in ``fill_bucket_partial``) and averages them with one weighted
    sum per leaf, the non-fused path's expression, so the reduction
    order matches."""
    out = []
    for p, key in zip(ps, keys):
        outs = train(p, key, xb, yb, lr)
        out.append({k: torch.sum(
            wn.reshape((-1,) + (1,) * (x.dim() - 1)) * x.float(), dim=0)
            for k, x in outs.items()})
    return out


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def accumulate_parts(parts):
    """Sum an iterable of identically-shaped trees (dicts and lists of
    tensors; a bare tensor is a one-leaf tree) — the bucket combiner of
    every fused program."""
    acc = None
    for part in parts:
        acc = part if acc is None else _tree_add(acc, part)
    return acc


def cast_like(tree: Params, ref: Params, donate: bool = False) -> Params:
    """Cast every leaf of the float32 accumulator back to ``ref``'s
    dtypes (the fused programs' final step).  ``donate`` writes each
    leaf into ``ref``'s own tensor instead of a fresh one (the JAX
    package's donated master) and returns ``ref``."""
    if donate:
        for k, r in ref.items():
            r.copy_(tree[k])
        return ref
    return {k: tree[k].to(r.dtype) for k, r in ref.items()}


class ExecutionBackend(Protocol):
    """The dispatch contract every backend implements.

    ``dispatches`` counts the calls issued so far: on the loop backend
    client updates, client evaluations and aggregations; on the batched
    backend its batched calls, where the JAX package counts its jitted
    dispatches.  All ``keys`` are (num_blocks,) int32
    choice keys; ``client_ids`` / ``groups`` index into the backend's
    client list; ``lr`` is the round's learning rate.  ``survivors`` is
    ``None`` (every client completes) or the set of client ids whose
    uploads arrive this round (``ClientSimConfig`` dropout):
    non-survivors contribute nothing to aggregation or error counts,
    with weights renormalized over survivors.  Returned parameters are
    full ``dict[str, Tensor]`` trees; ``eval_*`` return (len(keys),)
    float64 weighted test-error rates in [0, 1] over the surviving
    participants."""

    name: str
    dispatches: int

    def train_fill(self, master: Params, keys: Sequence[np.ndarray],
                   groups: Sequence[np.ndarray], lr: float,
                   survivors=None) -> Params:
        """Train keys[g] on client group g from the shared master and
        fill-aggregate the surviving uploads into the new master
        (Algorithm 3/4); groups may be empty (their individuals'
        blocks are filled from the previous master)."""
        ...

    def train_fedavg(self, params: Params, key: np.ndarray,
                     client_ids: np.ndarray, lr: float,
                     survivors=None) -> Params:
        """One FedAvg round of ``key``'s standalone model over every
        listed client (Algorithm 1)."""
        ...

    def train_fedavg_population(self, params_list: Sequence[Params],
                                keys: Sequence[np.ndarray],
                                client_ids: np.ndarray,
                                lr: float, survivors=None) -> List[Params]:
        """``train_fedavg`` for each (params, key) pair — every client
        trains every individual (the offline baseline)."""
        ...

    def eval_shared(self, params: Params, keys: Sequence[np.ndarray],
                    client_ids: np.ndarray, survivors=None) -> np.ndarray:
        """Weighted test-error rate of every key on one shared master."""
        ...

    def eval_paired(self, params_list: Sequence[Params],
                    keys: Sequence[np.ndarray],
                    client_ids: np.ndarray, survivors=None) -> np.ndarray:
        """Weighted test-error rate of every (params, key) pair."""
        ...


class LoopBackend:
    """Reference execution: one local update per (individual, client)
    pair.  Each client's shard moves to ``cfg.device`` when it is used;
    ``dispatches`` counts client updates, client evaluations and
    aggregations."""

    name = "loop"
    # shared no-op unless FedEngine attaches a real Telemetry (obs)
    telemetry = NULL_TELEMETRY

    def __init__(self, api: SupernetAPI, clients: Sequence[ClientDataset],
                 cfg: RunConfig):
        self.api = api
        self.clients = clients
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        # input signatures per program (repro_torch.obs.traced), the
        # counterpart of the JAX package's trace counts
        self.trace_counts: dict = {}
        self.update = traced(
            "client_update", self.trace_counts,
            client_update_fn(api, cfg.local_epochs, cfg.momentum,
                             span=self._span))
        self.evaluate = traced("evaluator", self.trace_counts,
                               eval_count_fn(api))
        self.dispatches = 0

    def _span(self, name: str):
        """The span ``name`` of the telemetry attached when it is called."""
        return self.telemetry.span(name)

    @staticmethod
    def _alive(survivors, cid) -> bool:
        return survivors is None or int(cid) in survivors

    def _shard(self, shard):
        xb, yb = shard
        return (torch.as_tensor(xb, device=self.device),
                torch.as_tensor(yb, device=self.device))

    def train_fill(self, master, keys, groups, lr, survivors=None):
        uploads = []
        for key, group in zip(keys, groups):
            for cid in group:
                if not self._alive(survivors, cid):
                    continue          # dropped: its upload never arrives
                c = self.clients[int(cid)]
                xb, yb = self._shard(c.train)
                with self.telemetry.span("local_sgd"):
                    p_k = self.update(master, key, xb, yb, lr)
                self.dispatches += 1
                uploads.append((p_k, self.api.trained_mask(p_k, key),
                                c.weight))
        if not uploads:
            return master
        self.dispatches += 1
        with self.telemetry.span("fill_aggregate"):
            return fill_aggregate(master, uploads,
                                  backend=self.cfg.aggregate_backend)

    def train_fedavg(self, params, key, client_ids, lr, survivors=None):
        uploads = []
        for cid in client_ids:
            if not self._alive(survivors, cid):
                continue
            c = self.clients[int(cid)]
            xb, yb = self._shard(c.train)
            with self.telemetry.span("local_sgd"):
                uploads.append((self.update(params, key, xb, yb, lr),
                                c.weight))
            self.dispatches += 1
        if not uploads:
            return params
        self.dispatches += 1
        return fedavg(uploads)

    def train_fedavg_population(self, params_list, keys, client_ids, lr,
                                survivors=None):
        return [self.train_fedavg(p, k, client_ids, lr, survivors=survivors)
                for p, k in zip(params_list, keys)]

    def eval_shared(self, params, keys, client_ids, survivors=None):
        return self.eval_paired([params] * len(keys), keys, client_ids,
                                survivors=survivors)

    def eval_paired(self, params_list, keys, client_ids, survivors=None):
        part = [self._shard(self.clients[int(i)].test) for i in client_ids
                if self._alive(survivors, i)]
        if not part:                   # nobody evaluated: pessimistic 1.0
            return np.ones(len(keys))
        errs = []
        for p, k in zip(params_list, keys):
            errs.append(weighted_test_error(self.evaluate, p, k, part))
            self.dispatches += len(part)
        return np.asarray(errs)


# ---------------------------------------------------------------------------
# Shared stacking/caching for the batched backends (vmap, mesh)
# ---------------------------------------------------------------------------

class StackedClientBase:
    """Host-side stacking, bucketing and caching for the batched
    execution backends (``VmapBackend``, ``MeshBackend``):
    stack-on-demand train-shard stores on ``cfg.device`` keyed by the
    round's sampled clients, per-group gathers from them, and a memoized
    stacked test set per participant set.  Only sampled clients are ever stacked (or, with a
    lazy ``ClientFleet``, even materialized) — device memory scales with
    participation, never fleet size.  ``cache_stats`` counts the LRU
    hits and misses.  Raises ``RuntimeError`` if ``cfg.device`` is a
    CUDA device and no GPU is present."""

    # shared no-op unless FedEngine attaches a real Telemetry (obs)
    telemetry = NULL_TELEMETRY

    def __init__(self, api: SupernetAPI, clients: Sequence[ClientDataset],
                 cfg: RunConfig):
        self.api = api
        self.clients = clients
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"RunConfig.device={cfg.device!r} but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        self._test_cache = {}
        self._train_cache = {}
        self.dispatches = 0
        # input signatures per program (repro_torch.obs.traced) and LRU
        # hit/miss counters of the stacked stores — read by the telemetry
        # round gauges
        self.trace_counts: dict = {}
        self.cache_stats = {"train_store_hits": 0, "train_store_misses": 0,
                            "test_stack_hits": 0, "test_stack_misses": 0}

    def _span(self, name: str):
        """The span ``name`` of the telemetry attached when it is called."""
        return self.telemetry.span(name)

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _group_batches(self, client_ids, split):
        """Yield ClientBatches for one client group, bucketed by shape."""
        shapes = [(self.clients[int(i)].train if split == "train"
                   else self.clients[int(i)].test)[0].shape
                  for i in client_ids]
        for idxs in shape_buckets(shapes):
            yield ClientBatch.stack([self.clients[int(client_ids[i])]
                                     for i in idxs], split=split)

    def _train_store(self, client_ids):
        """Device-resident stacked train shards for ``client_ids`` ONLY:
        [(cid -> row, xb, yb)] per shape bucket, built on demand and
        kept in a size-2 LRU keyed by the canonical (sorted,
        deduplicated) id tuple — the same policy as ``_test_batches``.
        Shards are immutable, so entries never go stale, full
        participation hits the same key every round, and alternating
        participant sets keep both LRU slots live."""
        key = tuple(sorted({int(i) for i in client_ids}))
        cache = self._train_cache
        if key in cache:
            cache[key] = cache.pop(key)      # refresh recency (true LRU)
            self.cache_stats["train_store_hits"] += 1
        else:
            self.cache_stats["train_store_misses"] += 1
            if len(cache) >= 2:
                cache.pop(next(iter(cache)))  # evict least-recently-used
            # a miss is the round's host->device download of the sampled
            # clients' train shards — the telemetry "download" phase
            with self.telemetry.span("download"):
                shards = [self.clients[i].train for i in key]
                store = []
                for idxs in shape_buckets([s[0].shape for s in shards]):
                    xb = self._put(np.stack([shards[i][0] for i in idxs]))
                    yb = self._put(np.stack([shards[i][1] for i in idxs]))
                    store.append(({key[i]: row
                                   for row, i in enumerate(idxs)}, xb, yb))
                cache[key] = store
        return cache[key]

    def _client_weight(self, cid, survivors) -> float:
        """A client's aggregation weight this round: 0 for dropped
        clients, so they stay in the stacked shapes but contribute
        exactly nothing (the weight-0 padding mechanism)."""
        cid = int(cid)
        if survivors is not None and cid not in survivors:
            return 0.0
        return self.clients[cid].weight

    def _survivor_total(self, client_ids, survivors) -> float:
        """Sum of surviving weights — the renormalization total."""
        return float(sum(self._client_weight(c, survivors)
                         for c in client_ids))

    def _group_train_gather(self, client_ids, survivors=None, store=None):
        """Yield (xb, yb, weights, num_shards) per shape bucket for one
        client group, gathered from ``store`` (the round's sampled-client
        stack — built from ``client_ids`` themselves when not passed;
        callers spanning several groups pass the store once so every
        group gathers from the same round-level stack).  Dropped clients
        ride at weight 0; ``weights`` is a host float32 array."""
        if store is None:
            store = self._train_store(client_ids)
        for pos, xb, yb in store:
            sel = [int(i) for i in client_ids if int(i) in pos]
            if not sel:
                continue
            rows = self._put(np.asarray([pos[i] for i in sel], np.int64))
            w = np.asarray([self._client_weight(i, survivors) for i in sel],
                           np.float32)
            yield xb[rows], yb[rows], w, len(sel)

    def _test_batches(self, client_ids):
        """Memoized test-shard stacks on the device: shards are
        immutable, and the pooled wrong/total error is order-invariant,
        so the ids are canonicalized (sorted) and the stack built once
        per participant set instead of once per key per generation.
        Size-2 LRU (hits refresh recency)."""
        key = tuple(sorted(int(i) for i in client_ids))
        cache = self._test_cache
        if key in cache:
            cache[key] = cache.pop(key)      # refresh recency (true LRU)
            self.cache_stats["test_stack_hits"] += 1
        else:
            self.cache_stats["test_stack_misses"] += 1
            if len(cache) >= 2:
                cache.pop(next(iter(cache)))  # evict least-recently-used
            with self.telemetry.span("download"):
                cache[key] = [
                    dataclasses.replace(cb, xb=self._put(cb.xb),
                                        yb=self._put(cb.yb))
                    for cb in self._group_batches(key, "test")]
        return cache[key]

    @staticmethod
    def _alive_masks(batches, survivors):
        """Per test bucket, the (S,) int32 host survivor mask of the
        masked eval bodies (all ones when ``survivors`` is None)."""
        if survivors is None:
            return [np.ones(cb.num_shards, np.int32) for cb in batches]
        return [np.asarray([1 if int(c) in survivors else 0
                            for c in cb.client_ids], np.int32)
                for cb in batches]

    @staticmethod
    def _alive_total(batches, masks) -> int:
        """Pooled test-sample count over surviving clients — the error
        denominator matching the masked counts."""
        return int(sum(int(m.sum()) * cb.samples_per_shard
                       for cb, m in zip(batches, masks)))

    def _rates(self, counts, total, n_keys):
        """One host read per call: the on-device wrong-count vector ->
        pooled error rates of the first ``n_keys`` keys over ``total``
        surviving test samples.  ``total == 0`` (nobody evaluated) is
        pessimistic 1.0, never a perfect score — the same convention the
        strategies and the loop backend use.  The read is the telemetry
        ``host_fetch`` phase: with fused evaluation it is where the host
        waits on the device's work."""
        if total == 0:
            return np.ones(n_keys)
        with self.telemetry.span("host_fetch"):
            wrong = counts.cpu().numpy().astype(np.int64)
        return wrong[:n_keys] / total

    def _group_bucket_arrays(self, keys, groups, total, survivors=None,
                             store=None, pad_groups=0, place=None):
        """Per shape bucket of the round's sampled-client train store
        (built from the union of ``groups`` when ``store`` is not
        passed), the group-major stacked arrays the fused fill programs
        consume: (keys (Gp, nb) host int32, xb (Gp, S, nbat, B, ...) and
        yb on the device, w (Gp, S) host float32 normalized by
        ``total``), with the G groups padded to Gp = G + ``pad_groups``
        (key 0, the store's first rows) and ragged groups padded to S
        clients — all padding at weight 0, so it contributes exactly
        nothing.  Dropped clients (``survivors``) keep their row but at
        weight 0, with ``total`` summed over survivors only.  ``place``,
        where given, maps each of the four arrays to the form its
        consumer takes (the mesh backend splits the leading axis over its
        devices); the keys array is placed once and shared by every
        bucket."""
        out = []
        g_n = len(groups)
        keys_arr = np.stack([np.asarray(k, np.int32) for k in keys])
        if pad_groups:
            keys_arr = np.concatenate([keys_arr, np.zeros(
                (pad_groups, keys_arr.shape[1]), np.int32)])
        if place is None:
            def place(a):
                return a
        karr = place(keys_arr)
        if store is None:
            store = self._train_store([c for g in groups for c in g])
        for pos, xb_all, yb_all in store:
            entries = [[(pos[int(c)], self._client_weight(c, survivors))
                        for c in g if int(c) in pos] for g in groups]
            s_max = max((len(e) for e in entries), default=0)
            if s_max == 0:
                continue
            rows = np.zeros((g_n + pad_groups, s_max), np.int64)
            w = np.zeros((g_n + pad_groups, s_max), np.float32)
            for g, e in enumerate(entries):
                if not e:
                    continue
                rows[g, :len(e)] = [row for row, _ in e]
                # normalize exactly as fill_aggregate_stacked does (f32
                # weight vector / f64 total) — a 1-ulp difference here
                # grows over generations of SGD
                w[g, :len(e)] = np.asarray([wt for _, wt in e],
                                           np.float32) / total
            rows_d = self._put(rows)
            out.append((karr, place(xb_all[rows_d]), place(yb_all[rows_d]),
                        place(w)))
        return out

    def train_fedavg(self, params, key, client_ids, lr, survivors=None):
        """Algorithm 1 for one model == the population path at P = 1."""
        return self.train_fedavg_population([params], [key], client_ids,
                                            lr, survivors=survivors)[0]


# ---------------------------------------------------------------------------
# Batched backend: O(#shape-buckets) dispatches per call
# ---------------------------------------------------------------------------

class VmapBackend(StackedClientBase):
    """Batched execution over ``ClientBatch``-stacked shards on
    ``cfg.device``.

    Every client in group g trains the *same* choice key, so the key
    stays on the host and the CNN runs exactly the selected branches, as
    the loop backend does, and the groups run one after another (the
    JAX package's ``lax.scan`` over keys).  Evaluation shares the
    parameters across clients, so ``RunConfig.vmap_eval_tile`` clients
    share each convolution under ``torch.func.vmap``.

    Per generation the non-fused path issues O(population) dispatches —
    constant in the number of participating clients — instead of the
    loop backend's O(population x clients).  With ``cfg.fused`` (the
    default) each train/eval call is ONE dispatch (the shape buckets are
    looped inside it), evaluation returns one on-device count vector
    read by the host once, and on CUDA, when ``master_donation_safe``
    holds, the new master is written into the master's own tensors if
    this backend returned that master (a master passed in from outside,
    such as an injected initial one, keeps its tensors).  On the
    ``"kernel"`` route a fused ``train_fill`` is one call for every
    group's uploads, then one K1 launch per shape bucket, the last one
    in place.

    A group's clients train one after another on the loop backend's step
    (``clients_in_turn``), so their uploads are the loop's bit for bit.
    Vmapping them on a ``torch.func.grad`` step instead (grouped
    convolutions) was slower and heavier on the H100 and rounded
    otherwise (``PERF.md``)."""

    name = "vmap"

    def __init__(self, api: SupernetAPI, clients: Sequence[ClientDataset],
                 cfg: RunConfig):
        super().__init__(api, clients, cfg)
        self.update = client_update_fn(api, cfg.local_epochs, cfg.momentum,
                                       span=self._span)
        self.evaluate = eval_count_fn(api)
        self.donate_master = (cfg.fused and master_donation_safe(cfg)
                              and self.device.type == "cuda")
        self._own_master = None      # the last master this backend made
        # each callable below is one dispatch, named as the JAX package's
        # jitted program it stands for; traced counts its input signatures
        tc = self.trace_counts
        self._fused_fill = traced("fused_fill", tc, self._fill_body)
        self._fused_uploads = traced("fused_uploads", tc, self._uploads_body)
        self._fused_eval_shared = traced("fused_eval_shared", tc,
                                         self._eval_shared_body)
        self._fused_eval_paired = traced("fused_eval_paired", tc,
                                         self._eval_paired_body)
        self._fused_fedavg = traced("fused_fedavg", tc, self._fedavg_body)
        self._scan_update = traced("scan_update", tc, self._train)
        self._scan_update_avg = traced("scan_update_avg", tc,
                                       self._update_avg_body)
        self._eval_tiles = traced("eval_tiles", tc,
                                  functools.partial(_tiled_count,
                                                    self.evaluate))

    def _train(self, master, key, xb, yb, lr):
        """One group's local SGD -> {name: (S, ...)} stacked uploads."""
        with self.telemetry.span("local_sgd"):
            return clients_in_turn(self.update, master, key, xb, yb, lr)

    # -- program bodies (one dispatch each) ---------------------------------

    def _fill_body(self, master, buckets, lr):
        """Fused fill on the torch route: every bucket's local SGD and
        Algorithm 3 partial sums, cast back to the master's dtypes —
        into the master's own tensors when donation is on and this
        backend made that master."""
        acc = None
        for k, xb, yb, w in buckets:
            acc = fill_bucket_partial(self._train, self.api.trained_mask,
                                      master, k, xb, yb, self._put(w), lr,
                                      acc, span=self._span)
        donate = self.donate_master and master is self._own_master
        return cast_like(acc, master, donate=donate)

    def _uploads_body(self, master, buckets, lr):
        """Fused local SGD of every bucket, uploads stacked per bucket
        (the kernel route runs Algorithm 3 on K1 after it)."""
        return [train_bucket_uploads(self._train, master, k, xb, yb, lr)
                for k, xb, yb, _ in buckets]

    def _eval_shared_body(self, params, keys, shards):
        return accumulate_parts(
            eval_bucket_counts(self.evaluate, params, keys, xb, yb, alive,
                               tile=self.cfg.vmap_eval_tile)
            for xb, yb, alive in shards)

    def _eval_paired_body(self, ps, keys, shards):
        return accumulate_parts(
            eval_paired_bucket_counts(self.evaluate, ps, keys, xb, yb, alive,
                                      tile=self.cfg.vmap_eval_tile)
            for xb, yb, alive in shards)

    def _fedavg_body(self, ps, keys, buckets, lr):
        """Fused FedAvg of every individual over every bucket; ``buckets``
        carry host float32 weights normalized by the survivor total."""
        out = accumulate_parts(
            fedavg_population_bucket(self._train, ps, keys, xb, yb,
                                     self._put(wn), lr)
            for xb, yb, wn in buckets)
        return [cast_like(o, p) for o, p in zip(out, ps)]

    def _update_avg_body(self, params, key, xb, yb, lr, wn):
        """Non-fused FedAvg partial of one individual over one bucket."""
        return fedavg_population_bucket(self._train, [params], [key], xb, yb,
                                        self._put(wn), lr)[0]

    # -- protocol -----------------------------------------------------------

    def train_fill(self, master, keys, groups, lr, survivors=None):
        if self.cfg.fused:
            return self._train_fill_fused(master, keys, groups, lr,
                                          survivors)
        chunks = []
        # one sampled-client stack for the whole generation — every group
        # gathers from it, so the LRU sees a single round-level key
        all_ids = [int(c) for g in groups for c in g]
        store = self._train_store(all_ids) if all_ids else None
        for key, group in zip(keys, groups):
            if len(group) == 0:
                continue
            if survivors is not None and \
                    not any(int(c) in survivors for c in group):
                continue    # fully-dropped group: its weight-0 rows would
                # contribute exactly nothing — skip its training
            key = np.asarray(key, np.int32)
            for xb, yb, w, n in self._group_train_gather(group, survivors,
                                                         store=store):
                out = self._scan_update(master, key, xb, yb, lr)
                self.dispatches += 1
                chunks.append((out, np.tile(key, (n, 1)), w))
        if not chunks or not any(np.any(w) for _, _, w in chunks):
            return master              # nobody survived: master untouched
        # per-group stacked uploads feed the batched fill directly (one
        # dispatch per chunk)
        with self.telemetry.span("fill_aggregate"):
            master = fill_aggregate_stacked(
                master, chunks, mask_fn=self.api.trained_mask,
                backend=self.cfg.aggregate_backend)
        self.dispatches += len(chunks)
        return master

    def _train_fill_fused(self, master, keys, groups, lr, survivors=None):
        groups = [np.asarray(g) for g in groups]
        total = self._survivor_total([c for g in groups for c in g],
                                     survivors)
        if total == 0.0:
            return master
        buckets = self._group_bucket_arrays(keys, groups, total,
                                            survivors=survivors)
        if not buckets:
            return master
        if self.cfg.aggregate_backend == "kernel":
            # one call for the whole population's local SGD, then
            # Algorithm 3 on the kernel, one launch per bucket
            outs = self._fused_uploads(master, buckets, lr)
            self.dispatches += 1
            chunks = [(out, np.repeat(k, w.shape[1], axis=0), w.reshape(-1))
                      for (k, _, _, w), out in zip(buckets, outs)]
            with self.telemetry.span("fill_aggregate"):
                master = fill_aggregate_stacked(
                    master, chunks, mask_fn=self.api.trained_mask,
                    backend="kernel", total=1.0)
            self.dispatches += len(chunks)
            return master
        self._own_master = self._fused_fill(master, buckets, lr)
        self.dispatches += 1
        return self._own_master

    def _fedavg_from_batches(self, params, key, batches, total, lr):
        acc = None
        for xb, yb, w, _ in batches:
            part = self._scan_update_avg(params, key, xb, yb, lr, w / total)
            self.dispatches += 1
            acc = part if acc is None else _tree_add(acc, part)
        return cast_like(acc, params)

    def train_fedavg_population(self, params_list, keys, client_ids, lr,
                                survivors=None):
        # gather the participants' train shards once for every individual
        batches = list(self._group_train_gather(client_ids, survivors))
        total = self._survivor_total(client_ids, survivors)
        if total == 0.0:               # nobody survived: models untouched
            return list(params_list)
        keys = [np.asarray(k, np.int32) for k in keys]
        if self.cfg.fused:
            if not params_list:
                return []
            out = self._fused_fedavg(params_list, keys,
                                     [(xb, yb, w / total)
                                      for xb, yb, w, _ in batches], lr)
            self.dispatches += 1
            return out
        return [self._fedavg_from_batches(p, k, batches, total, lr)
                for p, k in zip(params_list, keys)]

    def _eval_one(self, params, key, batches, masks, total):
        """Non-fused evaluation of one key: per bucket one call for the
        full tiles and one for the remaining clients as a single tile,
        each read by the host."""
        if total == 0:
            return 1.0                 # nobody evaluated: pessimistic
        wrong = 0
        for batch, alive in zip(batches, masks):
            alive = self._put(alive)
            m = batch.num_shards
            tile = max(1, min(self.cfg.vmap_eval_tile, m))
            full = (m // tile) * tile
            for lo, hi, t in ((0, full, tile), (full, m, m - full)):
                if hi > lo:
                    wrong += int(self._eval_tiles(
                        params, key, batch.xb[lo:hi], batch.yb[lo:hi],
                        alive[lo:hi], t))
                    self.dispatches += 1
        return wrong / total

    def _fused_shards(self, batches, masks):
        return [(cb.xb, cb.yb, self._put(m)) for cb, m in zip(batches, masks)]

    def eval_shared(self, params, keys, client_ids, survivors=None):
        batches = self._test_batches(client_ids)
        masks = self._alive_masks(batches, survivors)
        total = self._alive_total(batches, masks)
        keys = [np.asarray(k, np.int32) for k in keys]
        if self.cfg.fused:
            counts = self._fused_eval_shared(
                params, keys, self._fused_shards(batches, masks))
            self.dispatches += 1
            return self._rates(counts, total, len(keys))
        return np.asarray([self._eval_one(params, k, batches, masks, total)
                           for k in keys])

    def eval_paired(self, params_list, keys, client_ids, survivors=None):
        batches = self._test_batches(client_ids)
        masks = self._alive_masks(batches, survivors)
        total = self._alive_total(batches, masks)
        keys = [np.asarray(k, np.int32) for k in keys]
        if self.cfg.fused:
            counts = self._fused_eval_paired(
                params_list, keys, self._fused_shards(batches, masks))
            self.dispatches += 1
            return self._rates(counts, total, len(keys))
        return np.asarray([self._eval_one(p, k, batches, masks, total)
                           for p, k in zip(params_list, keys)])


BACKENDS = {"loop": LoopBackend, "vmap": VmapBackend}


def make_backend(name: str, api: SupernetAPI,
                 clients: Sequence[ClientDataset], cfg: RunConfig):
    """Build the execution backend ``name`` ('loop' | 'vmap' | 'mesh');
    unknown names raise here, before any round runs.  ``mesh`` lives in
    ``repro_torch.engine.mesh_backend`` and is entered into ``BACKENDS``
    by the package's ``__init__``."""
    if name in BACKENDS:
        return BACKENDS[name](api, clients, cfg)
    raise ValueError(f"unknown execution backend {name!r}; available: "
                     f"{sorted(BACKENDS)}")
