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
client) pair, on ``RunConfig.device``.  Algorithm 3 routes through
``fill_aggregate(backend=cfg.aggregate_backend)``.  ``survivors`` is
``None`` (every client completes) or the set of client ids whose uploads
arrive this round (``ClientSimConfig`` dropout); dead clients are
skipped.
"""
from __future__ import annotations

from typing import Any, List, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.aggregate import fedavg, fill_aggregate
from repro_torch.core.federated import client_update_fn, eval_count_fn, \
    weighted_test_error
from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientDataset
from repro_torch.engine.types import RunConfig

Params = Any


class ExecutionBackend(Protocol):
    """The dispatch contract every backend implements.

    ``dispatches`` counts client updates, client evaluations and
    aggregations issued so far.  All ``keys`` are (num_blocks,) int32
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

    def __init__(self, api: SupernetAPI, clients: Sequence[ClientDataset],
                 cfg: RunConfig):
        self.api = api
        self.clients = clients
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.update = client_update_fn(api, cfg.local_epochs, cfg.momentum)
        self.evaluate = eval_count_fn(api)
        self.dispatches = 0

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
                p_k = self.update(master, key, xb, yb, lr)
                self.dispatches += 1
                uploads.append((p_k, self.api.trained_mask(p_k, key),
                                c.weight))
        if not uploads:
            return master
        self.dispatches += 1
        return fill_aggregate(master, uploads,
                              backend=self.cfg.aggregate_backend)

    def train_fedavg(self, params, key, client_ids, lr, survivors=None):
        uploads = []
        for cid in client_ids:
            if not self._alive(survivors, cid):
                continue
            c = self.clients[int(cid)]
            xb, yb = self._shard(c.train)
            uploads.append((self.update(params, key, xb, yb, lr), c.weight))
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


_NOT_YET_PORTED = {"vmap": "ROADMAP queue 1: batched backend",
                   "mesh": "ROADMAP queue 1: mesh and launch"}


def make_backend(name: str, api: SupernetAPI,
                 clients: Sequence[ClientDataset], cfg: RunConfig):
    """Build the execution backend ``name``; unknown names and the
    backends not yet ported raise here, before any round runs."""
    if name == "loop":
        return LoopBackend(api, clients, cfg)
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"execution backend {name!r} is not yet ported to repro_torch "
            f"({_NOT_YET_PORTED[name]}); use 'loop'")
    raise ValueError(f"unknown execution backend {name!r}; available: "
                     "['loop'] (ported), ['mesh', 'vmap'] (not yet)")
