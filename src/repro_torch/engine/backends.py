"""Client-execution backends for the federated engine.

A backend answers *how* to run local SGD and evaluation, never *what* to
run (sampling, accounting and selection live in the strategies and the
engine, so every backend sees the same inputs):

  * ``train_fill``  — train keys[i]'s sub-model on client group i from a
    shared master and fill-aggregate the uploads (Algorithm 3/4).
  * ``eval_shared`` — weighted test error of K keys on a shared master.

``LoopBackend`` is the reference: one local update per (individual,
client) pair, on ``RunConfig.device``.  Algorithm 3 routes through
``fill_aggregate(backend=cfg.aggregate_backend)``.  ``survivors`` is
``None`` (every client completes) or the set of client ids whose uploads
arrive this round (``ClientSimConfig`` dropout); dead clients are
skipped.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.aggregate import fill_aggregate
from repro_torch.core.federated import client_update_fn, eval_count_fn, \
    weighted_test_error
from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientDataset
from repro_torch.engine.types import RunConfig


class LoopBackend:
    """Reference execution: one local update per (individual, client)
    pair.  Each client's shard moves to ``cfg.device`` when it is used;
    ``dispatches`` counts client updates, client evaluations and
    aggregations."""

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

    def eval_shared(self, params, keys, client_ids, survivors=None):
        part = [self._shard(self.clients[int(i)].test) for i in client_ids
                if self._alive(survivors, i)]
        if not part:                   # nobody evaluated: pessimistic 1.0
            return np.ones(len(keys))
        errs = []
        for k in keys:
            errs.append(weighted_test_error(self.evaluate, params, k, part))
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
