"""Federated search strategies: what happens inside a round.

The engine owns participant sampling, the lr schedule, comm accounting
totals and the round loop; the execution backend owns how local SGD and
evaluation run.  ``RealTimeNas`` is the paper's Algorithm 4:
weight-inherited sub-models, fill-aggregation into one shared master,
2N-wide fitness evaluation, NSGA-II environmental selection, one
training pass per client per generation.  ``OfflineNas`` and
``FedAvgBaseline`` follow in a later slice.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.choice import make_offspring
from repro_torch.core.double_sampling import sample_client_groups, \
    sample_population_keys
from repro_torch.core.nsga2 import fast_non_dominated_sort, knee_point, \
    select
from repro_torch.engine.availability import RoundSim
from repro_torch.engine.types import BYTES_PER_PARAM, ERROR_COUNT_BYTES, \
    RoundReport


def _round_ctx(engine, participants) -> RoundSim:
    """The round's availability outcome; a fresh inactive one when the
    engine never drew a round (strategies driven outside FedEngine)."""
    ctx = getattr(engine, "round_ctx", None)
    if ctx is None:
        return RoundSim.inactive(np.asarray(participants))
    return ctx


def _account_train(engine, keys, groups, download_models: bool,
                   ctx: RoundSim):
    """Training-phase traffic of one fill-aggregated generation: payload
    down (t == 1 only — later rounds inherit weights already on device),
    payload up, one local pass per (individual, client) pair.  Dropped
    clients (``ctx.dropped``) fail after download, before upload: their
    downloads land on the wasted ledger, their passes count (the device
    spent that compute) and they upload nothing."""
    stats, api = engine.stats, engine.api
    dropped = {int(c) for c in ctx.dropped}
    for key, group in zip(keys, groups):
        payload = api.payload_params(key)
        for cid in group:
            dead = int(cid) in dropped
            if download_models:
                stats.add_download(payload,      # theta^q + key (t == 1)
                                   wasted_copies=int(dead))
            stats.client_train_passes += 1
            if not dead:
                stats.add_upload(payload)


def _account_eval(engine, n_keys: int, ctx: RoundSim,
                  model_params: Sequence[int] = ()):
    """Fitness-phase traffic (Section IV.G): every broadcast aggregated
    model download, the n_keys choice-key downloads, and one error-count
    upload per (key, client) pair.  Downloads go to every participant —
    the dropped clients' share is booked as wasted — while only
    survivors upload counts."""
    stats, api = engine.stats, engine.api
    n_participants = len(ctx.participants)
    n_wasted = ctx.n_dropped
    for p in model_params:
        stats.add_eval_download_bytes(BYTES_PER_PARAM * p,
                                      copies=n_participants,
                                      wasted_copies=n_wasted)
    stats.add_eval_download_bytes(api.key_bytes * n_keys,
                                  copies=n_participants,
                                  wasted_copies=n_wasted)
    stats.add_eval_upload_bytes(ERROR_COUNT_BYTES * n_keys,
                                copies=ctx.n_survivors)


class RealTimeNas:
    """The paper's Algorithm 4 (one NSGA-II generation == one round)."""

    name = "realtime"

    def __init__(self):
        self.master = None
        self.parents: List[np.ndarray] = []

    def setup(self, engine):
        cfg = engine.cfg
        init = engine.api.init(torch.Generator().manual_seed(cfg.seed))
        self.master = {k: v.to(engine.device) for k, v in init.items()}
        self.parents = sample_population_keys(engine.rng, cfg.population,
                                              engine.api.num_blocks)

    def round(self, engine, gen, participants, lr):
        cfg, api, backend = engine.cfg, engine.api, engine.backend
        ctx = _round_ctx(engine, participants)
        survivors = ctx.survivors

        # short groups are only legitimate when clients can actually be
        # absent — a synchronous run short of clients is a misconfig
        strict = not ctx.active

        # --- t == 1 only: train the parent sub-models (Algorithm 4 l.15-26)
        if gen == 1:
            groups = sample_client_groups(engine.rng, participants,
                                          cfg.population, strict=strict)
            _account_train(engine, self.parents, groups,
                           download_models=True, ctx=ctx)
            if ctx.n_survivors:
                self.master = backend.train_fill(self.master, self.parents,
                                                 groups, lr,
                                                 survivors=survivors)

        # --- offspring: inherit weights, never reinitialize (l.27-41)
        offspring = make_offspring(engine.rng, self.parents, cfg.population,
                                   cfg.crossover, cfg.mutation)
        groups = sample_client_groups(engine.rng, participants,
                                      cfg.population, strict=strict)
        _account_train(engine, offspring, groups,
                       download_models=(gen == 1), ctx=ctx)
        if ctx.n_survivors:
            self.master = backend.train_fill(self.master, offspring, groups,
                                             lr, survivors=survivors)

        # --- fitness: master + all 2N keys to every participant (l.43-49)
        combined = list(self.parents) + list(offspring)
        _account_eval(engine, len(combined), ctx,
                      model_params=[api.master_params()])
        if ctx.n_survivors:
            errs = backend.eval_shared(self.master, combined, participants,
                                       survivors=survivors)
        else:
            # nobody reported: no fitness signal this round — selection
            # falls back to the FLOPs objective (pessimistic error 1.0)
            errs = np.ones(len(combined))
        fl = np.array([api.flops(k) for k in combined], dtype=float)
        objs = np.stack([errs, fl], axis=1)

        # --- NSGA-II environmental selection (l.50-53)
        sel = select(objs, cfg.population)
        self.parents = [combined[i] for i in sel]
        front0 = fast_non_dominated_sort(objs[sel])[0]
        knee_local = knee_point(objs[sel], front0)
        best_local = sel[int(np.argmin(objs[sel][:, 0]))]

        return RoundReport(
            gen=gen, objs=objs,
            parent_keys=[k.copy() for k in self.parents],
            best_err=float(objs[best_local, 0]),
            best_key=combined[best_local].copy(),
            knee_err=float(objs[sel][knee_local, 0]),
            knee_key=combined[sel[knee_local]].copy())

    def extras(self, engine):
        return {"final_master": self.master}
