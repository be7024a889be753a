"""Federated search strategies: what differs between the paper's
Algorithms 1/4 and the offline baseline, and nothing else.

The engine owns participant sampling, the lr schedule, comm accounting
totals and the round loop; the execution backend owns how local SGD and
evaluation run.  A strategy only sequences the round:

  * ``RealTimeNas``   — Algorithm 4: weight-inherited sub-models,
    fill-aggregation into one shared master, 2N-wide fitness evaluation,
    NSGA-II environmental selection.  One training pass per client per
    generation (the paper's real-time claim).
  * ``OfflineNas``    — the Zhu & Jin 2019 baseline: every offspring is
    reinitialized, every client trains every individual, plain FedAvg per
    individual, no shared master.
  * ``FedAvgBaseline``— Algorithm 1 on a fixed architecture (the paper's
    ResNet18 role in Table IV).

Models are drawn with ``api.init(torch.Generator().manual_seed(seed))``
on the CPU and moved to ``engine.device``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

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
from repro_torch.obs import NULL_TELEMETRY


class Strategy(Protocol):
    """What differs between the paper's algorithms, and nothing else."""

    name: str

    def setup(self, engine) -> None:
        """Initialize run state (models, parent keys) before round 1;
        called by every ``FedEngine.run`` so runs are re-entrant."""
        ...

    def round(self, engine, gen: int, participants: np.ndarray,
              lr: float) -> RoundReport:
        """Execute one federated round (= one generation): sequence the
        backend's train/eval calls, account traffic on ``engine.stats``
        and return the round's ``RoundReport``.  ``gen`` is 1-based;
        ``participants`` the client ids that checked in this round;
        ``lr`` this round's client learning rate.  ``engine.round_ctx``
        carries the round's availability outcome (``RoundSim``) —
        ``survivors`` must be passed to every backend call and dropped
        clients' downloads booked as wasted."""
        ...

    def extras(self, engine) -> Dict:
        """Run-level outputs merged into ``EngineResult.extras`` (e.g.
        the final master parameters)."""
        ...


def _init_model(engine, seed: int):
    """``api.init`` from a seeded generator, on the engine's device."""
    init = engine.api.init(torch.Generator().manual_seed(seed))
    return {k: v.to(engine.device) for k, v in init.items()}


def _round_ctx(engine, participants) -> RoundSim:
    """The round's availability outcome; a fresh inactive one when the
    engine never drew a round (strategies driven outside FedEngine)."""
    ctx = getattr(engine, "round_ctx", None)
    if ctx is None:
        return RoundSim.inactive(np.asarray(participants))
    return ctx


def _telemetry(engine):
    """The engine's telemetry, or the shared no-op for strategies driven
    outside FedEngine (same duck-typing as ``_round_ctx``)."""
    return getattr(engine, "telemetry", NULL_TELEMETRY)


def _account_train(engine, keys, groups, download_models: bool,
                   ctx: RoundSim):
    """Training-phase traffic of one fill-aggregated generation: payload
    down (t == 1 only — later rounds inherit weights already on device),
    payload up, one local pass per (individual, client) pair.  Logical
    bytes are fp32; wire bytes come from the run's payload codecs.
    Dropped clients (``ctx.dropped``) fail after download, before upload:
    their downloads land on the wasted ledger, their passes count (the
    device spent that compute) and they upload nothing."""
    stats, api = engine.stats, engine.api
    down, up = engine.downlink_codec, engine.uplink_codec
    dropped = {int(c) for c in ctx.dropped}
    for key, group in zip(keys, groups):
        payload = api.payload_params(key)
        for cid in group:
            dead = int(cid) in dropped
            if download_models:
                stats.add_download(payload,      # theta^q + key (t == 1)
                                   wire_bytes=down.wire_bytes(payload),
                                   wasted_copies=int(dead))
            stats.client_train_passes += 1
            if not dead:
                stats.add_upload(payload, wire_bytes=up.wire_bytes(payload))


def _account_eval(engine, n_keys: int, ctx: RoundSim,
                  model_params: Sequence[int] = ()):
    """Fitness-phase traffic (Section IV.G): every broadcast aggregated
    model download (real-time NAS's master, the FedAvg baseline's model,
    the offline baseline's per-individual models — at downlink-codec
    wire size), the n_keys choice-key downloads, and one error-count
    upload per (key, client) pair (keys and counts are already minimal
    encodings — wire == logical).  Every strategy routes its fitness
    accounting through here, so the Section IV.G offline-vs-realtime
    comparison counts the same transfer kinds on both sides.  Downloads
    go to every participant — the dropped clients' share is booked as
    wasted — while only survivors upload counts."""
    stats, api = engine.stats, engine.api
    n_participants = len(ctx.participants)
    n_wasted = ctx.n_dropped
    for p in model_params:
        stats.add_eval_download_bytes(
            BYTES_PER_PARAM * p, copies=n_participants,
            wire_nbytes=engine.downlink_codec.wire_bytes(p),
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
        self.master = _init_model(engine, cfg.seed)
        self.parents = sample_population_keys(engine.rng, cfg.population,
                                              engine.api.num_blocks)

    def round(self, engine, gen, participants, lr):
        cfg, api, backend = engine.cfg, engine.api, engine.backend
        ctx = _round_ctx(engine, participants)
        tel = _telemetry(engine)
        survivors = ctx.survivors

        # short groups are only legitimate when clients can actually be
        # absent — a synchronous run short of clients is a misconfig
        strict = not ctx.active

        # --- t == 1 only: train the parent sub-models (Algorithm 4 l.15-26)
        if gen == 1:
            with tel.span("sample"):
                groups = sample_client_groups(engine.rng, participants,
                                              cfg.population, strict=strict)
            _account_train(engine, self.parents, groups,
                           download_models=True, ctx=ctx)
            if ctx.n_survivors:
                self.master = backend.train_fill(self.master, self.parents,
                                                 groups, lr,
                                                 survivors=survivors)

        # --- offspring: inherit weights, never reinitialize (l.27-41)
        with tel.span("sample"):
            offspring = make_offspring(engine.rng, self.parents,
                                       cfg.population, cfg.crossover,
                                       cfg.mutation)
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
        with tel.span("aggregate"):
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


class OfflineNas:
    """Offline evolutionary federated NAS (Zhu & Jin 2019): reinitialized
    individuals, every client trains every individual, per-individual
    FedAvg — the paper's Section IV.G cost comparison baseline."""

    name = "offline"

    def __init__(self):
        self.parents: List[np.ndarray] = []
        self.parent_objs: Optional[np.ndarray] = None
        self._reinit_seed = 1000

    def setup(self, engine):
        self.parents = sample_population_keys(engine.rng,
                                              engine.cfg.population,
                                              engine.api.num_blocks)
        self.parent_objs = None
        self._reinit_seed = 1000

    def _train_and_eval(self, engine, keys, participants, lr):
        api, stats, backend = engine.api, engine.stats, engine.backend
        ctx = _round_ctx(engine, participants)
        m = len(participants)
        n_dropped = ctx.n_dropped
        inits = []
        for _ in keys:
            self._reinit_seed += 1
            # REINITIALIZED from scratch — the paper's central criticism
            inits.append(_init_model(engine, self._reinit_seed))
        down, up = engine.downlink_codec, engine.uplink_codec
        payloads = [api.payload_params(k) for k in keys]
        for payload in payloads:                 # every client trains
            stats.add_download(payload, copies=m,
                               wire_bytes=down.wire_bytes(payload),
                               wasted_copies=n_dropped)
            stats.add_upload(payload, copies=ctx.n_survivors,
                             wire_bytes=up.wire_bytes(payload))
            stats.client_train_passes += m
        if ctx.n_survivors:
            models = backend.train_fedavg_population(
                inits, keys, participants, lr, survivors=ctx.survivors)
        else:
            models = inits               # no uploads: FedAvg is a no-op
        # fitness phase: per-individual aggregated models + choice keys
        # down, error counts up — through the same accounting helper as
        # the real-time strategy, so Section IV.G counts both sides alike
        _account_eval(engine, len(keys), ctx, model_params=payloads)
        if ctx.n_survivors:
            errs = backend.eval_paired(models, keys, participants,
                                       survivors=ctx.survivors)
        else:
            errs = np.ones(len(keys))
        fl = [api.flops(k) for k in keys]
        return np.stack([errs, np.asarray(fl, dtype=float)], axis=1)

    def round(self, engine, gen, participants, lr):
        cfg = engine.cfg
        tel = _telemetry(engine)
        if self.parent_objs is None:
            self.parent_objs = self._train_and_eval(engine, self.parents,
                                                    participants, lr)
        with tel.span("sample"):
            offspring = make_offspring(engine.rng, self.parents,
                                       cfg.population, cfg.crossover,
                                       cfg.mutation)
        off_objs = self._train_and_eval(engine, offspring, participants, lr)

        combined = list(self.parents) + list(offspring)
        objs = np.concatenate([self.parent_objs, off_objs], axis=0)
        with tel.span("aggregate"):
            sel = select(objs, cfg.population)
            self.parents = [combined[i] for i in sel]
            self.parent_objs = objs[sel]

        return RoundReport(
            gen=gen, objs=objs,
            parent_keys=[k.copy() for k in self.parents],
            best_err=float(objs[sel][:, 0].min()))

    def extras(self, engine):
        return {}


class FedAvgBaseline:
    """Algorithm 1 on one fixed choice key (the ResNet18 role)."""

    name = "fedavg"

    def __init__(self, key: np.ndarray):
        self.key = np.asarray(key, np.int32)
        self.params = None

    def setup(self, engine):
        self.params = _init_model(engine, engine.cfg.seed)

    def round(self, engine, gen, participants, lr):
        stats, api, backend = engine.stats, engine.api, engine.backend
        ctx = _round_ctx(engine, participants)
        m = len(participants)
        payload = api.payload_params(self.key)
        stats.add_download(
            payload, copies=m,
            wire_bytes=engine.downlink_codec.wire_bytes(payload),
            wasted_copies=ctx.n_dropped)
        stats.add_upload(
            payload, copies=ctx.n_survivors,
            wire_bytes=engine.uplink_codec.wire_bytes(payload))
        stats.client_train_passes += m
        if ctx.n_survivors:
            self.params = backend.train_fedavg(self.params, self.key,
                                               participants, lr,
                                               survivors=ctx.survivors)
        _account_eval(engine, 1, ctx, model_params=[payload])
        if ctx.n_survivors:
            err = backend.eval_shared(self.params, [self.key], participants,
                                      survivors=ctx.survivors)[0]
        else:
            err = 1.0                    # nobody reported this round
        return RoundReport(gen=gen, best_err=float(err))

    def extras(self, engine):
        return {"params": self.params,
                "flops": engine.api.flops(self.key)}
