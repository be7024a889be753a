"""FedEngine: the round loop of the federated NAS runtime.

The engine owns participant sampling, client availability, the
per-round lr schedule, communication/compute accounting and the typed
``RoundReport`` history, and delegates the rest to a ``Strategy`` (what
happens inside a round) and an execution backend (how client work runs),
which it wraps in ``repro_torch.comm.CodecBackend`` when a payload codec
is lossy and, outermost, in ``repro_torch.obs.InstrumentedBackend`` when
``RunConfig.telemetry`` is on.

    engine = FedEngine(api, clients, RunConfig(device="cuda"))
    result = engine.run()            # EngineResult
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm import CodecBackend, make_codec
from repro_torch.core.double_sampling import sample_participants
from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientDataset
from repro_torch.engine.availability import ClientSimulator, RoundSim
from repro_torch.engine.backends import make_backend
from repro_torch.engine.strategies import RealTimeNas
from repro_torch.engine.types import CommStats, EngineResult, RoundReport, \
    RunConfig
from repro_torch.obs import NULL_TELEMETRY, InstrumentedBackend, Telemetry, \
    attach
from repro_torch.optim import round_decay


class FedEngine:
    """One round loop for the federated NAS runtime.

    Args:
      * ``api`` — the model family's ``SupernetAPI``.
      * ``clients`` — the ``ClientDataset`` population (pre-batched local
        train/test shards on the host; ``weight`` = n_k).
      * ``cfg`` — a ``RunConfig`` (defaults to ``RunConfig()``, which runs
        on ``"cuda"``).
      * ``strategy`` — what happens inside a round; defaults to
        ``RealTimeNas()`` (paper Algorithm 4); ``OfflineNas()`` and
        ``FedAvgBaseline(key)`` are the paper's baselines.
      * ``backend`` — an execution backend name overriding
        ``cfg.backend``, or an already-built backend.

    Raises ``RuntimeError`` if ``cfg.device`` is a CUDA device and no GPU
    is present.
    """

    def __init__(self, api: SupernetAPI, clients: Sequence[ClientDataset],
                 cfg: Optional[RunConfig] = None, strategy=None,
                 backend=None):
        self.api = api
        # indexable client collections (lists, lazy ClientFleet) are kept
        # as-is; plain iterables are drained once
        if hasattr(clients, "__getitem__") and hasattr(clients, "__len__"):
            self.clients = clients
        else:
            self.clients = list(clients)
        self.cfg = cfg or RunConfig()
        self.device = torch.device(self.cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"RunConfig.device={self.cfg.device!r} but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        self.strategy = strategy or RealTimeNas()
        if backend is None or isinstance(backend, str):
            self.backend = make_backend(backend or self.cfg.backend,
                                        api, self.clients, self.cfg)
        else:
            self.backend = backend
        # payload codecs (repro_torch.comm): strategies read these for
        # wire-byte accounting; lossy codecs additionally wrap the
        # execution backend so encode->decode happens around every client
        # train/eval
        self.uplink_codec = make_codec(self.cfg.uplink_codec)
        self.downlink_codec = make_codec(self.cfg.downlink_codec)
        if not (self.uplink_codec.is_identity
                and self.downlink_codec.is_identity):
            self.backend = CodecBackend(self.backend, self.uplink_codec,
                                        self.downlink_codec)
        # telemetry (repro_torch.obs): only when RunConfig.telemetry is
        # enabled does the engine build a real Telemetry and wrap the
        # backend — the InstrumentedBackend goes OUTERMOST so its
        # fill_train/eval spans cover codec encode/decode, which nest
        # beneath them.  Disabled runs keep the object graph they have
        # without telemetry (everything sees the shared no-op
        # NULL_TELEMETRY).
        tcfg = self.cfg.telemetry
        if tcfg is not None and tcfg.enabled:
            self.telemetry = Telemetry(tcfg, self.device)
            attach(self.backend, self.telemetry)
            self.backend = InstrumentedBackend(self.backend, self.telemetry)
        else:
            self.telemetry = NULL_TELEMETRY
        self.rng = np.random.default_rng(self.cfg.seed)
        self.stats = CommStats()
        self.reports: list[RoundReport] = []
        # built here so a bad availability_trace fails at engine build
        # time, and rebuilt per run() for re-entrancy
        self.sim = ClientSimulator(self.cfg.client_sim, len(self.clients))
        self.round_ctx: Optional[RoundSim] = None

    def run(self, callback: Optional[Callable[[int, RoundReport], None]]
            = None) -> EngineResult:
        """Run ``cfg.generations`` federated rounds and return an
        ``EngineResult``.  ``callback(gen, report)`` fires after every
        round.  Re-entrant: repeated calls reset all run state and
        reproduce the same seed-deterministic trajectory."""
        cfg = self.cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.stats = CommStats()
        self.reports = []
        self.backend.dispatches = 0
        reset = getattr(self.backend, "reset", None)
        if reset is not None:        # CodecBackend: drop EF residuals
            reset()
        self.sim = ClientSimulator(cfg.client_sim, len(self.clients))
        self.strategy.setup(self)
        tel = self.telemetry
        tel.start_run(self)
        with tel.run_capture():   # torch.profiler when configured
            # every round ends in host reads of its error counts, which
            # wait for the device, so round_s times the device work too
            t0 = t_prev = time.perf_counter()
            for gen in range(1, cfg.generations + 1):
                lr = float(round_decay(cfg.lr0, cfg.lr_decay, gen - 1))
                with tel.span("sample"):
                    sampled = sample_participants(self.rng,
                                                  len(self.clients),
                                                  cfg.participation)
                # availability / dropout draw (sim RNG only — the search
                # RNG stream above is untouched by the simulation)
                with tel.span("availability"):
                    ctx = self.sim.draw_round(sampled)
                self.round_ctx = ctx
                report = self.strategy.round(self, gen, ctx.participants,
                                             lr)
                report.down_gb = self.stats.down_bytes / 1e9
                report.up_gb = self.stats.up_bytes / 1e9
                report.train_passes = self.stats.client_train_passes
                if ctx.active:
                    report.n_sampled = ctx.n_sampled
                    report.n_available = len(ctx.participants)
                    report.n_dropped = ctx.n_dropped
                    report.n_survivors = ctx.n_survivors
                    report.wasted_down_gb = \
                        self.stats.wasted_down_bytes / 1e9
                now = time.perf_counter()
                report.wall_s = now - t0      # cumulative since run()
                report.round_s = now - t_prev  # this round's delta
                t_prev = now
                self.reports.append(report)
                tel.end_round(gen, report.round_s, self)
                if callback:
                    callback(gen, report)
        # a stale RoundSim must not leak into strategies driven manually
        # on this engine afterwards (they fall back to an inactive ctx)
        self.round_ctx = None
        return EngineResult(reports=self.reports, stats=self.stats,
                            extras=self.strategy.extras(self),
                            telemetry=tel.result(self))
