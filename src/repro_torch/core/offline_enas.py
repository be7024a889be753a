"""Offline federated evolutionary NAS — the paper's comparison baseline
(Section IV.G, following Zhu & Jin 2019 [7]).

Compatibility shim over ``repro_torch.engine`` (``FedEngine`` +
``OfflineNas`` strategy): every offspring model is REINITIALIZED and
trained from scratch, every client trains EVERY individual, and each
individual is a standalone model aggregated with plain FedAvg — no shared
master, no fill-aggregation, no weight inheritance.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientDataset
from repro_torch.engine.types import RunConfig


def run(api: SupernetAPI, clients: Sequence[ClientDataset],
        run_cfg: RunConfig) -> Dict:
    """One-call offline-baseline run (legacy API; history dict kept)."""
    from repro_torch.engine import FedEngine, OfflineNas

    return FedEngine(api, clients, run_cfg,
                     strategy=OfflineNas()).run().history()
