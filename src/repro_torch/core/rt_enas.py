"""Real-time federated evolutionary NAS — the paper's Algorithm 4.

Compatibility shim: the round loop lives in ``repro_torch.engine``
(``FedEngine`` + ``RealTimeNas`` strategy + an execution backend).
``run`` keeps the JAX package's pre-engine signature and returns the same
history dict; new code should use ``repro_torch.engine.FedEngine``
directly, which also gives a typed ``RoundReport`` history.

``RunConfig`` and ``CommStats`` are re-exported from
``repro_torch.engine.types`` (their home).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientDataset
from repro_torch.engine.types import BYTES_PER_PARAM, CommStats, RunConfig  # noqa: F401 (compat re-exports)


def run(api: SupernetAPI, clients: Sequence[ClientDataset],
        run_cfg: RunConfig,
        callback: Optional[Callable[[int, Dict], None]] = None) -> Dict:
    """One-call Algorithm 4 run (legacy API; history dict layout kept)."""
    from repro_torch.engine import FedEngine, RealTimeNas
    from repro_torch.engine.types import append_report

    engine = FedEngine(api, clients, run_cfg, strategy=RealTimeNas())
    # the dict handed to the callback each round IS the returned history,
    # gaining final_master/stats after the last round
    live: Dict = {}

    def cb(gen, report):
        append_report(live, report)
        if callback is not None:
            callback(gen, live)

    result = engine.run(callback=cb)
    live.update(result.extras)
    live["stats"] = result.stats
    return live
