"""Federated NAS engine: strategy x execution backend.

    FedEngine(api, clients, RunConfig(device="cuda"), strategy=RealTimeNas())

Ported so far: the ``RealTimeNas`` strategy (Algorithm 4) on the
``"loop"`` backend, with client availability (``ClientSimConfig``).
"""
from repro_torch.engine.availability import ClientSimulator, RoundSim
from repro_torch.engine.backends import LoopBackend, make_backend
from repro_torch.engine.engine import FedEngine
from repro_torch.engine.strategies import RealTimeNas
from repro_torch.engine.types import AGGREGATE_BACKENDS, BYTES_PER_PARAM, \
    ClientSimConfig, CommStats, EngineResult, ERROR_COUNT_BYTES, \
    RoundReport, RunConfig, history_dict

__all__ = [
    "AGGREGATE_BACKENDS", "BYTES_PER_PARAM", "ClientSimConfig",
    "ClientSimulator", "CommStats", "ERROR_COUNT_BYTES", "EngineResult",
    "FedEngine", "LoopBackend", "RealTimeNas", "RoundReport", "RoundSim",
    "RunConfig", "history_dict", "make_backend",
]
