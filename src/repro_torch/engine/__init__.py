"""Federated NAS engine: strategy x execution backend x payload codec.

    FedEngine(api, clients, RunConfig(device="cuda"), strategy=RealTimeNas())

Strategies: RealTimeNas (Algorithm 4), OfflineNas (Zhu & Jin 2019
baseline), FedAvgBaseline (Algorithm 1, fixed architecture).  Backends:
"loop" (reference, one local update per (individual, client) pair) and
"vmap" (stacked client shards on the device, a group's clients trained
one after another on the loop's step, evaluation of tiles of clients
under ``torch.func.vmap``; ``RunConfig.fused`` makes each train/eval
call one batched call) and "mesh" (those stacks with the population axis
split over the devices of a one-process mesh, ``launch.mesh``).
Payload codecs (``RunConfig.uplink_codec`` / ``downlink_codec`` ->
``repro_torch.comm``) compress what crosses the wire around any
strategy.  Client availability (``RunConfig.client_sim`` ->
``ClientSimConfig``) simulates per-round availability, post-download
dropout and stragglers, with survivor-masked aggregation and a
wasted-bytes CommStats ledger.  Telemetry (``RunConfig.telemetry`` ->
``repro_torch.obs``) records phase spans, per-program signature counts,
gauges and ``CommStats`` deltas per round, bit for bit invisible to the
search.
"""
from repro_torch.comm import CodecBackend, PayloadCodec, make_codec
from repro_torch.engine.availability import ClientSimulator, RoundSim
from repro_torch.engine.backends import BACKENDS, ExecutionBackend, \
    LoopBackend, StackedClientBase, VmapBackend, make_backend
from repro_torch.engine.engine import FedEngine
from repro_torch.engine.mesh_backend import MeshBackend
from repro_torch.engine.strategies import FedAvgBaseline, OfflineNas, \
    RealTimeNas, Strategy
from repro_torch.engine.types import AGGREGATE_BACKENDS, BYTES_PER_PARAM, \
    ClientSimConfig, CommStats, EngineResult, ERROR_COUNT_BYTES, \
    RoundReport, RunConfig, history_dict
from repro_torch.obs import InstrumentedBackend, RoundEvent, Telemetry, \
    TelemetryConfig, TelemetryResult

BACKENDS["mesh"] = MeshBackend

__all__ = [
    "AGGREGATE_BACKENDS", "BYTES_PER_PARAM", "ClientSimConfig",
    "ClientSimulator", "CodecBackend", "CommStats", "ERROR_COUNT_BYTES",
    "EngineResult", "ExecutionBackend", "FedAvgBaseline", "FedEngine",
    "InstrumentedBackend", "LoopBackend", "MeshBackend", "OfflineNas",
    "PayloadCodec",
    "RealTimeNas", "RoundEvent", "RoundReport", "RoundSim", "RunConfig",
    "StackedClientBase", "Strategy", "Telemetry", "TelemetryConfig",
    "TelemetryResult", "VmapBackend", "history_dict", "make_backend",
    "make_codec",
]
