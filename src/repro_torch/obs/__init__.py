"""`repro_torch.obs` — telemetry for the federated engine, invisible when
off.

Phase spans, per-program input-signature counters, resource gauges and
structured round-event sinks, the port of the JAX package's
``repro.obs``: turn it on with ``RunConfig(telemetry=...)``.  Spans time
the host's enqueue of device work and never wait on the card (see
``telemetry``'s docstring); ``TelemetryConfig.profiler_dir`` captures the
device's side, and ``capture.round_split`` splits one generation of it by
phase, on the host and on the device.
"""
from repro_torch.obs.backend import InstrumentedBackend
from repro_torch.obs.capture import load_trace, round_split
from repro_torch.obs.gauges import host_rss_bytes, live_device_bytes
from repro_torch.obs.sinks import (JsonlSink, MemorySink, TableSink,
                                   event_dict, make_sink, parse_sink_spec)
from repro_torch.obs.telemetry import (COMM_FIELDS, NULL_TELEMETRY, PHASES,
                                       PORT_ONLY, NullTelemetry, RoundEvent,
                                       Telemetry, TelemetryConfig,
                                       TelemetryResult, attach, innermost,
                                       signature, traced)

__all__ = [
    "COMM_FIELDS",
    "InstrumentedBackend",
    "JsonlSink",
    "MemorySink",
    "NULL_TELEMETRY",
    "NullTelemetry",
    "PHASES",
    "PORT_ONLY",
    "RoundEvent",
    "TableSink",
    "Telemetry",
    "TelemetryConfig",
    "TelemetryResult",
    "attach",
    "event_dict",
    "host_rss_bytes",
    "innermost",
    "live_device_bytes",
    "load_trace",
    "make_sink",
    "parse_sink_spec",
    "round_split",
    "signature",
    "traced",
]
