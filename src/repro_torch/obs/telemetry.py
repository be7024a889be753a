"""Telemetry for the federated engine: phase spans, signature counters,
resource gauges and structured round events, invisible when off.

The port of the JAX package's ``repro.obs.telemetry``, with the same
vocabulary, knobs and events:

  * ``Telemetry`` — nestable **phase spans** (``sample``,
    ``availability``, ``download``, ``fill_train``, ``aggregate``,
    ``eval``, ``codec_encode``/``codec_decode``, ``host_fetch``, and
    inside ``fill_train`` the port's own ``local_sgd``, ``sgd_update``
    and ``fill_aggregate``: ``PORT_ONLY``) recorded as ``time.perf_counter`` durations and accumulated per
    round under their nesting path (``"fill_train/codec_decode"``).
    With ``annotations`` each span also enters
    ``torch.profiler.record_function(name)``, so a profiler capture
    shows the phases the round events record.
  * ``RoundEvent`` — one record per federated round: span durations and
    call counts, **recompile deltas** (new input signatures per backend
    program, see ``traced``), **resource gauges** (live device bytes,
    host RSS, lazy-fleet and stacked-store LRU counters) and the round's
    **CommStats deltas** — pushed to the configured sink and kept in an
    in-memory ring.
  * ``traced`` — wraps each backend program and counts its new input
    signatures, the key a ``jax.jit`` trace cache keys on.
  * ``NULL_TELEMETRY`` — the disabled path.  ``FedEngine`` builds a real
    ``Telemetry`` (and the ``InstrumentedBackend`` wrapper) only when
    ``RunConfig.telemetry`` is enabled; everything else sees this shared
    no-op object, whose spans are empty context managers.

**What a span times on an asynchronous device.**  A span reads the host
clock and never waits on the card: no ``torch.cuda.synchronize``, no
``.item()``, no ``.cpu()``.  PyTorch queues CUDA work and returns, so a
span around device work times its *enqueue*, as the JAX package's spans
time its asynchronous dispatch.  The device's time shows in the span
that first waits on it: ``host_fetch`` on the batched backend (the one
host read of a generation's error counts), the evaluation's reads on the
loop backend.  A profiler capture (``profiler_dir``) gives each span's
device time: the kernels launched inside its interval.  Adding a sync
here would change the timings it is meant to observe.

Nothing here imports ``repro_torch.engine``: the engine depends on
``obs``, never the reverse, so the gauges read engine state duck-typed
(``clients.materialized``, ``backend.cache_stats``, ...).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import operator
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, record_function

from repro_torch.obs.gauges import host_rss_bytes, live_device_bytes
from repro_torch.obs.sinks import MemorySink, make_sink, parse_sink_spec

# The span vocabulary (nesting paths join these with "/"):
#   sample       participant / client-group / offspring sampling
#   availability the ClientSimulator round draw
#   download     host->device staging of stacked client shards
#   fill_train   a backend training call (fill-train / FedAvg)
#   aggregate    server-side NSGA-II selection bookkeeping
#   eval         a backend evaluation call
#   codec_encode uplink codec compression of the aggregated update
#   codec_decode downlink codec roundtrip of a broadcast payload
#   host_fetch   the per-call host read of the batched eval counts
#   local_sgd    one group's local SGD (one client's on the loop backend):
#                velocity init, the steps, the stacking of its uploads
#   sgd_update   one optimizer step over a client's trained leaves
#   fill_aggregate  one Algorithm 3 call inside a backend's train_fill
#                (masks, the (m, P) flatten and K1, or fill_partial)
PHASES = ("sample", "availability", "download", "fill_train", "aggregate",
          "eval", "codec_encode", "codec_decode", "host_fetch",
          "local_sgd", "sgd_update", "fill_aggregate")

# Spans the port enters and the JAX package does not: ``local_sgd`` and
# ``fill_aggregate`` are only ``jax.named_scope`` labels inside its fused
# programs, and XLA compiles the optimizer update into the step.  A
# comparison with the JAX package's round events drops every path that
# holds one of these.
PORT_ONLY = frozenset({"local_sgd", "sgd_update", "fill_aggregate"})

# CommStats fields whose per-round deltas every RoundEvent carries
COMM_FIELDS = ("down_bytes", "up_bytes", "down_wire_bytes", "up_wire_bytes",
               "eval_down_bytes", "eval_up_bytes", "wasted_down_bytes",
               "wasted_down_wire_bytes", "client_train_passes")


@dataclasses.dataclass
class TelemetryConfig:
    """Every telemetry knob, validated at construction (like the rest of
    ``RunConfig``).  The default ``RunConfig.telemetry = None`` means
    *off* — constructing this object means *on* unless ``enabled=False``.

      * ``sink`` — where round events go beyond the in-memory ring:
        ``"memory"`` (ring only), ``"jsonl:<path>"`` (one JSON object
        per round, appended live) or ``"table"`` (a terminal table row
        per round).
      * ``ring`` — how many ``RoundEvent``s the in-memory ring retains
        (``EngineResult.telemetry.events``); older rounds fall off.
      * ``gauges`` — sample per-round resource gauges (live device
        bytes, host RSS, fleet/cache counters).  Off leaves the gauges
        dict empty but keeps spans/recompiles/comm.
      * ``profiler_dir`` — when set, the whole ``run()`` executes under
        ``torch.profiler.profile`` (CPU activity, and CUDA activity when
        the engine runs on a card), and a Chrome trace
        (``run_<pid>_<ns>.pt.trace.json``) is written into this
        directory when the run ends: open it in Perfetto or
        ``chrome://tracing``; the spans and the ``traced`` programs show
        as ``user_annotation`` events.
      * ``annotations`` — enter a ``torch.profiler.record_function`` per
        span (a host-side record, visible only inside a profiler
        capture)."""
    enabled: bool = True
    sink: str = "memory"
    ring: int = 1024
    gauges: bool = True
    profiler_dir: Optional[str] = None
    annotations: bool = True

    def __post_init__(self):
        if self.ring < 1:
            raise ValueError(f"ring must be >= 1, got {self.ring}")
        parse_sink_spec(self.sink)   # unknown sink specs fail here


@dataclasses.dataclass
class RoundEvent:
    """One federated round, as telemetry saw it.

    ``spans`` maps nesting paths (``"fill_train/download"``) to summed
    host seconds this round; ``span_counts`` the number of times each
    path was entered.  ``recompiles`` holds signature-count *deltas* — a
    backend program that met a new input signature this round appears
    with the number of new signatures, steady-state rounds carry an empty
    dict.  ``gauges`` are point-in-time resource samples at round end;
    ``comm`` the round's ``CommStats`` field deltas."""
    gen: int
    round_s: float
    spans: Dict[str, float]
    span_counts: Dict[str, int]
    recompiles: Dict[str, int]
    gauges: Dict[str, Any]
    comm: Dict[str, float]


@dataclasses.dataclass
class TelemetryResult:
    """What ``EngineResult.telemetry`` carries after a telemetry-enabled
    run: the ring of ``RoundEvent``s plus the final per-program signature
    counts."""
    events: List[RoundEvent]
    trace_counts: Dict[str, int]

    def phase_totals(self) -> Dict[str, float]:
        """Total seconds per span path across all retained rounds."""
        out: Dict[str, float] = {}
        for e in self.events:
            for path, s in e.spans.items():
                out[path] = out.get(path, 0.0) + s
        return out


def signature(x):
    """The input signature of a program argument: tensors and numpy
    arrays by (shape, dtype, device), Python ``float``/``int`` by type,
    ``str``, ``bool``, ``None``, dtypes and devices by value, lists,
    tuples and dicts recursively (dict items sorted by key, as a pytree
    flattens them: the keys must be comparable), any other object by
    type.  Reads only metadata: never a tensor's values, so it waits on
    nothing."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device)
    if isinstance(x, (np.ndarray, np.generic)):
        return ("ndarray", np.shape(x), x.dtype.str)
    if x is None or isinstance(x, (bool, str, torch.dtype, torch.device)):
        return x
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(signature(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, signature(v)) for k, v in
                            sorted(x.items(), key=operator.itemgetter(0))))
    return type(x)


def traced(name: str, counts: Dict[str, int], fn):
    """Wrap a backend program so each new **input signature** increments
    ``counts[name]``, and run its body under
    ``torch.profiler.record_function(name)`` (the counterpart of
    ``jax.named_scope``).

    Eager PyTorch compiles nothing, so this counts signatures, not
    compilations: ``counts[name]`` is the number of distinct
    ``signature(args, kwargs)`` the program has met, the key a
    ``jax.jit`` trace cache keys on, and where a captured version of the
    program (a CUDA graph) would need a new capture.  Two calls with equal
    signatures count once; a new shape counts again.  The wrapper calls
    ``fn`` unchanged: it adds no launch and changes no result."""
    seen = set()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        sig = signature((args, kwargs))
        if sig not in seen:
            seen.add(sig)
            counts[name] = counts.get(name, 0) + 1
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapper


def innermost(backend):
    """The raw execution backend under any wrapper chain
    (``InstrumentedBackend`` -> ``CodecBackend`` -> backend)."""
    while hasattr(backend, "inner"):
        backend = backend.inner
    return backend


def attach(backend, telemetry) -> None:
    """Point every layer of a backend wrapper chain at ``telemetry``
    (each layer defaults to ``NULL_TELEMETRY`` as a class attribute)."""
    while backend is not None:
        backend.telemetry = telemetry
        backend = getattr(backend, "inner", None)


class _NullSpan:
    """A context manager that does nothing, shared by every
    ``NULL_TELEMETRY.span`` call."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """The disabled telemetry object: every hook is a no-op, every span
    an empty context manager.  One shared instance (``NULL_TELEMETRY``)
    serves the engine, every strategy and every backend layer, so the
    telemetry-off hot path costs a single attribute lookup per hook."""
    __slots__ = ()
    enabled = False

    def span(self, name: str):
        return _NULL_SPAN

    def start_run(self, engine) -> None:
        pass

    def end_round(self, gen: int, round_s: float, engine) -> None:
        pass

    def run_capture(self):
        return contextlib.nullcontext()

    def result(self, engine) -> None:
        return None


NULL_TELEMETRY = NullTelemetry()


class _Span:
    """One entry of a span.  Its host time covers its own
    ``record_function``, so the interval a profiler capture records for
    it lies inside the one its ``RoundEvent`` times (``round_split``'s
    ``consistent``), however many times the span is entered."""
    __slots__ = ("tel", "name", "t0", "rf")

    def __init__(self, tel: "Telemetry", name: str):
        self.tel = tel
        self.name = name

    def __enter__(self):
        tel = self.tel
        self.t0 = time.perf_counter()
        if tel.annotations:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        tel._stack.append(self.name)
        return self

    def __exit__(self, *exc):
        tel = self.tel
        path = "/".join(tel._stack)
        tel._stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dt = time.perf_counter() - self.t0
        tel._spans[path] = tel._spans.get(path, 0.0) + dt
        tel._counts[path] = tel._counts.get(path, 0) + 1
        return False


@contextlib.contextmanager
def _profile(profiler_dir: str, cuda: bool):
    """One ``run()`` under ``torch.profiler``; its Chrome trace is written
    into ``profiler_dir`` when the run returns."""
    os.makedirs(profiler_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profiler_dir, f"run_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


class Telemetry:
    """The live telemetry object of one engine.

    ``FedEngine`` owns exactly one (when ``RunConfig.telemetry`` is
    enabled), built with the engine's ``RunConfig.device`` (which the
    gauges read and the profiler capture traces), shares it with every
    backend layer (``attach``) and drives the run lifecycle:
    ``start_run`` resets all state (run re-entrancy), ``span`` times a
    phase on the shared nesting stack, ``end_round`` assembles the
    round's ``RoundEvent`` and pushes it to the ring + sink, ``result``
    returns the ``TelemetryResult`` stamped onto ``EngineResult``."""

    enabled = True

    def __init__(self, cfg: TelemetryConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.annotations = cfg.annotations
        self.ring = MemorySink(cfg.ring)
        self.sink = (None if cfg.sink == "memory"
                     else make_sink(cfg.sink, ring=cfg.ring))
        self._stack: List[str] = []
        self._spans: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._tc_snap: Dict[str, int] = {}
        self._comm_snap: Dict[str, float] = {}
        self._peak_live = 0

    # -- lifecycle -----------------------------------------------------------

    def start_run(self, engine) -> None:
        """Reset per-run state; snapshot signature counts so signatures
        met before the run (a backend reused across runs) are not booked
        to round 1."""
        self.ring.reset()
        self._stack = []
        self._spans = {}
        self._counts = {}
        self._peak_live = 0
        self._tc_snap = dict(self._trace_counts(engine))
        self._comm_snap = {f: 0.0 for f in COMM_FIELDS}

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def run_capture(self):
        """The profiler capture context for one ``run()`` —
        ``torch.profiler.profile`` writing a Chrome trace into
        ``profiler_dir`` when configured, a no-op otherwise."""
        if self.cfg.profiler_dir:
            return _profile(self.cfg.profiler_dir,
                            cuda=self.device.type == "cuda")
        return contextlib.nullcontext()

    def end_round(self, gen: int, round_s: float, engine) -> RoundEvent:
        """Assemble and emit this round's event, then reset the span
        accumulators for the next round."""
        tc = dict(self._trace_counts(engine))
        recompiles = {k: v - self._tc_snap.get(k, 0) for k, v in tc.items()
                      if v != self._tc_snap.get(k, 0)}
        self._tc_snap = tc
        comm = {}
        for f in COMM_FIELDS:
            v = float(getattr(engine.stats, f, 0.0))
            comm[f] = v - self._comm_snap.get(f, 0.0)
            self._comm_snap[f] = v
        event = RoundEvent(gen=gen, round_s=round_s,
                           spans=self._spans, span_counts=self._counts,
                           recompiles=recompiles,
                           gauges=self._gauges(engine), comm=comm)
        self._spans = {}
        self._counts = {}
        self.ring.emit(event)
        if self.sink is not None:
            self.sink.emit(event)
        return event

    def result(self, engine) -> TelemetryResult:
        return TelemetryResult(events=list(self.ring.events),
                               trace_counts=dict(self._trace_counts(engine)))

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _trace_counts(engine) -> Dict[str, int]:
        return getattr(innermost(engine.backend), "trace_counts", {})

    def _gauges(self, engine) -> Dict[str, Any]:
        if not self.cfg.gauges:
            return {}
        live = live_device_bytes(self.device)
        self._peak_live = max(self._peak_live, live)
        out: Dict[str, Any] = {
            "live_device_bytes": live,
            "peak_live_device_bytes": self._peak_live,
            "host_rss_bytes": host_rss_bytes(),
        }
        clients = getattr(engine, "clients", None)
        materialized = getattr(clients, "materialized", None)
        if materialized is not None:     # lazy ClientFleet only
            out["clients_materialized"] = materialized
            out["clients_cached"] = getattr(clients, "cached", None)
            out["fleet_hits"] = getattr(clients, "hits", None)
        cache_stats = getattr(innermost(engine.backend), "cache_stats", None)
        if cache_stats is not None:      # stacked (vmap) backend only
            out.update(cache_stats)
        return out
