"""Round-event sinks: where telemetry's per-round records go.

Three built-ins, selected by ``TelemetryConfig.sink``:

  * ``"memory"`` — ring only (``MemorySink`` is always active as the
    ring behind ``EngineResult.telemetry.events``)
  * ``"jsonl:<path>"`` — append one JSON object per round, flushed per
    event so a crashed or killed run keeps everything up to its last
    completed round
  * ``"table"`` — human-oriented terminal table, one row per round

All sinks consume the same ``RoundEvent`` dataclass; ``event_dict``
defines the JSON shape.  Pure Python: the same behaviour as the JAX
package's ``repro.obs.sinks``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import sys
from typing import Any, Dict, Tuple


def parse_sink_spec(spec: str) -> Tuple[str, str]:
    """Validate and split a sink spec into ``(kind, arg)``.

    Raises ``ValueError`` for unknown kinds or a pathless jsonl spec —
    called from ``TelemetryConfig.__post_init__`` so bad specs fail at
    config construction, not mid-run.
    """
    if spec == "memory" or spec == "table":
        return spec, ""
    if spec.startswith("jsonl:"):
        path = spec[len("jsonl:"):]
        if not path:
            raise ValueError("jsonl sink needs a path: 'jsonl:<path>'")
        return "jsonl", path
    raise ValueError(
        f"unknown telemetry sink {spec!r} "
        "(expected 'memory', 'jsonl:<path>' or 'table')")


def event_dict(event) -> Dict[str, Any]:
    """A RoundEvent as a plain JSON-serializable dict."""
    return dataclasses.asdict(event)


class MemorySink:
    """Bounded in-memory ring of the most recent ``RoundEvent``s."""

    def __init__(self, ring: int):
        self.events = collections.deque(maxlen=ring)

    def emit(self, event) -> None:
        self.events.append(event)

    def reset(self) -> None:
        self.events.clear()


class JsonlSink:
    """One JSON object per round appended to ``path`` and flushed
    immediately (lazy-opened so merely constructing a config never
    touches the filesystem)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def emit(self, event) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        json.dump(event_dict(event), self._fh)
        self._fh.write("\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TableSink:
    """A terminal table, one row per round: round time, top span paths,
    recompiles and headline gauges."""

    _HEADER = (f"{'gen':>4} {'round_s':>8} {'fill_train':>10} {'eval':>8} "
               f"{'sample':>8} {'retrace':>7} {'live_MB':>8} {'up_MB':>8}")

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stdout
        self._printed_header = False

    def emit(self, event) -> None:
        if not self._printed_header:
            print(self._HEADER, file=self.stream)
            print("-" * len(self._HEADER), file=self.stream)
            self._printed_header = True
        spans = event.spans

        def top(name: str) -> float:
            # a phase plus everything nested beneath it
            return sum(s for path, s in spans.items()
                       if path == name or path.startswith(name + "/"))

        live = event.gauges.get("live_device_bytes", 0) / 1e6
        up = event.comm.get("up_bytes", 0.0) / 1e6
        print(f"{event.gen:>4} {event.round_s:>8.3f} "
              f"{top('fill_train'):>10.3f} {top('eval'):>8.3f} "
              f"{top('sample'):>8.3f} {sum(event.recompiles.values()):>7d} "
              f"{live:>8.1f} {up:>8.2f}", file=self.stream)


def make_sink(spec: str, ring: int = 1024):
    """Construct the sink a validated spec names."""
    kind, arg = parse_sink_spec(spec)
    if kind == "memory":
        return MemorySink(ring)
    if kind == "jsonl":
        return JsonlSink(arg)
    return TableSink()
