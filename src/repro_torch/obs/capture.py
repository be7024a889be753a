"""Reading a ``TelemetryConfig.profiler_dir`` capture: one round split
by phase, on the host and on the device.

The engine's spans time the host's enqueue of device work (see
``telemetry``); the capture holds the device's side.  ``round_split``
joins the two for one generation:

  * the spans are the capture's ``user_annotation`` events named after
    ``PHASES``, nested by interval containment on the host's timeline
    into the same paths the ``RoundEvent``s record
    (``"fill_train/download"``); a generation's top-level spans are
    found by counting: generation g's are the next
    ``sum(top-level span_counts of g)`` after those of the generations
    before it;
  * each device activity (kernel, memcpy, memset) is matched to the
    runtime call that launched it by its correlation id, and counts
    toward every span whose host interval holds that launch;
  * the generation's window runs from its first top-level span's start
    to the later of its last span's end and the end of the last device
    activity it launched; busy time is the union of those activities'
    intervals, the idle share ``1 - busy / window``;
  * each stretch of that window in which the device runs nothing is
    put down to the innermost span open at its midpoint (``"between
    spans"`` when none is): with the spans inside ``fill_train``
    (``local_sgd``, ``sgd_update``, ``fill_aggregate``) it says which
    part of the host's work the device waited on.

Host times are the ``RoundEvent``'s (``time.perf_counter`` inside the
engine), not the capture's: a profiled run's host is slower than an
unprofiled one, so compare its spans with an unprofiled run's.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence

from repro_torch.obs.telemetry import PHASES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(profiler_dir: str) -> List[dict]:
    """The ``traceEvents`` of the newest Chrome trace in ``profiler_dir``
    (raises ``FileNotFoundError`` when there is none)."""
    files = sorted(glob.glob(os.path.join(profiler_dir, "*.json")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no Chrome trace in {profiler_dir}")
    with open(files[-1]) as f:
        return json.load(f)["traceEvents"]


def span_intervals(trace: Sequence[dict]) -> List[tuple]:
    """(path, start µs, end µs) of every phase span in the capture, in
    start order, nested by containment per host thread."""
    spans = sorted((e for e in trace if e.get("cat") == "user_annotation"
                    and e.get("name") in PHASES),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    out, stack, tid = [], [], None
    for e in spans:
        if e["tid"] != tid:
            stack, tid = [], e["tid"]
        start, end = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1][1] <= start:
            stack.pop()
        path = "/".join([p for p, _ in stack] + [e["name"]])
        stack.append((path.rsplit("/", 1)[-1], end))
        out.append((path, start, end))
    out.sort(key=lambda s: s[1])
    return out


def _device_activity(trace: Sequence[dict]) -> List[tuple]:
    """(launch µs, start µs, duration µs, name) of every device activity
    whose launching runtime call is in the capture."""
    launch = {e["args"]["correlation"]: e["ts"] for e in trace
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    return [(launch[e["args"]["correlation"]], e["ts"], e["dur"], e["name"])
            for e in trace if e.get("cat") in DEVICE_CATS
            and e.get("args", {}).get("correlation") in launch]


def _union(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _gaps(intervals, lo, hi) -> List[tuple]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def round_split(trace: Sequence[dict], events: Sequence, gen: int,
                top: int = 5) -> Dict:
    """Generation ``gen`` of a profiled run, split by span path: for each
    path its host ms (the ``RoundEvent``'s), its entries, its ms in the
    capture (``trace_ms``), and the count and ms of the device activities
    launched inside it; the generation's device-busy ms, window ms and
    idle share; the device's idle ms by the innermost span path open
    over each idle stretch (``idle_ms``); the device ms launched outside
    every top-level span; the ``top`` device activities by total time,
    as (name, calls, ms); and
    ``consistent``: whether every path's capture ms is within 1 ms + 5 %
    of its host ms (the capture's spans are the ones the ``RoundEvent``
    timed).  ``events`` are the run's ``RoundEvent``s from generation 1
    on."""
    spans = span_intervals(trace)
    tops = [s for s in spans if "/" not in s[0]]
    n_top = [sum(c for p, c in e.span_counts.items() if "/" not in p)
             for e in events]
    before = sum(n_top[:gen - 1])
    mine = tops[before:before + n_top[gen - 1]]
    if len(mine) != n_top[gen - 1]:
        raise ValueError(f"generation {gen}: {len(mine)} top-level spans in "
                         f"the capture, {n_top[gen - 1]} in its RoundEvent")
    lo, hi = mine[0][1], mine[-1][2]
    inner = [s for s in spans if lo <= s[1] and s[2] <= hi]
    acts = [a for a in _device_activity(trace) if lo <= a[0] <= hi]
    event = events[gen - 1]
    paths: Dict[str, Dict] = {}
    for path, s, e in inner:
        row = paths.setdefault(path, {
            "host_ms": event.spans.get(path, 0.0) * 1e3, "count": 0,
            "trace_ms": 0.0, "activities": 0, "device_ms": 0.0})
        mine_acts = [d for t, _, d, _ in acts if s <= t <= e]
        row["count"] += 1
        row["trace_ms"] += (e - s) / 1e3
        row["activities"] += len(mine_acts)
        row["device_ms"] += sum(mine_acts) / 1e3
    consistent = all(abs(r["trace_ms"] - r["host_ms"])
                     <= 1.0 + 0.05 * r["host_ms"] for r in paths.values())
    outside = sum(d for t, _, d, _ in acts
                  if not any(s <= t <= e for _, s, e in mine))
    end = max([hi] + [s + d for _, s, d, _ in acts])
    ivs = [(s, s + d) for _, s, d, _ in acts]
    busy = _union(ivs)
    idle: Dict[str, float] = {}
    for g0, g1 in _gaps(ivs, lo, end):
        mid = (g0 + g1) / 2
        open_ = [p for p, s, e in inner if s <= mid <= e]
        name = max(open_, key=len) if open_ else "between spans"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e3
    by_name: Dict[str, list] = {}
    for _, _, d, name in acts:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += d
    kernels = sorted(((n, c, d / 1e3) for n, (c, d) in by_name.items()),
                     key=lambda r: -r[2])[:top]
    return {"gen": gen, "round_s": event.round_s, "spans": paths,
            "device_busy_ms": busy / 1e3, "window_ms": (end - lo) / 1e3,
            "idle_share": 1.0 - busy / (end - lo), "idle_ms": idle,
            "device_ms_outside_spans": outside / 1e3, "top": kernels,
            "consistent": consistent}
