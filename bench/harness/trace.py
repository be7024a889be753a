"""Reduction of a profiler capture to per-generation numbers.

A frozen copy of the repository's span join (``round_split``): the
capture's ``user_annotation`` events named after the engine's phases are
nested by containment into span paths; each device activity is matched
to the runtime call that launched it by its correlation id and counts
toward every span whose host interval holds that launch.  A generation's
top-level spans are found by counting, from the first profiled
generation on.  Beside the copy: device time by kernel name, and the
idle gaps of the device laid against the host span that was open.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

PHASES = ("sample", "availability", "download", "fill_train", "aggregate",
          "eval", "codec_encode", "codec_decode", "host_fetch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def span_intervals(trace: Sequence[dict]) -> List[tuple]:
    """(path, start us, end us) of every phase span, in start order,
    nested by containment per host thread."""
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


def device_activity(trace: Sequence[dict]) -> List[tuple]:
    """(launch us, start us, duration us, name) of every device activity
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


def split(trace: Sequence[dict], top_counts: Sequence[int], index: int
          ) -> Dict:
    """Profiled generation ``index`` (0 = the first in the capture), given
    ``top_counts``: the number of top-level spans of each profiled
    generation, in order.  Returns device ms launched inside each span
    path, device ms by kernel name, busy and window ms, and idle ms by
    the innermost span open over each gap ("between spans" outside)."""
    spans = span_intervals(trace)
    tops = [s for s in spans if "/" not in s[0]]
    before = sum(top_counts[:index])
    mine = tops[before:before + top_counts[index]]
    if len(mine) != top_counts[index]:
        raise ValueError(f"profiled generation {index}: {len(mine)} "
                         f"top-level spans in the capture, "
                         f"{top_counts[index]} counted by the engine")
    lo, hi = mine[0][1], mine[-1][2]
    inner = [s for s in spans if lo <= s[1] and s[2] <= hi]
    acts = [a for a in device_activity(trace) if lo <= a[0] <= hi]
    paths: Dict[str, float] = {}
    for path, s, e in inner:
        paths[path] = paths.get(path, 0.0) + sum(
            d for t, _, d, _ in acts if s <= t <= e) / 1e3
    by_name: Dict[str, float] = {}
    for _, _, d, name in acts:
        by_name[name] = by_name.get(name, 0.0) + d / 1e3
    end = max([hi] + [s + d for _, s, d, _ in acts])
    ivs = [(s, s + d) for _, s, d, _ in acts]
    idle: Dict[str, float] = {}
    for g0, g1 in _gaps(ivs, lo, end):
        mid = (g0 + g1) / 2
        open_ = [p for p, s, e in inner if s <= mid <= e]
        name = max(open_, key=len) if open_ else "between spans"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e3
    return {"device_ms": paths, "kernels_ms": by_name,
            "busy_ms": _union(ivs) / 1e3, "window_ms": (end - lo) / 1e3,
            "idle_ms": idle}
