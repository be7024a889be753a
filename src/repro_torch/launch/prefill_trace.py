"""Device-time breakdown of one prefill on the card.

    python -m repro_torch.launch.prefill_trace --arch granite-moe-1b-a400m
    python -m repro_torch.launch.prefill_trace --arch qwen1.5-0.5b \\
        --backend torch
    python -m repro_torch.launch.prefill_trace --arch zamba2-2.7b \\
        --backend chunked
    python -m repro_torch.launch.prefill_trace --arch whisper-large-v3 \\
        --prompt-len 448

The config runs at full width with seeded random weights, on 4 requests
of 1024 tokens (``--prompt-len``; the serving shape of
``chip_smoke.py``), after a seeded prefix of ``num_prefix`` embeddings
(normal x 0.1) for the VLM (``internvl2-1b``: 256 patches) and audio
(``whisper-large-v3``: 1500 frames through the encoder) models.  One prefill warms up; the next runs under
``torch.profiler``.  Prints the untraced prefill's wall time (host clock
around one prefill that ends in a synchronise, median of 3), the traced
one's, the device's busy time (the sum of its traced activities: one
stream, so they do not overlap), its idle share of both walls, and the
device activities with the most time, grouped by name.  The profiler
slows the host, not the device: the traced wall overstates the idle
share, the untraced one is the estimate to read.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, Iterable, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from repro_torch.configs import get_config
from repro_torch.launch.serve import make_prefill_step
from repro_torch.models import transformer as tr


def summarize(events: Iterable[Tuple[str, float]], wall_ms: float,
              top: int) -> Dict:
    """``events``: (name, device µs) of every traced device activity ->
    busy ms, idle share of ``wall_ms``, and the ``top`` names by device
    time as (name, calls, ms)."""
    by: Dict[str, Tuple[int, float]] = {}
    for name, us in events:
        calls, total = by.get(name, (0, 0.0))
        by[name] = (calls + 1, total + us)
    busy = sum(t for _, t in by.values()) / 1e3
    rows = sorted(((n, c, t / 1e3) for n, (c, t) in by.items()),
                  key=lambda r: -r[2])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "top": rows}


REQUESTS, PROMPT_LEN, TOP = 4, 1024, 15


def trace_prefill(cfg, params, batch: Dict, *, window: int = 0,
                  backend: str = "kernel") -> Dict:
    step = make_prefill_step(cfg, window=window, backend=backend)
    walls = []
    for _ in range(4):              # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler traced no device activity")
    out = summarize(events, wall, TOP)
    out["untraced_wall_ms"] = statistics.median(walls[1:])
    out["untraced_idle_share"] = (1.0 - out["busy_ms"]
                                  / out["untraced_wall_ms"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="device-time breakdown of "
                                 "one prefill")
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--backend", default="kernel",
                    help="kernel, torch or chunked")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--dtype", default="", help="override the config's")
    ap.add_argument("--prompt-len", type=int, default=PROMPT_LEN)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("prefill_trace needs a CUDA device")
    cfg = get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = tr.init_params(gen, cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (REQUESTS, args.prompt_len),
                                         generator=gen, device="cuda")}
        if cfg.family in ("vlm", "audio"):
            batch["prefix"] = torch.randn(
                (REQUESTS, cfg.num_prefix, cfg.d_model), generator=gen,
                device="cuda") * 0.1
        res = trace_prefill(cfg, params, batch, window=args.window,
                            backend=args.backend)
    prefix = f" after {cfg.num_prefix} prefix embeddings" \
        if "prefix" in batch else ""
    label = (f"{cfg.name} {cfg.dtype} prefill of {REQUESTS} x "
             f"{args.prompt_len} tokens{prefix}, window {args.window}, "
             f"{args.backend} route, on {torch.cuda.get_device_name(0)}")
    print(f"{label}: wall {res['untraced_wall_ms']!r} ms untraced, "
          f"{res['wall_ms']!r} ms traced; device busy {res['busy_ms']!r} "
          f"ms, idle {res['untraced_idle_share']!r} of the untraced wall, "
          f"{res['idle_share']!r} of the traced")
    for name, calls, ms in res["top"]:
        print(f"  {ms:10.4f} ms {calls:5d} x  {name[:100]}")
    print(json.dumps({"label": label, **res}))


if __name__ == "__main__":
    main()
