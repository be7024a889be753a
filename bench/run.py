"""The benchmark of the PyTorch/CUDA port: steady search generations of
``repro_torch``'s real-time federated NAS (``FedEngine.run`` with
``RealTimeNas``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Every cell of ``BENCHMARK.json`` names a configuration (``configs/``),
a traffic mix (``traffic/``) and its limits (``limits/<cell>.json``);
per-layer metrics are read by ``metrics/<metric>.py``.  One run is one
process on the card(s) it finds; it prints one JSON object as the last
line of standard output, and the numbers that decide ``correct`` beside
their limits as the last lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
# cuBLAS keeps to one order of summation only with a fixed workspace; read
# when the card's first handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# top-level module names the run's process may not hold once the window
# has closed: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BIG = 10 ** 9           # generations asked of the engine; the window ends it


def load_cell(root: Path, workload: str):
    """(manifest, cell, config, traffic, limits) of ``workload``, each
    file found by its name."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    bench = Path(__file__).resolve().parent
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return manifest, cell, config, traffic, limits


def metric_readers(manifest: dict, workload: str) -> dict:
    """name -> ``read(record)`` of each per-layer metric this cell
    reports, loaded from ``metrics/<name>.py``."""
    out = {}
    for m in manifest["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        path = Path(__file__).resolve().parent / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = (mod.read, m["unit"])
    return out


def _program(config: dict):
    """The program's supernet API for ``config`` (its ``program``
    settings, as the port's ``ModelConfig`` takes them)."""
    import repro_torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.supernet import make_api
    origin = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in origin.parents:
        raise RuntimeError(f"repro_torch imported from {origin}, not from "
                           f"this checkout's src/")
    return make_api(ModelConfig(**config["program"]))


def _gen_work(config, traffic, clients, calls) -> tuple:
    """(FLOPs, K1 bytes) the generation needs, from its recorded calls."""
    from bench.harness import counts
    epochs = traffic["run"]["local_epochs"]
    flops = kbytes = 0.0
    for keys, groups in calls["train"]:
        up = []
        for key, group in zip(keys, groups):
            macs = counts.fwd_macs(config, key)
            for cid in group:
                n = clients[int(cid)].train[1].size
                flops += 6.0 * macs * n * epochs
                up.append(key)
        if up:
            kbytes += counts.k1_bytes(config, up)
    for keys, ids in calls["eval"]:
        n = sum(clients[int(i)].test[1].size for i in ids)
        flops += sum(2.0 * counts.fwd_macs(config, k) * n for k in keys)
    return flops, kbytes


def _card() -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def _numerics(config: dict) -> None:
    """The card's arithmetic as the configuration states it: float32
    without TF32, and every run of a seed the same arithmetic (cuDNN's
    and cuBLAS's deterministic algorithms), so that a seed's search
    takes the same path each time."""
    import torch
    num = config["numerics"]
    torch.backends.cuda.matmul.allow_tf32 = num["tf32"]
    torch.backends.cudnn.allow_tf32 = num["tf32"]
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = num["deterministic"]
    torch.use_deterministic_algorithms(num["deterministic"], warn_only=True)


def run_cell(cell, config, traffic, limits, readers, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             hooks: dict | None = None) -> dict:
    """One run of ``cell``: set-up, the window, the check; returns the
    result object.  The benchmark makes the clients and the initial
    master from ``seed``; the search draws its architectures from the
    traffic file's ``search_seed``, the same for every seed.  ``hooks``
    (the calibration and the tests) may replace the program's supernet
    API (``"api"``) or change its engine (``"engine"``)."""
    import numpy as np
    import torch
    from bench.harness import check, generate, trace as tr, window

    hooks = hooks or {}
    if device == "cuda":
        _numerics(config)
    from repro_torch.engine import FedEngine, RunConfig
    from repro_torch.obs.telemetry import TelemetryConfig

    ref = importlib.import_module(f"bench.reference.{config['reference']}")
    first = [ref.init(config["model"], seed, device)]
    api = dataclasses.replace(_program(config), init=lambda gen: first.pop())
    if "api" in hooks:
        api = hooks["api"](api)
    clients = generate.make_clients(traffic, seed)
    run = traffic["run"]
    warmup = traffic["warmup_generations"]
    check_gen = warmup + 1 + int(
        np.random.default_rng(seed).integers(0, traffic["check_span"]))
    rc = RunConfig(seed=traffic["search_seed"], generations=BIG,
                   device=device,
                   telemetry=TelemetryConfig() if trace else None, **run)
    engine = FedEngine(api, clients, rc)
    if "engine" in hooks:
        hooks["engine"](engine)
    rec = window.Recorder(engine.backend, check_gen)
    engine.backend = rec

    n_prof = traffic["profile_generations"] if trace else 0
    events, profiler = {}, None

    def on_close():
        nonlocal profiler
        if n_prof:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            profiler = profile(activities=acts)
            profiler.start()

    def on_gen(gen):
        if trace:
            events[gen] = engine.telemetry.ring.events[-1]

    state = window.drive(engine, rec, warmup, seconds, on_gen,
                         after=n_prof, on_close=on_close)
    if n_prof:
        if device == "cuda":
            torch.cuda.synchronize()
        profiler.stop()
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    t_open, t_close = state["open"], state["close"]
    gens = state["gens"]
    finite = all(bool(torch.isfinite(v).all())
                 for v in engine.strategy.master.values())
    attempted = failed = 0
    for g in gens:
        c = rec.calls[g]
        n_up = sum(len(gr) for _, groups in c["train"] for gr in groups)
        n_ev = sum(len(k) for k, _ in c["eval"])
        objs = state["reports"][g].objs
        attempted += n_up + n_ev
        failed += int(np.sum(~np.isfinite(objs[:, 0]) | (objs[:, 0] < 0)))
    if not finite:
        failed = attempted
    snap = rec.snap
    snap.update(gen=check_gen, objs=state["reports"][check_gen].objs,
                parents=state["reports"][check_gen].parent_keys,
                prev_parents=state["reports"][check_gen - 1].parent_keys)
    rec.inner = None
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    out_metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        record = _trace_record(tr, profiler, events, state, rec, config,
                               traffic, clients)
        for name, (read, unit) in readers.items():
            value = read(record)
            if value is not None:
                out_metrics[name] = {"value": value, "unit": unit}
        prof = [g for g in record["gens"] if g["profiled"]]
        dev_extra = {"busy_s": sum(g["busy_ms"] for g in prof) / 1e3,
                     "window_s": sum(g["window_ms"] for g in prof) / 1e3}
        breakdown = _breakdown(prof)
    else:
        work = sum(_gen_work(config, traffic, clients, rec.calls[g])[0]
                   for g in gens)
        out_metrics = {
            "search_gflop_per_s": {"value": work / 1e9 / (t_close - t_open),
                                   "unit": "GFLOP/s"},
            "setup_s": {"value": t_open - T0, "unit": "s"}}

    got = check.readings(ref, snap, clients, config, run)
    checks = {k: {"value": got[k], "limit": lim} for k, lim in limits.items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": out_metrics}
    if device == "cuda":
        result["device"] = dict(_card(), count=cell["chips"],
                                memory_peak_bytes=peak, **dev_extra)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0, **dev_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"generations": len(gens),
                        "seconds": t_close - t_open,
                        "round_s": [state["round_s"][g] for g in gens],
                        "warmup_round_s": [state["round_s"][g]
                                           for g in range(1, warmup + 1)],
                        "gflop": [_gen_work(config, traffic, clients,
                                            rec.calls[g])[0] / 1e9
                                  for g in gens],
                        "checked_generation": check_gen}
    result["readings"] = got
    result["checks"] = checks
    return result


def _trace_record(tr, profiler, events, state, rec, config, traffic,
                  clients) -> dict:
    """What the per-layer readers read: per generation of the window and
    of those profiled after it, its ``round_s``, host ms by span, FLOPs
    and K1 bytes, and for the profiled ones the capture's split."""
    from bench.harness import counts
    prof_gens = state["after"]
    trace = []
    if prof_gens:
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            profiler.export_chrome_trace(path)
            trace = tr.load(path)
    tops = [sum(c for p, c in events[g].span_counts.items() if "/" not in p)
            for g in prof_gens]
    gens = []
    for g in state["gens"] + prof_gens:
        flops, kb = _gen_work(config, traffic, clients, rec.calls[g])
        row = {"gen": g, "round_s": state["round_s"][g],
               "profiled": g in prof_gens, "flops": flops, "k1_bytes": kb,
               "host_ms": {p: s * 1e3 for p, s in events[g].spans.items()}}
        if g in prof_gens:
            row.update(tr.split(trace, tops, prof_gens.index(g)))
        gens.append(row)
    return {"gens": gens,
            "peak_flops": counts.PEAK_FLOPS[config["model"]["dtype"]],
            "hbm_bytes_per_s": counts.HBM_BYTES_PER_S}


def _breakdown(prof: list) -> dict:
    ops, idle = {}, {}
    for g in prof:
        for name, ms in g["kernels_ms"].items():
            ops[name] = ops.get(name, 0.0) + ms / 1e3
        for name, ms in g["idle_ms"].items():
            idle[name] = idle.get(name, 0.0) + ms / 1e3
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest, cell, config, traffic, limits = load_cell(ROOT, args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result = run_cell(cell, config, traffic, limits,
                      metric_readers(manifest, args.workload) if args.trace
                      else {}, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run's process holds {bad}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
