#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``); float32
   convolutions and matmuls in full float32 (TF32 off) and cuDNN
   deterministic, so that two runs differ only where the code differs;
2. build: every CUDA kernel of the main path, from ``csrc/`` with nvcc;
3. check: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged ones, rtol = atol = 1e-6;
4. timing: each kernel at the main path's shape, beside its bound, its
   plain version and the nearest single PyTorch call;
5. main path: ``FedEngine`` + ``RealTimeNas`` on the full 12-block CIFAR
   supernet (26,119,059 parameters), 8 clients, 2 generations, with
   Algorithm 3 on the kernel; the launch counts are zeroed just before
   and read just after;
6. the same run with Algorithm 3 in plain PyTorch: equal keys and
   CommStats, masters within 1e-4; and the smoke-size run on the card
   against the same run on the CPU (the path the CPU tests hold against
   the JAX package).

Prints the kernels as one JSON line, then the ``nvidia-smi`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
without that line if any phase fails or no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cnn_supernet_api  # noqa: E402
from repro_torch.data import make_classification, make_clients, \
    partition_iid  # noqa: E402
from repro_torch.engine import FedEngine, RunConfig  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

TOL = 1e-6              # <= 8 float32 terms summed in another order, FMA
MASTER_TOL = 1e-4       # route-to-route gap of the final master
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM data sheet, float32 without tensor cores
MAIN_M, MAIN_P = 8, 26_119_059   # uploads per train_fill x master params
# lr0 0.01, as the CPU parity tests: the compared runs then differ at
# round-off and no argmax flips between them
RUN = dict(population=4, generations=2, backend="loop", lr0=0.01,
           device="cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fill_inputs(m, p, seed, zero_weight_row=False, zero_masks=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.randn(m, p, device="cuda", generator=g)
    mk = torch.randint(0, 2, (m, p), device="cuda", generator=g).float()
    if zero_masks:
        mk.zero_()
    w = torch.rand(m, device="cuda", generator=g)
    if zero_weight_row:
        w[0] = 0.0
    w = w / w.sum()
    prev = torch.randn(p, device="cuda", generator=g)
    return cl, mk, w, prev


def check_fill_aggregate() -> float:
    cases = [dict(m=1, p=1000), dict(m=2, p=8193), dict(m=5, p=100_000),
             dict(m=MAIN_M, p=MAIN_P),
             dict(m=5, p=100_003, zero_weight_row=True),
             dict(m=MAIN_M, p=MAIN_P, zero_masks=True)]
    worst = 0.0
    for i, case in enumerate(cases):
        cl, mk, w, prev = fill_inputs(seed=i, **case)
        out = ops.fill_aggregate(cl, mk, w, prev)
        torch.cuda.synchronize()
        plain = ref.fill_aggregate(cl, mk, w, prev)
        torch.testing.assert_close(out, plain, rtol=TOL, atol=TOL)
        if case.get("zero_masks"):
            torch.testing.assert_close(out, prev, rtol=TOL, atol=TOL)
        err = float((out - plain).abs().max())
        worst = max(worst, err)
        log(f"check fill_aggregate {case}: max |kernel - plain| = {err!r}")
        del cl, mk, w, prev, out, plain
    torch.cuda.empty_cache()
    return worst


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def time_fill_aggregate(card: str) -> dict:
    m, p = MAIN_M, MAIN_P
    cl, mk, w, prev = fill_inputs(m, p, seed=99)
    nbytes = (2 * m + 1) * p * 4 + m * 4 + p * 4
    flops = 6 * m * p      # (1 - mk), two products, a sum, then an FMA
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    res = {
        "ms": median_ms(lambda: ops.fill_aggregate(cl, mk, w, prev), 30),
        "plain_ms": median_ms(lambda: ref.fill_aggregate(cl, mk, w, prev),
                              10),
        # nearest single PyTorch expression; timed here, never used
        "library_ms": median_ms(
            lambda: w @ torch.lerp(prev.expand_as(cl), cl, mk), 10),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    log(f"timing fill_aggregate (m={m}, P={p}) on {card}: kernel "
        f"{res['ms']!r} ms, bound {res['bound_ms']!r} ms ({res['bound_by']}"
        f", {nbytes} B), plain {res['plain_ms']!r} ms, library "
        f"{res['library_ms']!r} ms")
    del cl, mk, w, prev
    torch.cuda.empty_cache()
    return res


def full_width_clients():
    x, y = make_classification(0, 1600, image=32)
    return make_clients(x, y, partition_iid(0, 1600, 8), batch=50,
                        test_batch=50)


def master_diff(a, b) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def check_run(result, label: str) -> None:
    for r in result.reports:
        if not np.isfinite(r.objs).all():
            raise AssertionError(f"{label}: non-finite objectives {r.objs}")
    master = result.extras["final_master"]
    bad = [k for k, v in master.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{label}: non-finite master leaves {bad[:5]}")


def same_trajectory(a, b, label: str, tol: float) -> float:
    if dataclasses.asdict(a.stats) != dataclasses.asdict(b.stats):
        raise AssertionError(f"{label}: CommStats differ: {a.stats} vs "
                             f"{b.stats}")
    for ra, rb in zip(a.reports, b.reports):
        if not all(np.array_equal(x, y)
                   for x, y in zip(ra.parent_keys, rb.parent_keys)):
            raise AssertionError(f"{label}: generation {ra.gen} parent keys "
                                 f"differ: {ra.parent_keys} vs "
                                 f"{rb.parent_keys}")
    diff = master_diff(a.extras["final_master"], b.extras["final_master"])
    log(f"{label}: equal keys and CommStats; final master max abs diff "
        f"{diff!r}")
    if not diff <= tol:
        raise AssertionError(f"{label}: master diff {diff} > {tol}")
    return diff


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    # 2. build
    t0 = time.perf_counter()
    logs = build.build(["fill_aggregate"])
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line:
                log(f"  {name}: {line.strip()}")

    # 3. each kernel against its plain version (these launches don't count)
    max_err = check_fill_aggregate()

    # 4. timing
    timing = time_fill_aggregate(card)

    # 5. the main path, kernel route, at full width
    cfg = get_config("cifar-supernet")
    api = cnn_supernet_api(cfg)
    if api.master_params() != MAIN_P:
        raise AssertionError(f"master has {api.master_params()} params")
    clients = full_width_clients()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    kernel_run = FedEngine(api, clients, RunConfig(
        aggregate_backend="kernel", **RUN)).run()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"main path launches: {launches}")
    if launches["fill_aggregate"] != 3:
        raise AssertionError("expected 3 fill_aggregate launches (2 in "
                             f"generation 1, 1 in generation 2): {launches}")
    check_run(kernel_run, "main path")
    for r in kernel_run.reports:
        log(f"main path generation {r.gen}: round_s {r.round_s!r}, best_err "
            f"{r.best_err!r}, parents {[k.tolist() for k in r.parent_keys]}")
    log(f"main path peak device memory: "
        f"{torch.cuda.max_memory_allocated()} B")

    # 6. the plain route, and the card against the CPU at smoke size
    torch_run = FedEngine(api, clients, RunConfig(
        aggregate_backend="torch", **RUN)).run()
    check_run(torch_run, "torch route")
    for r in torch_run.reports:
        log(f"torch route generation {r.gen}: round_s {r.round_s!r}")
    same_trajectory(kernel_run, torch_run, "kernel vs torch route",
                    MASTER_TOL)
    smoke = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    x, y = make_classification(0, 480, image=8, signal=1.5, noise=0.5)
    small = make_clients(x, y, partition_iid(0, 480, 8), batch=20,
                         test_batch=20)
    gpu = FedEngine(smoke, small, RunConfig(aggregate_backend="kernel",
                                            **RUN)).run()
    cpu = FedEngine(smoke, small, RunConfig(
        aggregate_backend="torch", **dict(RUN, device="cpu"))).run()
    same_trajectory(gpu, cpu, "smoke size, card vs CPU", MASTER_TOL)

    kernels = [{
        "name": "fill_aggregate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fill_aggregate.cu",
        "replaces": "src/repro/kernels/fill_aggregate.py:29",
        "launches": launches["fill_aggregate"], "max_abs_err": max_err,
        **timing,
    }]
    if any(not math.isfinite(k[f]) for k in kernels
           for f in ("ms", "plain_ms", "library_ms", "bound_ms")):
        raise AssertionError(f"non-finite timing: {kernels}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
