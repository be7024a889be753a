"""The benchmark's command on the card: each cell once, a short window,
one JSON object as the last line with ``correct`` true; and each
control (the program's own TF32 path in its float32's place) at the
cell's own size, which has to come out not correct.  Marked ``cuda``:
it skips where no card is present.

    python -m pytest -m cuda bench/tests/test_bench_chip.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT
from bench import run as bench_run
from bench.harness import faults

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cards():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card only")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      MANIFEST["workloads"]])
def test_cell_runs_correct(cards, workload):
    cell = {w["name"]: w for w in MANIFEST["workloads"]}[workload]
    if cards < cell["chips"]:
        pytest.skip(f"{workload} needs {cell['chips']} cards")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         "2147483999", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"search_gflop_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("control", sorted(faults.CONTROLS))
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      MANIFEST["workloads"]])
def test_control_is_not_correct(cards, workload, control):
    _, cell, config, traffic, limits = bench_run.load_cell(ROOT, workload)
    if cards < cell["chips"]:
        pytest.skip(f"{workload} needs {cell['chips']} cards")
    res = bench_run.run_cell(cell, config, traffic, limits, {}, 2147483998,
                             0.0, False, hooks=faults.CONTROLS[control])
    assert not res["correct"], res["checks"]
