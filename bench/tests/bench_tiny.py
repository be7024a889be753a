"""A small version of the benchmark's cell for CPU tests: the same
harness, program and reference, at widths a CPU run holds (4 choice
blocks of 16 and 32 channels, 12 clients of 60 images, population 6),
in float32.

The limits are this size's own, set from CPU readings (``TINY_LIMITS``
below gives them); the counts and the search's decisions are compared
exactly.  The card's controls (TF32) change nothing on the CPU, so their
test runs on the card (``test_bench_chip.py``)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import run as bench_run  # noqa: E402


TINY_LIMITS = {"update_gap": 1e-4, "update_worst": 1e-2,
               "update_diff": 1e-3, "count_gap": 0, "search_diff": 0}


def cell():
    """(cell, config, traffic, limits) of the CIFAR cell cut to CPU size,
    with this size's limits."""
    bench = ROOT / "bench"
    config = json.loads((bench / "configs/cifar-supernet.json").read_text())
    traffic = json.loads((bench / "traffic/iid-20x600.json").read_text())
    config["model"].update(channels=[16, 16, 32, 32], stem_channels=16)
    config["program"]["num_layers"] = 4
    traffic.update(samples=12 * 60, clients=12, batch=10, test_batch=10)
    traffic["run"]["population"] = 6
    return ({"name": "cnn-tiny", "chips": 1}, config, traffic,
            dict(TINY_LIMITS))


def run(seed: int, hooks=None, trace: bool = False, readers=None):
    c, config, traffic, limits = cell()
    return bench_run.run_cell(c, config, traffic, limits, readers or {},
                              seed, 0.0, trace, device="cpu", hooks=hooks)
