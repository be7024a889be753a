"""What the harness and the reference load, by top-level module name
(the part before the first dot, compared whole): the harness and the
program it runs load neither JAX nor the JAX package ``repro``, and the
reference loads nothing of the program ``repro_torch`` either."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from bench_tiny import ROOT

RUN = """
import sys
sys.path[:0] = [{root!r} + "/bench/tests", {root!r}, {root!r} + "/src"]
import bench_tiny
from bench import calibrate, run as bench_run
from bench.harness import check, counts, faults, generate, trace, window
manifest = bench_run.load_cell(bench_run.ROOT, "cifar-rtnas-iid")[0]
readers = bench_run.metric_readers(manifest, "cifar-rtnas-iid")
res = bench_tiny.run(3, trace=True, readers=readers)
import json
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REF = """
import sys
sys.path[:0] = [{root!r}]
from bench.reference import cnn_supernet, search
import json
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         env=env, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN)
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_no_program():
    names = _top_level(REF)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
