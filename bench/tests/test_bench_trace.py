"""The copy of the span join on a small synthetic capture."""
from __future__ import annotations

import pytest

import bench_tiny  # noqa: F401  (puts the repository on the path)
from bench.harness import trace


def _span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": 1, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, name):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def capture():
    """Two generations: sample [0, 10], fill_train [10, 100] holding
    download [12, 20], eval [100, 150], aggregate [150, 160]; then the
    same shifted by 1000.  Kernels (us): one launched in download, two in
    fill_train, one in eval (ending after the span), none in aggregate."""
    ev = []
    for base in (0, 1000):
        ev += [_span("sample", base, 10), _span("fill_train", base + 10, 90),
               _span("download", base + 12, 8), _span("eval", base + 100, 50),
               _span("aggregate", base + 150, 10)]
        c = base
        ev += [_launch(c + 1, base + 13), _kernel(c + 1, base + 15, 5, "copy"),
               _launch(c + 2, base + 30), _kernel(c + 2, base + 31, 20,
                                                   "fill_aggregate_kernel"),
               _launch(c + 3, base + 40),
               _kernel(c + 3, base + 55, 10, "gemm"),
               _launch(c + 4, base + 120), _kernel(c + 4, base + 140, 30,
                                                   "gemm")]
    return ev


def test_span_paths():
    paths = [p for p, _, _ in trace.span_intervals(capture())]
    assert paths[:5] == ["sample", "fill_train", "fill_train/download",
                         "eval", "aggregate"]


@pytest.mark.parametrize("index", [0, 1])
def test_split(index):
    got = trace.split(capture(), [4, 4], index)
    assert got["device_ms"]["fill_train"] == pytest.approx(0.035)
    assert got["device_ms"]["fill_train/download"] == pytest.approx(0.005)
    assert got["device_ms"]["eval"] == pytest.approx(0.030)
    assert got["device_ms"].get("aggregate", 0.0) == 0.0
    assert got["kernels_ms"] == pytest.approx(
        {"copy": 0.005, "fill_aggregate_kernel": 0.020, "gemm": 0.040})
    # busy: [15, 20], [31, 51], [55, 65], [140, 170]; window [0, 170]
    assert got["busy_ms"] == pytest.approx(0.065)
    assert got["window_ms"] == pytest.approx(0.170)
    # gaps [0, 15], [20, 31], [51, 55], [65, 140], each given to the
    # innermost span open at its middle
    assert got["idle_ms"] == pytest.approx(
        {"sample": 0.015, "fill_train": 0.015, "eval": 0.075})


def test_split_counts_spans():
    with pytest.raises(ValueError):
        trace.split(capture(), [4, 5], 1)
