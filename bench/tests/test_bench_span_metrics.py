"""The readers of the program's spans inside ``fill_train`` on a
synthetic trace record: host ms summed over the paths that end in the
span, averaged over the window's generations, the profiled generations
left out, and nothing where no window generation has the span."""
from __future__ import annotations

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the repository on the path)
from bench import run as bench_run

READERS = bench_run.metric_readers(
    bench_run.load_cell(bench_run.ROOT, "cifar-rtnas-iid")[0],
    "cifar-rtnas-iid")
SPANS = ("local_sgd", "sgd_update", "fill_aggregate")


def _gen(host_ms, profiled=False):
    return {"profiled": profiled, "host_ms": host_ms}


def record():
    """Two window generations and one profiled one.  ``local_sgd`` also
    appears under ``fill_train/codec_decode`` in the second, as a path
    under another parent would."""
    return {"gens": [
        _gen({"sample": 1.0, "fill_train": 100.0,
              "fill_train/local_sgd": 80.0,
              "fill_train/local_sgd/sgd_update": 10.0,
              "fill_train/fill_aggregate": 6.0, "eval": 50.0}),
        _gen({"sample": 1.0, "fill_train": 120.0,
              "fill_train/local_sgd": 90.0,
              "fill_train/codec_decode/local_sgd": 4.0,
              "fill_train/local_sgd/sgd_update": 14.0,
              "fill_train/fill_aggregate": 2.0, "eval": 50.0}),
        _gen({"fill_train": 900.0, "fill_train/local_sgd": 800.0,
              "fill_train/local_sgd/sgd_update": 700.0,
              "fill_train/fill_aggregate": 90.0}, profiled=True)]}


# each window generation's ms of the span, over all its paths
WANT = {"local_sgd": (80.0, 90.0 + 4.0), "sgd_update": (10.0, 14.0),
        "fill_aggregate": (6.0, 2.0)}


def _without(gen, span):
    gen["host_ms"] = {p: ms for p, ms in gen["host_ms"].items()
                      if span not in p.split("/")}


@pytest.mark.parametrize("span", SPANS)
def test_sum_over_paths_and_window_mean(span):
    read, unit = READERS[f"{span}.host_ms"]
    assert unit == "ms"
    assert read(record()) == pytest.approx(sum(WANT[span]) / 2)


@pytest.mark.parametrize("span", SPANS)
def test_absent_span_reads_nothing(span):
    """A window generation without the span counts as 0 ms; a window
    with none of it (a program that does not enter it) reads None, also
    where a profiled generation holds it."""
    read, _ = READERS[f"{span}.host_ms"]
    rec = record()
    _without(rec["gens"][0], span)
    assert read(rec) == pytest.approx(WANT[span][1] / 2)
    _without(rec["gens"][1], span)
    assert read(rec) is None


@pytest.mark.parametrize("span", SPANS)
def test_profiled_generations_ignored(span):
    read, _ = READERS[f"{span}.host_ms"]
    rec = record()
    for path in rec["gens"][2]["host_ms"]:
        rec["gens"][2]["host_ms"][path] *= 10
    assert read(rec) == pytest.approx(sum(WANT[span]) / 2)
    rec["gens"] = rec["gens"][2:]
    assert read(rec) is None
