"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
from __future__ import annotations

import json
import re

import pytest

from bench_tiny import ROOT
from bench import run as bench_run

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|experts_per_tok|num_experts_per)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_charset():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert any(w.startswith(m["paths"][0] + "/") for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)


def test_workloads_and_metrics():
    m = MANIFEST
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in m["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(cells) // 4)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
    layers = {}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert x["moves"] in e2e and _line(x["layer"])
        assert set(x.get("workloads", cells)) <= cells
        layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        assert any(x["name"] != "setup_s" and w in x.get("workloads", cells)
                   for x in m["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      MANIFEST["workloads"]])
def test_found_by_name(workload):
    manifest, cell, config, traffic, limits = bench_run.load_cell(
        bench_run.ROOT, workload)
    assert traffic["name"] == cell["traffic"]
    assert set(limits) >= {"update_gap", "count_gap", "search_diff"}
    assert (ROOT / "bench/reference" / f"{config['reference']}.py").is_file()
    readers = bench_run.metric_readers(manifest, workload)
    wanted = [x["name"] for x in manifest["per_layer"]
              if workload in x.get("workloads", [workload])]
    assert sorted(readers) == sorted(wanted)
    assert all(callable(read) for read, _ in readers.values())
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(**config["program"])
    assert cfg.dtype == config["model"]["dtype"]
