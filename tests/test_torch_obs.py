"""repro_torch.obs: telemetry is bit for bit invisible when off, faithful
when on, and records what the JAX package's ``repro.obs`` records.

Mirrors ``tests/test_obs.py`` on the smoke CIFAR supernet (4 blocks,
image 8), 6 clients of 40 samples, population 4, 3 generations, on the
CPU:

  * per backend variant — ``loop``, fused ``vmap`` on both Algorithm 3
    routes, non-fused ``vmap``, and ``mesh`` (one CPU device) fused and
    not — telemetry on gives final masters and objectives bit for bit
    equal to telemetry off, equal ``CommStats`` and ``dispatches``, and
    one ``RoundEvent`` per generation; each fused program counts one
    signature, on ``mesh`` too (the JAX package's mesh traces
    ``fused_fill`` twice, ROADMAP queue 3);
  * the event contents on a fused ``vmap`` run with int8 both ways,
    dropout 0.25 and availability seed 1 (spans, comm deltas, gauges,
    times), the fleet gauges, the signature counters (``traced``), the
    sinks, the gauge helpers and ``NULL_TELEMETRY``;
  * a ``profiler_dir`` capture: a Chrome trace whose phase spans
    ``capture.round_split`` finds per generation, the masters still bit
    for bit;
  * parity with the JAX package, in two JAX runs in one module fixture
    (that ``vmap`` int8 dropout run, and ``loop``): each generation's span
    paths and ``span_counts``, ``recompiles``, ``comm`` deltas, LRU
    counters and the final ``trace_counts`` equal.  The port starts
    from the JAX package's init so both runs select the same keys (the
    comm deltas depend on the keys' payloads); the third variant,
    non-fused ``vmap``, is held to the JAX package's counts on the same
    run, written out here.  The spans only the port enters
    (``PORT_ONLY``: ``local_sgd``, ``sgd_update``, ``fill_aggregate``)
    are left out of those comparisons and counted exactly per variant.
"""
import dataclasses
import io
import json
import types

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import cnn_supernet_api  # noqa: E402
from repro_torch.data import make_classification, make_clients, \
    make_fleet, partition_iid  # noqa: E402
from repro_torch.engine import ClientSimConfig, FedEngine, RunConfig  # noqa: E402,E501
from repro_torch.obs import (COMM_FIELDS, NULL_TELEMETRY,  # noqa: E402
                             PORT_ONLY, InstrumentedBackend, RoundEvent,
                             TableSink, Telemetry, TelemetryConfig,
                             event_dict, host_rss_bytes, innermost,
                             live_device_bytes, load_trace, parse_sink_spec,
                             round_split, signature, traced)
from repro_torch.obs.capture import span_intervals  # noqa: E402

# (backend, fused, Algorithm 3 route)
VARIANTS = (("loop", True, "torch"), ("vmap", True, "torch"),
            ("vmap", False, "torch"), ("vmap", True, "kernel"),
            ("mesh", True, "torch"), ("mesh", False, "torch"))
GENS = 3
RUN = dict(population=4, generations=GENS, seed=0, lr0=0.01)
FULL = dict(backend="vmap", fused=True, uplink_codec="int8",
            downlink_codec="int8")
LRU = ("train_store_hits", "train_store_misses", "test_stack_hits",
       "test_stack_misses")


def tiny_clients(num_clients=6, n=240, seed=0, mods=None):
    make_cls, make_cl, part = mods or (make_classification, make_clients,
                                       partition_iid)
    x, y = make_cls(seed, n, image=8, signal=1.5, noise=0.5)
    return make_cl(x, y, part(seed, n, num_clients), batch=10, test_batch=10)


@pytest.fixture(scope="module")
def ref():
    """The JAX package, imported here so that a machine without it (the
    card's) still runs the card-only cases."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.core import make_api
    from repro.data import make_classification, make_clients, partition_iid
    from repro.engine import ClientSimConfig, FedEngine, RunConfig
    return types.SimpleNamespace(
        jax=jax, get_config=get_config, make_api=make_api,
        clients=(make_classification, make_clients, partition_iid),
        ClientSimConfig=ClientSimConfig, FedEngine=FedEngine,
        RunConfig=RunConfig)


@pytest.fixture(scope="module")
def own_api():
    return cnn_supernet_api(get_config("cifar-supernet", smoke=True))


@pytest.fixture(scope="module")
def apis(ref, own_api):
    """The JAX package's API and the port's with its init injected."""
    ref_api = ref.make_api(ref.get_config("cifar-supernet", smoke=True))
    init = ref.jax.tree.map(np.asarray,
                            ref_api.init(ref.jax.random.PRNGKey(0)))
    api = dataclasses.replace(own_api,
                              init=lambda g: params_from_reference(init))
    return ref_api, api


@pytest.fixture(scope="module")
def api(apis):
    return apis[1]


def max_leaf_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def reference_paths(by_path):
    """``by_path`` without the paths that hold a span only the port
    enters: what the JAX package's round events record."""
    return {p: v for p, v in by_path.items()
            if PORT_ONLY.isdisjoint(p.split("/"))}


def run_engine(api, clients, backend, fused, telemetry, route="torch",
               **kw):
    eng = FedEngine(api, clients,
                    RunConfig(backend=backend, fused=fused,
                              aggregate_backend=route, telemetry=telemetry,
                              device="cpu", **RUN, **kw))
    return eng, eng.run()


@pytest.fixture(scope="module")
def onoff(api):
    clients = tiny_clients()
    return {v: {t: run_engine(api, clients, v[0], v[1],
                              True if t == "on" else None, route=v[2])
                for t in ("off", "on")}
            for v in VARIANTS}


# ---------------------------------------------------------------------------
# bit-exact invisibility: on == off, per backend variant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_telemetry_on_off_bitwise(onoff, variant):
    (eng_off, off), (eng_on, on) = (onoff[variant]["off"],
                                    onoff[variant]["on"])
    assert max_leaf_diff(off.extras["final_master"],
                         on.extras["final_master"]) == 0.0
    for a, b in zip(off.reports, on.reports):
        assert np.array_equal(np.asarray(a.objs), np.asarray(b.objs))
        assert a.best_err == b.best_err
    assert dataclasses.asdict(off.stats) == dataclasses.asdict(on.stats)
    assert eng_off.backend.dispatches == eng_on.backend.dispatches


@pytest.mark.parametrize("variant", VARIANTS)
def test_telemetry_result_presence(onoff, variant):
    off = onoff[variant]["off"][1]
    on = onoff[variant]["on"][1]
    assert off.telemetry is None
    assert on.telemetry is not None
    assert [e.gen for e in on.telemetry.events] == list(range(1, GENS + 1))


def test_disabled_engine_is_pre_subsystem_graph(api):
    clients = tiny_clients(4, 120)
    rc = dict(population=4, generations=1, seed=0, backend="vmap",
              device="cpu")
    eng_off = FedEngine(api, clients, RunConfig(**rc))
    # no wrapper at all, and every telemetry hook is the shared no-op
    assert innermost(eng_off.backend) is eng_off.backend
    assert eng_off.telemetry is NULL_TELEMETRY
    assert eng_off.backend.telemetry is NULL_TELEMETRY
    eng_on = FedEngine(api, clients, RunConfig(telemetry=True, **rc))
    assert isinstance(eng_on.backend, InstrumentedBackend)
    assert innermost(eng_on.backend).telemetry is eng_on.telemetry
    assert eng_on.telemetry.device == torch.device("cpu")
    # under a codec the spans wrap outermost, the codec layer in between
    eng_codec = FedEngine(api, clients, RunConfig(
        telemetry=True, uplink_codec="int8", **rc))
    assert type(eng_codec.backend.inner).__name__ == "CodecBackend"
    assert eng_codec.backend.inner.telemetry is eng_codec.telemetry


# ---------------------------------------------------------------------------
# round-event completeness (vmap fused + availability sim + int8 codec)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_run(api):
    return run_engine(api, tiny_clients(), "vmap", True, True,
                      uplink_codec="int8", downlink_codec="int8",
                      client_sim=ClientSimConfig(dropout=0.25, seed=1))


def test_round_event_spans_complete(full_run):
    _, res = full_run
    ev = res.telemetry.events[0]
    paths = set(ev.spans)
    for phase in ("sample", "availability", "fill_train", "eval",
                  "aggregate"):
        assert phase in paths, f"missing top-level span {phase!r}"
    # codec + staging spans nest under the backend call that caused them
    assert "fill_train/codec_decode" in paths
    assert "fill_train/codec_encode" in paths
    assert "eval/codec_decode" in paths
    assert any(p.endswith("/download") for p in paths)
    assert "eval/host_fetch" in paths
    assert all(s >= 0.0 for s in ev.spans.values())
    assert ev.span_counts["eval"] >= 1
    assert set(ev.span_counts) == paths


def test_round_event_comm_deltas_sum_to_stats(full_run):
    _, res = full_run
    events = res.telemetry.events
    stats = dataclasses.asdict(res.stats)
    for f in COMM_FIELDS:
        per_round = [e.comm[f] for e in events]
        assert sum(per_round) == pytest.approx(stats[f])
    assert events[0].comm["down_bytes"] > 0
    assert events[0].comm["up_bytes"] > 0


def test_round_event_gauges(full_run):
    _, res = full_run
    g = res.telemetry.events[-1].gauges
    assert g["live_device_bytes"] > 0
    assert g["peak_live_device_bytes"] >= g["live_device_bytes"]
    assert g["host_rss_bytes"] > 0
    # stacked-store LRU counters (vmap backend): the steady state reuses
    # the staged shards, so by the last round there have been hits
    assert g["train_store_misses"] >= 1
    assert g["test_stack_misses"] >= 1
    assert g["train_store_hits"] + g["test_stack_hits"] >= 1


def test_round_event_times_match_reports(full_run):
    _, res = full_run
    for e, r in zip(res.telemetry.events, res.reports):
        assert e.round_s == r.round_s
        assert e.round_s >= 0.0
        # top-level phases are disjoint intervals inside the round
        top = sum(s for p, s in e.spans.items() if "/" not in p)
        assert top <= e.round_s + 1e-3


def test_fleet_gauges(api):
    x, y = make_classification(0, 120, image=8, signal=1.5, noise=0.5)
    fleet = make_fleet(x, y, partition_iid(0, 120, 4), batch=10,
                       test_batch=10, cache_size=8)
    _, res = run_engine(api, fleet, "vmap", True, True)
    g = res.telemetry.events[-1].gauges
    assert g["clients_materialized"] == fleet.materialized >= 4
    assert g["clients_cached"] == fleet.cached
    assert g["fleet_hits"] == fleet.hits >= 1


# ---------------------------------------------------------------------------
# signature counters: new signatures counted, calls not; fused = once
# ---------------------------------------------------------------------------

def test_traced_counts_signatures_not_calls():
    counts = {}
    f = traced("prog", counts, lambda x: x * 2.0)
    np.testing.assert_allclose(f(torch.ones(3)).numpy(), 2.0 * np.ones(3))
    f(torch.full((3,), 5.0))            # same signature, other values
    assert counts["prog"] == 1
    f(torch.ones(4))                    # a new shape: a new signature
    assert counts["prog"] == 2
    f(torch.ones(4, dtype=torch.float64))   # a new dtype
    assert counts["prog"] == 3


@pytest.mark.parametrize("a,b,same", [
    (0.01, 0.5, True),                  # Python floats by type
    (1, 2, True),                       # ints by type
    (1, 1.0, False),
    (True, False, False),               # bools by value
    ("a", "b", False),                  # strs by value
    (None, None, True),
    (np.zeros(4, np.int32), np.ones(4, np.int32), True),
    (np.zeros(4, np.int32), np.zeros(4, np.int64), False),
    ({"w": torch.zeros(2), "b": torch.zeros(1)},
     {"b": torch.ones(1), "w": torch.ones(2)}, True),   # keys sorted
    ([torch.zeros(2)], (torch.zeros(2),), False),
    ([torch.zeros(2)], [torch.zeros(2), torch.zeros(2)], False),
])
def test_signature(a, b, same):
    assert (signature(a) == signature(b)) is same


@pytest.mark.parametrize("variant,expected", [
    (VARIANTS[1], {"fused_fill": 1, "fused_eval_shared": 1}),
    (VARIANTS[2], {"scan_update": 1, "eval_tiles": 1}),
    # the kernel route's local SGD program, the JAX package's pallas
    # route's name: Algorithm 3 then runs on K1, outside it
    (VARIANTS[3], {"fused_uploads": 1, "fused_eval_shared": 1}),
])
def test_vmap_programs_trace_once(onoff, variant, expected):
    res = onoff[variant]["on"][1]
    assert res.telemetry.trace_counts == expected
    events = res.telemetry.events
    assert events[0].recompiles == expected
    for e in events[1:]:                # steady state: no new signature
        assert e.recompiles == {}


@pytest.mark.parametrize("bk", ["vmap", "mesh"])
def test_fused_programs_trace_once(onoff, bk):
    """``tests/test_obs.py``'s case on the port's own runs: one signature
    per fused program, in generation 1 only."""
    res = onoff[(bk, True, "torch")]["on"][1]
    tc = res.telemetry.trace_counts
    assert tc.get("fused_fill") == 1
    assert tc.get("fused_eval_shared") == 1
    assert all(v == 1 for v in tc.values()), tc
    events = res.telemetry.events
    assert events[0].recompiles.get("fused_fill") == 1
    for e in events[1:]:                # steady state: no new signature
        assert e.recompiles == {}


def test_nonfused_mesh_programs_trace_once(onoff):
    """Non-fused ``mesh``: one call per shape bucket, named as the JAX
    package's mesh programs, one signature each."""
    res = onoff[VARIANTS[5]]["on"][1]
    expected = {"fill_partial": 1, "eval_shared_counts": 1}
    assert res.telemetry.trace_counts == expected
    assert res.telemetry.events[0].recompiles == expected


def test_nonfused_span_counts_match_reference(onoff):
    """The JAX package's non-fused ``vmap`` run of this configuration
    (``RefRunConfig(population=4, generations=3, seed=0, lr0=0.01,
    backend="vmap", fused=False, telemetry=True)``, same clients)
    enters these spans; recorded once, not re-run here."""
    first = {"sample": 3, "availability": 1, "fill_train": 2,
             "fill_train/download": 1, "eval": 1, "eval/download": 1,
             "aggregate": 1}
    steady = {"sample": 2, "availability": 1, "fill_train": 1,
              "fill_train/download": 1, "eval": 1, "aggregate": 1}
    events = onoff[VARIANTS[2]]["on"][1].telemetry.events
    assert [reference_paths(e.span_counts) for e in events] \
        == [first, steady, steady]


# entries of the spans inside fill_train per generation: every run trains
# 4 groups of one client (6 clients, population 4) of 3 batches, one
# epoch, in 2 train_fill calls in generation 1 (the parents, then the
# offspring) and in 1 after it
TRAIN_FILLS = (2, 1, 1)
GROUPS, BATCHES = 4, 3
# Algorithm 3 calls per train_fill: the loop's fill_aggregate, the
# stacked and kernel routes' fill_aggregate_stacked once, the fused torch
# route's masks and fill_partial once per group (fill_bucket_partial,
# which non-fused mesh runs per bucket too)
FILL_AGGREGATES = {VARIANTS[0]: 1, VARIANTS[1]: GROUPS, VARIANTS[2]: 1,
                   VARIANTS[3]: 1, VARIANTS[4]: GROUPS, VARIANTS[5]: GROUPS}


@pytest.mark.parametrize("variant", VARIANTS)
def test_client_step_span_counts(onoff, variant):
    """``local_sgd`` once per group trained (per client on ``loop``;
    here each group is one client), ``sgd_update`` once per client,
    batch and epoch, ``fill_aggregate`` once per Algorithm 3 call; each
    nested path's host time within its parent's."""
    events = onoff[variant]["on"][1].telemetry.events
    for e, calls in zip(events, TRAIN_FILLS):
        assert {p: c for p, c in e.span_counts.items()
                if not PORT_ONLY.isdisjoint(p.split("/"))} == {
            "fill_train/local_sgd": GROUPS * calls,
            "fill_train/local_sgd/sgd_update": GROUPS * BATCHES * calls,
            "fill_train/fill_aggregate": FILL_AGGREGATES[variant] * calls}
        for path, s in e.spans.items():
            if "/" in path:
                assert s <= e.spans[path.rsplit("/", 1)[0]], path


def test_injected_retrace_surfaces_in_round_events():
    class FakeBackend:
        def __init__(self):
            self.trace_counts = {}

    class FakeEngine:
        def __init__(self):
            self.backend = FakeBackend()
            self.stats = object()       # comm deltas read 0.0 defaults

    eng = FakeEngine()
    tel = Telemetry(TelemetryConfig(gauges=False, annotations=False), "cpu")
    f = traced("prog", eng.backend.trace_counts, lambda x: x + 1)
    tel.start_run(eng)
    f(torch.ones(3))
    assert tel.end_round(1, 0.0, eng).recompiles == {"prog": 1}
    f(torch.ones(3))                    # same signature: a clean round
    assert tel.end_round(2, 0.0, eng).recompiles == {}
    f(torch.ones(5))                    # injected shape-varying signature
    assert tel.end_round(3, 0.0, eng).recompiles == {"prog": 1}


# ---------------------------------------------------------------------------
# the profiler capture
# ---------------------------------------------------------------------------

def test_profiler_capture_splits_rounds(api, onoff, tmp_path):
    """A ``profiler_dir`` run writes one Chrome trace whose phase spans
    are the round events' own, and leaves the search bit for bit."""
    _, res = run_engine(api, tiny_clients(), "vmap", True,
                        {"profiler_dir": str(tmp_path), "gauges": False})
    off = onoff[VARIANTS[1]]["off"][1]
    assert max_leaf_diff(off.extras["final_master"],
                         res.extras["final_master"]) == 0.0
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
    events = res.telemetry.events
    assert all(e.gauges == {} for e in events)
    trace = load_trace(str(tmp_path))
    paths = [p for p, _, _ in span_intervals(trace)]
    assert sum(c for e in events for c in e.span_counts.values()) \
        == len(paths)
    for gen in range(1, GENS + 1):
        split = round_split(trace, events, gen)
        counts = {p: row["count"] for p, row in split["spans"].items()}
        assert counts == events[gen - 1].span_counts
        assert {"fill_train/local_sgd", "fill_train/local_sgd/sgd_update",
                "fill_train/fill_aggregate"} <= set(counts)
        assert split["spans"]["fill_train"]["host_ms"] \
            == events[gen - 1].spans["fill_train"] * 1e3
        # the CPU run launches nothing on a device: the whole window is
        # one idle stretch
        assert split["device_busy_ms"] == 0.0 and split["top"] == []
        assert split["idle_share"] == 1.0
        assert sum(split["idle_ms"].values()) \
            == pytest.approx(split["window_ms"])
        assert split["consistent"]


def test_round_split_matches_launches_to_spans():
    """Device activities count toward the span whose host interval holds
    their launch, matched by correlation id; busy time is the union of
    their intervals; each idle stretch goes to the innermost span open
    at its midpoint."""
    def ann(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "tid": 1,
                "ts": ts, "dur": dur}

    def launch(corr, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(corr, ts, dur, name="k"):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    trace = [ann("sample", 0, 6), ann("fill_train", 20, 100),
             ann("download", 30, 10), ann("local_sgd", 42, 28),
             ann("sgd_update", 59, 3), ann("fill_aggregate", 95, 23),
             ann("eval", 130, 50), ann("host_fetch", 170, 10),
             launch(1, 35), kernel(1, 36, 20, "copy"),
             launch(2, 60), kernel(2, 60, 30, "gemm"),
             launch(6, 105), kernel(6, 108, 42, "k1"),
             launch(3, 140), kernel(3, 165, 30, "gemm"),
             launch(4, 15), kernel(4, 15, 5, "stray"),
             # launched in the previous generation's window: not counted
             launch(5, -50), kernel(5, -40, 10)]
    ev = RoundEvent(gen=1, round_s=0.2,
                    spans={"sample": 6e-6, "fill_train": 1e-4,
                           "fill_train/download": 1e-5,
                           "fill_train/local_sgd": 2.8e-5,
                           "fill_train/local_sgd/sgd_update": 3e-6,
                           "fill_train/fill_aggregate": 2.3e-5,
                           "eval": 5e-5, "eval/host_fetch": 1e-5},
                    span_counts={"sample": 1, "fill_train": 1,
                                 "fill_train/download": 1,
                                 "fill_train/local_sgd": 1,
                                 "fill_train/local_sgd/sgd_update": 1,
                                 "fill_train/fill_aggregate": 1, "eval": 1,
                                 "eval/host_fetch": 1},
                    recompiles={}, gauges={}, comm={})
    split = round_split(trace, [ev], 1, top=2)
    dev = {p: row["device_ms"] for p, row in split["spans"].items()}
    assert dev == {"sample": 0.0, "fill_train": 0.092,
                   "fill_train/download": 0.02,
                   "fill_train/local_sgd": 0.03,
                   "fill_train/local_sgd/sgd_update": 0.03,
                   "fill_train/fill_aggregate": 0.042, "eval": 0.03,
                   "eval/host_fetch": 0.0}
    assert {p: row["activities"] for p, row in split["spans"].items()} \
        == {"sample": 0, "fill_train": 3, "fill_train/download": 1,
            "fill_train/local_sgd": 1, "fill_train/local_sgd/sgd_update": 1,
            "fill_train/fill_aggregate": 1, "eval": 1, "eval/host_fetch": 0}
    assert split["spans"]["fill_train"]["trace_ms"] == 0.1
    assert split["consistent"]
    # a capture whose spans the RoundEvent did not time: a generation
    # sliced wrongly shows here
    slow = dataclasses.replace(ev, spans=dict(ev.spans, eval=0.01))
    assert not round_split(trace, [slow], 1)["consistent"]
    assert split["device_ms_outside_spans"] == 0.005
    # busy: 15-20, 36-56, 60-90, 108-150, 165-195 = 127 µs of a window
    # 0-195 µs
    assert split["device_busy_ms"] == pytest.approx(0.127)
    assert split["window_ms"] == pytest.approx(0.195)
    assert split["idle_share"] == pytest.approx(1 - 127 / 195)
    # idle 0-15 (after sample), 20-36 (fill_train's own), 56-60 (inside
    # local_sgd, before sgd_update), 90-108 (fill_aggregate), 150-165
    # (eval, before host_fetch)
    assert split["idle_ms"] == {"between spans": 0.015, "fill_train": 0.016,
                                "fill_train/local_sgd": 0.004,
                                "fill_train/fill_aggregate": 0.018,
                                "eval": 0.015}
    assert split["top"] == [("gemm", 2, 0.06), ("k1", 1, 0.042)]
    assert split["spans"]["fill_train"]["host_ms"] == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# parity with the JAX package (two JAX runs)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs(ref, apis):
    ref_api = apis[0]
    out = {}
    for name, kw in (("full", dict(FULL, client_sim=ref.ClientSimConfig(
            dropout=0.25, seed=1))), ("loop", dict(backend="loop"))):
        eng = ref.FedEngine(ref_api, tiny_clients(mods=ref.clients),
                            ref.RunConfig(telemetry=True, **RUN, **kw))
        out[name] = eng.run()
    return out


@pytest.mark.parametrize("name", ["full", "loop"])
def test_round_events_match_reference(ref_runs, full_run, onoff, name):
    ref = ref_runs[name]
    ours = full_run[1] if name == "full" else onoff[VARIANTS[0]]["on"][1]
    assert ours.telemetry.trace_counts == ref.telemetry.trace_counts
    assert len(ours.telemetry.events) == len(ref.telemetry.events) == GENS
    for e, r in zip(ours.telemetry.events, ref.telemetry.events):
        assert e.gen == r.gen
        assert set(reference_paths(e.spans)) == set(r.spans)
        assert reference_paths(e.span_counts) == r.span_counts
        assert e.recompiles == r.recompiles
        assert e.comm == r.comm
        assert {k: e.gauges[k] for k in LRU if k in e.gauges} \
            == {k: r.gauges[k] for k in LRU if k in r.gauges}
        assert set(e.gauges) == set(r.gauges)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def test_jsonl_sink_one_line_per_round(api, tmp_path):
    path = tmp_path / "rounds.jsonl"
    _, res = run_engine(api, tiny_clients(4, 120), "vmap", True,
                        {"sink": f"jsonl:{path}"})
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["gen"] for e in events] == list(range(1, GENS + 1))
    for e in events:
        assert set(e) == {"gen", "round_s", "spans", "span_counts",
                          "recompiles", "gauges", "comm"}
    # the file mirrors the in-memory ring, event for event
    assert events[-1] == event_dict(res.telemetry.events[-1])


def test_memory_ring_capacity(api):
    _, res = run_engine(api, tiny_clients(4, 120), "vmap", True,
                        {"ring": 2})
    assert [e.gen for e in res.telemetry.events] == [GENS - 1, GENS]


def test_table_sink_rows():
    buf = io.StringIO()
    sink = TableSink(stream=buf)
    ev = RoundEvent(gen=1, round_s=0.5,
                    spans={"fill_train": 0.3, "fill_train/download": 0.1,
                           "eval": 0.05},
                    span_counts={"fill_train": 2},
                    recompiles={"fused_fill": 1},
                    gauges={"live_device_bytes": 2e6},
                    comm={"up_bytes": 1e6})
    sink.emit(ev)
    sink.emit(ev)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 4              # header + rule + two rows
    assert lines[0].split()[0] == "gen"
    assert "0.400" in lines[2]          # fill_train + nested download


def test_sink_spec_validation():
    assert parse_sink_spec("memory") == ("memory", "")
    assert parse_sink_spec("table") == ("table", "")
    assert parse_sink_spec("jsonl:/tmp/x.jsonl") == ("jsonl", "/tmp/x.jsonl")
    with pytest.raises(ValueError):
        TelemetryConfig(sink="carrier_pigeon")
    with pytest.raises(ValueError):
        TelemetryConfig(sink="jsonl:")
    with pytest.raises(ValueError):
        TelemetryConfig(ring=0)
    with pytest.raises(ValueError):     # RunConfig coercion validates too
        RunConfig(telemetry={"sink": "nope"})


# ---------------------------------------------------------------------------
# gauge helpers
# ---------------------------------------------------------------------------

def test_host_gauges_positive():
    assert live_device_bytes("cpu") > 0
    assert host_rss_bytes() > 0


def test_null_telemetry_noop():
    assert not NULL_TELEMETRY.enabled
    with NULL_TELEMETRY.span("anything"):
        pass
    NULL_TELEMETRY.start_run(None)
    NULL_TELEMETRY.end_round(1, 0.0, None)
    with NULL_TELEMETRY.run_capture():
        pass
    assert NULL_TELEMETRY.result(None) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_telemetry_invisible_and_gauges(cuda, own_api):
    """On the card: on == off bit for bit on fused ``vmap`` (kernel
    route), and ``live_device_bytes`` is the allocator's count."""
    clients = tiny_clients()
    res = {}
    for t in (None, True):
        eng = FedEngine(own_api, clients, RunConfig(
            backend="vmap", telemetry=t, device="cuda", **RUN))
        res[t] = eng.run()
    torch.cuda.synchronize()
    assert max_leaf_diff(res[None].extras["final_master"],
                         res[True].extras["final_master"]) == 0.0
    assert dataclasses.asdict(res[None].stats) \
        == dataclasses.asdict(res[True].stats)
    assert live_device_bytes(cuda) == torch.cuda.memory_allocated(cuda)
    assert res[True].telemetry.trace_counts == {"fused_uploads": 1,
                                                "fused_eval_shared": 1}
