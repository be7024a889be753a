"""repro_torch host-side logic against the JAX package: exact equality.

Everything here is numpy in both packages (choice keys, double sampling,
NSGA-II, MACs, data, partitions, availability draws) or config
validation, so the same seeds must give the same numbers, bit for bit.
Also: the port imports neither jax nor anything of ``repro``.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import choice as ref_choice  # noqa: E402
from repro.core import double_sampling as ref_ds  # noqa: E402
from repro.core import flops as ref_flops  # noqa: E402
from repro.core import nsga2 as ref_nsga2  # noqa: E402
from repro.data import partition as ref_part  # noqa: E402
from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro.engine import availability as ref_avail  # noqa: E402
from repro.engine import types as ref_types  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import choice, double_sampling, flops, nsga2  # noqa: E402
from repro_torch.data import partition, pipeline, synthetic  # noqa: E402
from repro_torch.engine import availability, types  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


# ---------------------------------------------------------------------------
# search logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_choice_matches_reference(seed):
    r1, r2 = rngs(seed)
    keys_r = [ref_choice.random_key(r1, 12) for _ in range(6)]
    keys_p = [choice.random_key(r2, 12) for _ in range(6)]
    assert_same(keys_r, keys_p)
    for k in keys_p:
        assert_same(ref_choice.key_to_bits(k), choice.key_to_bits(k))
        assert_same(choice.bits_to_key(choice.key_to_bits(k)), k)
    assert_same(ref_choice.make_offspring(r1, keys_r, 10),
                choice.make_offspring(r2, keys_p, 10))


@pytest.mark.parametrize("m,n,strict", [(8, 4, True), (10, 4, False),
                                        (3, 4, False), (16, 10, True)])
def test_double_sampling_matches_reference(m, n, strict):
    r1, r2 = rngs(m * 100 + n)
    pr = ref_ds.sample_participants(r1, m, 1.0)
    pp = double_sampling.sample_participants(r2, m, 1.0)
    assert_same(pr, pp)
    assert_same(ref_ds.sample_client_groups(r1, pr, n, strict=strict),
                double_sampling.sample_client_groups(r2, pp, n, strict=strict))
    assert_same(ref_ds.sample_participants(r1, m, 0.5),
                double_sampling.sample_participants(r2, m, 0.5))
    assert_same(ref_ds.sample_population_keys(r1, n, 12),
                double_sampling.sample_population_keys(r2, n, 12))


def test_double_sampling_strict_short_fleet_raises_in_both():
    for mod in (ref_ds, double_sampling):
        with pytest.raises(ValueError):
            mod.sample_client_groups(np.random.default_rng(0),
                                     np.arange(3), 4, strict=True)


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 20), (2, 5), (3, 16)])
def test_nsga2_matches_reference(seed, n):
    rng = np.random.default_rng(seed)
    # rounded objectives force ties and duplicate points
    objs = np.round(rng.random((n, 2)), 1)
    assert ref_nsga2.fast_non_dominated_sort(objs) == \
        nsga2.fast_non_dominated_sort(objs)
    for k in (n // 2, n - 1):
        assert ref_nsga2.select(objs, k) == nsga2.select(objs, k)
    front = nsga2.fast_non_dominated_sort(objs)[0]
    assert ref_nsga2.knee_point(objs, front) == nsga2.knee_point(objs, front)
    assert_same(ref_nsga2.crowding_distance(objs, front),
                nsga2.crowding_distance(objs, front))


@pytest.mark.parametrize("num_blocks,image", [(12, 32), (4, 8), (4, 32)])
def test_cnn_subnet_macs_matches_reference(num_blocks, image):
    rng = np.random.default_rng(num_blocks + image)
    keys = [np.full(num_blocks, b, np.int32) for b in range(4)]
    keys += [rng.integers(0, 4, num_blocks).astype(np.int32)
             for _ in range(20)]
    for k in keys:
        assert (ref_flops.cnn_subnet_macs(k, num_blocks, image)
                == flops.cnn_subnet_macs(k, num_blocks, image))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0, n=480, image=8, signal=1.5,
                                     noise=0.5),
                                dict(seed=3, n=64, image=32)])
def test_make_classification_matches_reference(kw):
    assert_same(ref_syn.make_classification(**kw),
                synthetic.make_classification(**kw))


def test_virtual_classification_matches_reference():
    idx = np.array([5, 0, 99, 42])
    assert_same(ref_syn.VirtualClassification(1, 100, image=8).take(idx),
                synthetic.VirtualClassification(1, 100, image=8).take(idx))


@pytest.mark.parametrize("name", ["iid", "label", "dirichlet"])
def test_partitioners_match_reference(name):
    labels = np.random.default_rng(5).integers(0, 10, 600).astype(np.int32)
    args = {"iid": ((7, 600, 9), {}),
            "label": ((7, labels, 9), {"classes_per_client": 5}),
            "dirichlet": ((7, labels, 9), {"alpha": 0.5})}[name]
    r = getattr(ref_part, f"partition_{name}")(*args[0], **args[1])
    p = getattr(partition, f"partition_{name}")(*args[0], **args[1])
    assert_same(r.materialize(), p.materialize())
    assert_same(r.shard_sizes(), p.shard_sizes())


def test_client_datasets_match_reference():
    x, y = synthetic.make_classification(0, 480, image=8)
    shards = partition.partition_iid(0, 480, 8)
    cr = ref_pipe.make_clients(x, y, shards, batch=20, test_batch=20)
    cp = pipeline.make_clients(x, y, shards, batch=20, test_batch=20)
    for a, b in zip(cr, cp):
        assert_same(a.train, b.train)
        assert_same(a.test, b.test)
        assert a.weight == b.weight and a.cid == b.cid
    fleet = pipeline.make_fleet(x, y, shards, batch=20, test_batch=20,
                                cache_size=2)
    for i in (3, 0, 3, 7):
        assert_same(fleet[i].train, cr[i].train)
    assert (fleet.materialized, fleet.hits, fleet.cached) == (3, 1, 2)


# ---------------------------------------------------------------------------
# engine types and availability
# ---------------------------------------------------------------------------

SIM_CONFIGS = [
    {},
    {"availability": 0.6, "seed": 3},
    {"dropout": 0.3, "seed": 1},
    {"straggler_fraction": 0.25, "straggler_slowdown": 3.0,
     "round_deadline": 1.5, "seed": 2},
    {"availability_dist": ("beta", 2.0, 1.0), "dropout": 0.1},
    {"availability_trace": tuple(np.linspace(0.2, 1.0, 12))},
]


@pytest.mark.parametrize("kw", SIM_CONFIGS)
def test_client_simulator_draws_match_reference(kw):
    sr = ref_avail.ClientSimulator(ref_types.ClientSimConfig(**kw), 12)
    sp = availability.ClientSimulator(types.ClientSimConfig(**kw), 12)
    rng = np.random.default_rng(0)
    for _ in range(5):
        sampled = rng.permutation(12)[:9]
        a, b = sr.draw_round(sampled), sp.draw_round(sampled)
        assert_same(a.participants, b.participants)
        assert_same(a.dropped, b.dropped)
        assert a.survivors == b.survivors and a.n_sampled == b.n_sampled


@pytest.mark.parametrize("kw", [
    {"population": 1}, {"participation": 0.0}, {"participation": 1.5},
    {"lr0": -0.1}, {"local_epochs": -1},
    {"client_sim": {"dropout": 2.0}}, {"client_sim": {"availability": 0.0}},
])
def test_run_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        ref_types.RunConfig(**kw)
    with pytest.raises(ValueError):
        types.RunConfig(**kw)


def test_run_config_routes_and_unported_options():
    assert types.RunConfig().aggregate_backend == "kernel"
    assert types.RunConfig().device == "cuda"
    types.RunConfig(aggregate_backend="torch", device="cpu")
    for kw in ({"aggregate_backend": "xla"}, {"aggregate_backend": "pallas"},
               {"device": "tpu"}, {"device": "not-a-device"}):
        with pytest.raises(ValueError):
            types.RunConfig(**kw)
    # codecs are ported (tests/test_torch_comm.py); the JAX package's
    # int8 route names are not the port's
    cfg = types.RunConfig(uplink_codec="int8", downlink_codec="cast")
    assert (cfg.uplink_codec, cfg.downlink_codec) == ("int8", "cast")
    with pytest.raises(ValueError, match="available: \\['torch', 'kernel'\\]"):
        types.RunConfig(uplink_codec="int8:pallas")
    # telemetry is ported (tests/test_torch_obs.py): RunConfig parses it
    # as the JAX package does
    assert isinstance(types.RunConfig(telemetry=True).telemetry,
                      types.TelemetryConfig)
    assert types.RunConfig(telemetry=False).telemetry is None
    tcfg = types.RunConfig(telemetry={"sink": "table"}).telemetry
    assert isinstance(tcfg, types.TelemetryConfig) and tcfg.sink == "table"
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        ref_types.RunConfig(telemetry={"sink": "table"}).telemetry)
    with pytest.raises(ValueError, match="unknown telemetry sink"):
        types.RunConfig(telemetry={"sink": "carrier_pigeon"})
    assert isinstance(types.RunConfig(client_sim={"dropout": 0.2}).client_sim,
                      types.ClientSimConfig)


def test_model_config_matches_reference():
    for smoke in (False, True):
        r = ref_get_config("cifar-supernet", smoke=smoke)
        p = get_config("cifar-supernet", smoke=smoke)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert p.torch_dtype == torch.float32
        for arch in ("zamba2-2.7b", "internvl2-1b", "whisper-large-v3"):
            assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                    == dataclasses.asdict(ref_get_config(arch, smoke=smoke)))
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt-2")


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s+import))", re.M)
    sources = list((SRC / "repro_torch").rglob("*.py"))
    sources.append(SRC.parent / "chip_smoke.py")
    assert len(sources) > 20
    offenders = [str(f) for f in sources if pattern.search(f.read_text())]
    assert not offenders, offenders
