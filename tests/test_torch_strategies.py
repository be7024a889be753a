"""repro_torch's baseline strategies and legacy shims against the JAX
package: ``OfflineNas`` (population 2, 1 generation) and
``FedAvgBaseline`` (key [1, 0, 2, 3], 2 rounds), both on the ``loop``
backend with the int8 uplink codec, 4 clients of 240 samples, lr0 0.01.

The reinitialisations draw from ``jax.random.PRNGKey(seed)`` in the JAX
package and from ``torch.Generator().manual_seed(seed)`` in the port, with
the same seeds (1001, 1002, ... for ``OfflineNas``; ``cfg.seed`` for
``FedAvgBaseline``); the test maps each generator's seed to the JAX
package's init of that seed, so both start from the same weights.  Keys,
objectives and ``CommStats`` must be equal (objectives within 1e-5); the
FedAvg model within ``1e-4 + max|update of the leaf| / 127`` — the
packages' float gap plus one step of the uplink's int8 grid, which that
gap can cross (measured on the CPU: 2.3e-5).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import make_api  # noqa: E402
from repro.core import offline_enas as ref_offline_enas  # noqa: E402
from repro.data import make_classification as ref_make_classification  # noqa: E402,E501
from repro.data import make_clients as ref_make_clients  # noqa: E402
from repro.data import partition_iid as ref_partition_iid  # noqa: E402
from repro.engine import FedAvgBaseline as RefFedAvgBaseline  # noqa: E402
from repro.engine import FedEngine as RefEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine.types import HISTORY_FIELDS as REF_HISTORY_FIELDS  # noqa: E402,E501

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference, \
    params_to_reference  # noqa: E402
from repro_torch.core import cnn_supernet_api, offline_enas, \
    rt_enas  # noqa: E402
from repro_torch.core.federated import client_update_fn, \
    fedavg_round  # noqa: E402
from repro_torch.data import make_classification, make_clients, \
    partition_iid  # noqa: E402
from repro_torch.engine import FedAvgBaseline, FedEngine, OfflineNas, \
    RealTimeNas, RunConfig  # noqa: E402
from repro_torch.engine.types import HISTORY_FIELDS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FEDAVG_KEY = np.asarray([1, 0, 2, 3], np.int32)
OFFLINE = dict(population=2, generations=1, seed=0, lr0=0.01,
               uplink_codec="int8")
FEDAVG = dict(population=4, generations=2, seed=0, lr0=0.01,
              uplink_codec="int8")
MASTER_ATOL = 1e-4


def tiny_clients(mod_classification, mod_clients, mod_partition,
                 num_clients=4, n=240, seed=0):
    x, y = mod_classification(seed, n, image=8, signal=1.5, noise=0.5)
    return mod_clients(x, y, mod_partition(seed, n, num_clients),
                       batch=20, test_batch=20)


@pytest.fixture(scope="module")
def setup():
    """Both packages' APIs and clients; the port's ``init`` draws the JAX
    package's init of the generator's seed and records the seeds."""
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=True))
    inits, seeds = {}, []

    def init(g):
        seed = g.initial_seed()
        seeds.append(seed)
        if seed not in inits:
            inits[seed] = jax.tree.map(
                np.asarray, ref_api.init(jax.random.PRNGKey(seed)))
        return params_from_reference(inits[seed])

    api = dataclasses.replace(
        cnn_supernet_api(get_config("cifar-supernet", smoke=True)),
        init=init)
    ref_clients = tiny_clients(ref_make_classification, ref_make_clients,
                               ref_partition_iid)
    clients = tiny_clients(make_classification, make_clients, partition_iid)
    return ref_api, api, ref_clients, clients, seeds


@pytest.fixture(scope="module")
def offline_runs(setup):
    ref_api, api, ref_clients, clients, seeds = setup
    ref_hist = ref_offline_enas.run(ref_api, ref_clients, RefRunConfig(
        backend="loop", **OFFLINE))
    del seeds[:]
    eng = FedEngine(api, clients, RunConfig(device="cpu", **OFFLINE),
                    strategy=OfflineNas())
    first = eng.run()
    first_seeds = list(seeds)
    again = eng.run()
    hist = offline_enas.run(api, clients, RunConfig(device="cpu",
                                                    **OFFLINE))
    return ref_hist, first, again, hist, first_seeds


@pytest.fixture(scope="module")
def fedavg_runs(setup):
    ref_api, api, ref_clients, clients, seeds = setup
    ref_run = RefEngine(ref_api, ref_clients,
                        RefRunConfig(backend="loop", **FEDAVG),
                        strategy=RefFedAvgBaseline(FEDAVG_KEY)).run()
    del seeds[:]
    eng = FedEngine(api, clients, RunConfig(device="cpu", **FEDAVG),
                    strategy=FedAvgBaseline(FEDAVG_KEY))
    first = eng.run()
    first_seeds = list(seeds)
    again = eng.run()
    return ref_run, first, again, first_seeds


def test_offline_matches_reference(offline_runs):
    ref_hist, ours, _, _, seeds = offline_runs
    # population 2, 1 generation: parents then offspring, each reinitialized
    assert seeds == [1001, 1002, 1003, 1004]
    (report,) = ours.reports
    assert ref_hist["gen"] == [1]
    np.testing.assert_allclose(report.objs, ref_hist["objs"][0], atol=1e-5)
    for ka, kb in zip(ref_hist["parent_keys"][0], report.parent_keys):
        np.testing.assert_array_equal(ka, kb)
    assert report.best_err == pytest.approx(ref_hist["best_err"][0],
                                            abs=1e-5)
    assert dataclasses.asdict(ref_hist["stats"]) == \
        dataclasses.asdict(ours.stats)
    assert ours.stats.up_wire_bytes < ours.stats.up_bytes
    assert ours.stats.down_wire_bytes == ours.stats.down_bytes
    assert ours.extras == {}


def test_offline_is_reentrant(offline_runs):
    _, first, again, _, _ = offline_runs
    assert dataclasses.asdict(first.stats) == dataclasses.asdict(again.stats)
    np.testing.assert_array_equal(first.reports[0].objs,
                                  again.reports[0].objs)


def test_offline_enas_shim_history_layout(offline_runs):
    ref_hist, ours, _, hist, _ = offline_runs
    assert set(hist) == set(ref_hist)
    np.testing.assert_array_equal(hist["objs"][0], ours.reports[0].objs)
    assert dataclasses.asdict(hist["stats"]) == dataclasses.asdict(ours.stats)


def test_fedavg_matches_reference(fedavg_runs):
    ref_run, ours, _, seeds = fedavg_runs
    assert seeds == [0]
    assert len(ours.reports) == len(ref_run.reports) == 2
    for a, b in zip(ref_run.reports, ours.reports):
        assert a.best_err == pytest.approx(b.best_err, abs=1e-5)
        assert (a.down_gb, a.up_gb, a.train_passes) == \
            (b.down_gb, b.up_gb, b.train_passes)
    assert dataclasses.asdict(ref_run.stats) == dataclasses.asdict(ours.stats)
    assert ours.extras["flops"] == ref_run.extras["flops"]


def test_fedavg_params_within_tolerance(fedavg_runs, setup):
    ref_run, ours, _, _ = fedavg_runs
    ref_api = setup[0]
    init = jax.tree.leaves(ref_api.init(jax.random.PRNGKey(0)))
    ref_leaves = jax.tree.leaves(ref_run.extras["params"])
    our_leaves = jax.tree.leaves(params_to_reference(ours.extras["params"]))
    for a0, a, b in zip(init, ref_leaves, our_leaves):
        a, a0 = np.asarray(a), np.asarray(a0)
        atol = MASTER_ATOL + float(np.abs(a - a0).max()) / 127
        assert float(np.abs(a - b).max()) <= atol


def test_fedavg_is_reentrant(fedavg_runs):
    _, first, again, _ = fedavg_runs
    assert dataclasses.asdict(first.stats) == dataclasses.asdict(again.stats)
    p1, p2 = first.extras["params"], again.extras["params"]
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert ops.LAUNCHES["quantize_int8"] == 0     # CPU: plain version


def test_rt_enas_shim_history_layout(setup):
    _, api, _, clients, _ = setup
    cfg = RunConfig(device="cpu", population=4, generations=2, seed=0,
                    lr0=0.01, uplink_codec="int8")
    seen = []
    hist = rt_enas.run(api, clients, cfg,
                       callback=lambda gen, live: seen.append(
                           (gen, len(live["gen"]))))
    assert seen == [(1, 1), (2, 2)]
    assert HISTORY_FIELDS == REF_HISTORY_FIELDS
    # the fields a synchronous RealTimeNas run produces, then the extras
    produced = [f for f in HISTORY_FIELDS if not f.startswith(
        ("n_", "wasted_"))]
    assert list(hist) == produced + ["final_master", "stats"]
    direct = FedEngine(api, clients, cfg, strategy=RealTimeNas()).run()
    assert dataclasses.asdict(hist["stats"]) == \
        dataclasses.asdict(direct.stats)
    for a, b in zip(hist["objs"], direct.reports):
        np.testing.assert_array_equal(a, b.objs)
    m = direct.extras["final_master"]
    assert all(torch.equal(hist["final_master"][k], m[k]) for k in m)


def test_fedavg_round_matches_loop_backend(setup):
    """The legacy ``fedavg_round`` is the loop backend's ``train_fedavg``
    (held against the JAX package by the FedAvg runs above), bit for
    bit."""
    from repro_torch.engine import LoopBackend
    _, api, _, clients, _ = setup
    params = api.init(torch.Generator().manual_seed(0))
    cfg = RunConfig(device="cpu", lr0=0.01)
    ours = fedavg_round(client_update_fn(api), params, FEDAVG_KEY, clients,
                        0.01)
    loop = LoopBackend(api, clients, cfg).train_fedavg(
        params, FEDAVG_KEY, np.arange(len(clients)), 0.01)
    assert list(ours) == list(params)
    assert all(torch.equal(ours[k], loop[k]) for k in params)
