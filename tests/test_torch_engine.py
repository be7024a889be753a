"""The slice as a whole: repro_torch ``FedEngine`` + ``RealTimeNas`` on the
loop backend against the JAX package's, on the smoke CIFAR supernet.

Both start from the reference's ``api.init(PRNGKey(0))``, injected into
the port through the weight bridge.  The oracle is the reference's loop
backend with ``aggregate_backend="xla"`` (its ``"pallas"`` route computes
the same function: tests/test_torch_kernels.py holds the port's routes
against both).  Over 2 generations at lr0 = 0.01, for both of the port's
routes:
keys and CommStats must be equal, objectives within 1e-5 (as the JAX
package's own cross-backend tests hold them), and the final master
within MASTER_ATOL = 1e-4.  Measured on the CPU the master gap is 3.2e-5
for either route: the two packages round convolutions differently, and
the odd ReLU input within ~1e-7 of zero lands on the other side of the
kink (see tests/test_torch_federated.py), which SGD then carries.  The
JAX package's own loop-vs-vmap spread is 1.3e-5.
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
from repro.data import make_classification as ref_make_classification  # noqa: E402,E501
from repro.data import make_clients as ref_make_clients  # noqa: E402
from repro.data import partition_iid as ref_partition_iid  # noqa: E402
from repro.engine import FedEngine as RefEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference, \
    params_to_reference  # noqa: E402
from repro_torch.core import cnn_supernet_api  # noqa: E402
from repro_torch.data import make_classification, make_clients, \
    partition_iid  # noqa: E402
from repro_torch.engine import FedEngine, RunConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MASTER_ATOL = 1e-4
ROUTES = ("torch", "kernel")
RUN = dict(population=4, generations=2, seed=0, lr0=0.01)


def tiny_clients(mod_classification, mod_clients, mod_partition,
                 num_clients=8, n=480, seed=0):
    x, y = mod_classification(seed, n, image=8, signal=1.5, noise=0.5)
    return mod_clients(x, y, mod_partition(seed, n, num_clients),
                       batch=20, test_batch=20)


@pytest.fixture(scope="module")
def apis():
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=True))
    init = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(0)))
    api = dataclasses.replace(
        cnn_supernet_api(get_config("cifar-supernet", smoke=True)),
        init=lambda g: params_from_reference(init))
    return ref_api, api


@pytest.fixture(scope="module")
def runs(apis):
    ref_api, api = apis
    ref_clients = tiny_clients(ref_make_classification, ref_make_clients,
                               ref_partition_iid)
    clients = tiny_clients(make_classification, make_clients, partition_iid)
    ref = RefEngine(ref_api, ref_clients,
                    RefRunConfig(backend="loop", aggregate_backend="xla",
                                 **RUN)).run()
    out = {}
    for route in ROUTES:
        eng = FedEngine(api, clients, RunConfig(
            aggregate_backend=route, device="cpu", **RUN))
        first = eng.run()
        again = eng.run()
        out[route] = (ref, first, again)
    return out


def max_master_diff(ref_master, master):
    return max(float(np.abs(np.asarray(a) - b).max())
               for a, b in zip(jax.tree.leaves(ref_master),
                               jax.tree.leaves(params_to_reference(master))))


@pytest.mark.parametrize("route", ROUTES)
def test_keys_and_objectives_match_reference(runs, route):
    ref, ours, _ = runs[route]
    assert len(ours.reports) == len(ref.reports) == 2
    for a, b in zip(ref.reports, ours.reports):
        assert len(a.parent_keys) == len(b.parent_keys)
        for ka, kb in zip(a.parent_keys, b.parent_keys):
            np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(a.best_key, b.best_key)
        np.testing.assert_array_equal(a.knee_key, b.knee_key)
        np.testing.assert_allclose(a.objs, b.objs, atol=1e-5)
        assert a.best_err == pytest.approx(b.best_err, abs=1e-5)
        assert a.train_passes == b.train_passes
        assert (a.down_gb, a.up_gb) == (b.down_gb, b.up_gb)


@pytest.mark.parametrize("route", ROUTES)
def test_comm_stats_are_byte_identical(runs, route):
    ref, ours, _ = runs[route]
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(ours.stats)


@pytest.mark.parametrize("route", ROUTES)
def test_final_master_within_tolerance(runs, route):
    ref, ours, _ = runs[route]
    master = ours.extras["final_master"]
    assert all(v.device.type == "cpu" for v in master.values())
    assert max_master_diff(ref.extras["final_master"], master) <= MASTER_ATOL


@pytest.mark.parametrize("route", ROUTES)
def test_run_is_reentrant(runs, route):
    _, first, again = runs[route]
    assert dataclasses.asdict(first.stats) == dataclasses.asdict(again.stats)
    for a, b in zip(first.reports, again.reports):
        np.testing.assert_array_equal(a.objs, b.objs)
    m1, m2 = first.extras["final_master"], again.extras["final_master"]
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_routes_agree_and_cpu_run_launches_no_kernel(runs):
    # the routes differ only in the order of the float32 sums of
    # Algorithm 3 (measured gap on the CPU after 2 generations: 2.7e-6)
    assert ops.LAUNCHES["fill_aggregate"] == 0
    a = runs["torch"][1].extras["final_master"]
    b = runs["kernel"][1].extras["final_master"]
    assert max(float((a[k] - b[k]).abs().max()) for k in a) <= 1e-5


def test_dropout_run_matches_reference(apis):
    ref_api, api = apis
    sim = {"dropout": 0.3, "seed": 1}
    run = dict(RUN, generations=1)
    ref = RefEngine(ref_api, tiny_clients(ref_make_classification,
                                          ref_make_clients, ref_partition_iid),
                    RefRunConfig(backend="loop", client_sim=sim, **run)).run()
    ours = FedEngine(api, tiny_clients(make_classification, make_clients,
                                       partition_iid),
                     RunConfig(device="cpu", client_sim=sim, **run)).run()
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(ours.stats)
    assert ours.stats.wasted_down_bytes > 0
    r, o = ref.reports[0], ours.reports[0]
    assert (r.n_dropped, r.n_survivors) == (o.n_dropped, o.n_survivors)
    np.testing.assert_allclose(r.objs, o.objs, atol=1e-5)
    assert max_master_diff(ref.extras["final_master"],
                           ours.extras["final_master"]) <= MASTER_ATOL


def test_default_device_is_cuda_and_never_falls_back(apis):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    clients = tiny_clients(make_classification, make_clients, partition_iid)
    assert RunConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedEngine(apis[1], clients, RunConfig(population=4, generations=1))


@pytest.mark.parametrize("name,exc", [("mesh", None),
                                      ("bogus", ValueError)])
def test_unported_backends_raise_at_construction(apis, name, exc):
    """Every backend is ported: ``mesh`` builds on the CPU (one CPU
    device; tests/test_torch_mesh.py holds it against ``vmap`` and the
    JAX package), and an unknown name raises at construction."""
    from repro_torch.engine import MeshBackend
    clients = tiny_clients(make_classification, make_clients, partition_iid)
    cfg = RunConfig(population=4, device="cpu", backend=name)
    if exc is None:
        eng = FedEngine(apis[1], clients, cfg)
        assert isinstance(eng.backend, MeshBackend)
        assert eng.backend.num_devices == 1 and eng.backend.dispatches == 0
        return
    with pytest.raises(exc):
        FedEngine(apis[1], clients, cfg)


def test_vmap_backend_builds_on_the_cpu(apis):
    """``backend="vmap"`` is ported (tests/test_torch_backends.py holds
    it against the JAX package): it builds here, on the CPU."""
    from repro_torch.engine import VmapBackend
    clients = tiny_clients(make_classification, make_clients, partition_iid)
    eng = FedEngine(apis[1], clients,
                    RunConfig(population=4, device="cpu", backend="vmap"))
    assert isinstance(eng.backend, VmapBackend)
    assert eng.backend.name == "vmap" and eng.backend.dispatches == 0
