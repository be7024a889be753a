"""repro_torch's batched ``vmap`` execution backend against the JAX
package's and against the port's own ``loop`` backend, on the smoke CIFAR
supernet (4 blocks, image 8), 8 clients of 60 samples.

The JAX package runs twice, in one module fixture: its ``vmap`` backend
fused for 2 generations and non-fused for 1, with
``aggregate_backend="xla"``.  Both packages start from the reference's
``api.init(PRNGKey(0))``.  The port's ``vmap`` on the ``"torch"`` route
must give equal keys, ``CommStats`` and ``dispatches``, objectives
within 1e-5 and the final master within MASTER_ATOL = 1e-4 (the port's
loop backend sits 3.2e-5 from the JAX package's, and the JAX package's
own loop-vs-vmap spread is 1.303e-5, so no tighter bound holds); on the
``"kernel"`` route a fused ``train_fill`` is one call for the uploads
plus one per shape bucket.

Everything else is held against the port's ``LoopBackend`` from the
port's own init (``torch.Generator``), within LOOP_ATOL = 1e-5 (the JAX
package's own loop-vs-vmap limit), fused against non-fused within 1e-6
(the JAX package's limit); error counts, which are integers, exactly.
A group's clients train in turn on the loop backend's step, so only
Algorithm 3's sums differ from the loop's (measured: at most 8.9e-8).
From the JAX package's init the same comparisons differ by up to
4.96e-5 (the ragged case after 2 generations): there a ReLU input within
~1e-7 of zero lands on the other side of the kink on an unlucky key,
and SGD carries it (2.6e-5 after one client update on one key of four).
Under an int8 uplink the master may differ by one step of the int8 grid
more (``max|update| / 127`` of the leaf), which a float gap can cross.
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
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.data import make_classification as ref_make_classification  # noqa: E402,E501
from repro.data import make_clients as ref_make_clients  # noqa: E402
from repro.data import partition_iid as ref_partition_iid  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.engine import FedEngine as RefEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference, \
    params_to_reference  # noqa: E402
from repro_torch.core import aggregate, cnn_supernet_api  # noqa: E402
from repro_torch.data import ClientBatch, ClientFleet, \
    VirtualClassification, make_classification, make_clients, make_fleet, \
    partition_iid, shape_buckets  # noqa: E402
from repro_torch.engine import ClientSimConfig, FedAvgBaseline, \
    FedEngine, LoopBackend, OfflineNas, RunConfig, VmapBackend  # noqa: E402
from repro_torch.core.federated import client_update_fn  # noqa: E402
from repro_torch.engine.backends import cast_like, clients_in_turn, \
    master_donation_safe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MASTER_ATOL = 1e-4      # against the JAX package
LOOP_ATOL = 1e-5        # against the port's loop backend
FUSED_ATOL = 1e-6       # fused against non-fused
RUN = dict(population=4, seed=0, lr0=0.01)
MODES = {"fused": (True, 2), "nonfused": (False, 1)}   # fused, generations
ROUTES = ("torch", "kernel")
REF_CASES = [(mode, route) for mode in MODES for route in ROUTES]
BASELINE_KEY = np.asarray([1, 0, 2, 3], np.int32)


def tiny_clients(mod_classification, mod_clients, mod_partition,
                 num_clients=8, n=480, seed=0):
    x, y = mod_classification(seed, n, image=8, signal=1.5, noise=0.5)
    return mod_clients(x, y, mod_partition(seed, n, num_clients),
                       batch=20, test_batch=20)


def port_clients(num_clients=8, n=480):
    return tiny_clients(make_classification, make_clients, partition_iid,
                        num_clients=num_clients, n=n)


def ragged_clients():
    """Two shape buckets: 4 clients with 60-sample shards and 2 with
    100-sample shards (tests/test_engine.py::ragged_clients)."""
    x, y = make_classification(3, 440, image=8, signal=1.5, noise=0.5)
    shards = [np.arange(60) + 60 * i for i in range(4)] \
        + [240 + np.arange(100), 340 + np.arange(100)]
    return make_clients(x, y, shards, batch=20, test_batch=20)


def fused_bound(generations: int) -> int:
    """Fused dispatches of a RealTimeNas run on the torch route: two
    train_fill in generation 1, then one a generation, and one eval each."""
    return 2 * generations + 1


@pytest.fixture(scope="module")
def apis():
    """The JAX package's API, the port's with the JAX package's init
    injected, and the port's own."""
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=True))
    init = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(0)))
    own = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    api = dataclasses.replace(own, init=lambda g: params_from_reference(init))
    return ref_api, api, own


def run(api, clients, strategy=None, **kw):
    """One engine run on the CPU -> (result, dispatches)."""
    eng = FedEngine(api, clients, RunConfig(device="cpu", **kw),
                    strategy=strategy)
    return eng.run(), eng.backend.dispatches


@pytest.fixture(scope="module")
def ref_runs(apis):
    ref_api = apis[0]
    out = {}
    for mode, (fused, gens) in MODES.items():
        eng = RefEngine(ref_api, tiny_clients(
            ref_make_classification, ref_make_clients, ref_partition_iid),
            RefRunConfig(backend="vmap", aggregate_backend="xla",
                         fused=fused, generations=gens, **RUN))
        out[mode] = (eng.run(), eng.backend.dispatches)
    return out


@pytest.fixture(scope="module")
def port_runs(apis):
    """The reference's runs on the port's ``vmap`` (from the JAX
    package's init), then 2 generations of ``loop`` and fused ``vmap``
    from the port's own init, on both routes."""
    _, api, own = apis
    clients = port_clients()
    out = {}
    for mode, route in REF_CASES:
        fused, gens = MODES[mode]
        out[mode, route] = run(
            api, clients, backend="vmap", fused=fused, generations=gens,
            aggregate_backend=route, **RUN)
    for route in ROUTES:
        out["loop", route] = run(own, clients, backend="loop",
                                 generations=2, aggregate_backend=route,
                                 **RUN)
        out["vmap", route] = run(own, clients, backend="vmap",
                                 generations=2, aggregate_backend=route,
                                 **RUN)
    return out


def max_master_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def max_ref_diff(ref_master, master) -> float:
    return max(float(np.abs(np.asarray(a) - b).max())
               for a, b in zip(jax.tree.leaves(ref_master),
                               jax.tree.leaves(params_to_reference(master))))


def assert_same_search(a, b, atol=1e-5):
    """Equal keys and CommStats, objectives within ``atol``."""
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert len(a.reports) == len(b.reports)
    for ra, rb in zip(a.reports, b.reports):
        if ra.parent_keys is not None:
            for ka, kb in zip(ra.parent_keys, rb.parent_keys):
                np.testing.assert_array_equal(ka, kb)
        if ra.objs is not None:
            np.testing.assert_allclose(ra.objs, rb.objs, atol=atol)
        assert ra.best_err == pytest.approx(rb.best_err, abs=atol)
        assert (ra.n_dropped, ra.n_survivors) == (rb.n_dropped,
                                                  rb.n_survivors)


# ---------------------------------------------------------------------------
# against the JAX package's vmap backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,route", REF_CASES)
def test_vmap_matches_reference(ref_runs, port_runs, mode, route):
    ref, ref_dispatches = ref_runs[mode]
    ours, dispatches = port_runs[mode, route]
    assert_same_search(ref, ours)
    for a, b in zip(ref.reports, ours.reports):
        np.testing.assert_array_equal(a.best_key, b.best_key)
        np.testing.assert_array_equal(a.knee_key, b.knee_key)
    assert max_ref_diff(ref.extras["final_master"],
                        ours.extras["final_master"]) <= MASTER_ATOL
    fused, gens = MODES[mode]
    if fused and route == "kernel":
        # each train_fill: the uploads' call, then one K1 per bucket (1)
        assert dispatches == ref_dispatches + (gens + 1)
    else:
        assert dispatches == ref_dispatches
    if fused:
        assert ref_dispatches == fused_bound(gens)


# ---------------------------------------------------------------------------
# against the port's loop backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_fused_vmap_matches_loop(port_runs, route):
    loop, _ = port_runs["loop", route]
    ours, _ = port_runs["vmap", route]
    assert_same_search(loop, ours)
    assert max_master_diff(loop.extras["final_master"],
                           ours.extras["final_master"]) <= LOOP_ATOL
    assert ops.LAUNCHES["fill_aggregate"] == 0      # CPU: plain version


def test_clients_in_turn_stacks_the_loop_updates(apis):
    """One group's uploads: row i is the loop backend's update of client
    i bit for bit; a leaf the key does not train is the master's own
    storage, expanded over the clients (no copy)."""
    api = apis[2]
    clients = port_clients(num_clients=3, n=180)
    master = api.init(torch.Generator().manual_seed(0))
    key = np.asarray([1, 0, 2, 3], np.int32)
    xb = torch.stack([torch.as_tensor(c.train[0]) for c in clients])
    yb = torch.stack([torch.as_tensor(c.train[1]) for c in clients])
    upd = client_update_fn(api)
    outs = clients_in_turn(upd, master, key, xb, yb, 0.01)
    want = [upd(master, key, xb[i], yb[i], 0.01) for i in range(3)]
    trained = api.trained_mask(master, key)
    assert set(outs) == set(master)
    for k, v in outs.items():
        assert v.shape == (3,) + master[k].shape
        for i in range(3):
            assert torch.equal(v[i], want[i][k])
        if not bool(trained[k].any()):
            assert v.data_ptr() == master[k].data_ptr()
            assert v.stride(0) == 0
    assert any(not bool(m.any()) for m in trained.values())


@pytest.mark.parametrize("route", ROUTES)
def test_nonfused_vmap_matches_fused(apis, port_runs, route):
    fused, _ = port_runs["vmap", route]
    nonfused, n = run(apis[2], port_clients(), backend="vmap", fused=False,
                      generations=2, aggregate_backend=route, **RUN)
    assert_same_search(fused, nonfused, atol=0)
    assert max_master_diff(fused.extras["final_master"],
                           nonfused.extras["final_master"]) <= FUSED_ATOL
    assert n > fused_bound(2)


@pytest.mark.parametrize("route,fused", [("torch", True), ("kernel", True),
                                         ("kernel", False)])
def test_ragged_clients_two_buckets(apis, route, fused):
    """Two shape buckets: the fused dispatches stay at the bound (the
    buckets loop inside the call) and ragged groups ride weight-0
    padding rows; results equal the loop backend's, fused or not.  The master within
    MASTER_ATOL, not LOOP_ATOL: the batched fill adds the uploads bucket
    by bucket where the loop adds them group by group, so the float32
    sums round otherwise, and SGD carries that (measured after 2
    generations: 6.3e-5 on the torch route, 8.9e-8 on the kernel
    route)."""
    api, clients = apis[2], ragged_clients()
    kw = dict(RUN, population=3, generations=2, aggregate_backend=route)
    loop, _ = run(api, clients, backend="loop", **kw)
    ours, dispatches = run(api, clients, backend="vmap", fused=fused, **kw)
    assert_same_search(loop, ours)
    assert max_master_diff(loop.extras["final_master"],
                           ours.extras["final_master"]) <= MASTER_ATOL
    if not fused:
        assert dispatches > fused_bound(2)
        return
    n_fill = kw["generations"] + 1
    assert dispatches == fused_bound(2) + (2 * n_fill
                                           if route == "kernel" else 0)


def test_dropout_matches_loop_and_keeps_fused_bound(apis):
    api, clients = apis[2], port_clients()
    kw = dict(RUN, generations=2, aggregate_backend="torch",
              client_sim=ClientSimConfig(dropout=0.3, seed=1))
    loop, _ = run(api, clients, backend="loop", **kw)
    ours, dispatches = run(api, clients, backend="vmap", **kw)
    assert loop.stats.wasted_down_bytes > 0
    assert_same_search(loop, ours)
    assert max_master_diff(loop.extras["final_master"],
                           ours.extras["final_master"]) <= LOOP_ATOL
    assert dispatches == fused_bound(2)


@pytest.mark.parametrize("fused", [True, False])
def test_full_dropout_freezes_master(apis, fused):
    api = apis[1]
    clients = port_clients(num_clients=4, n=240)
    res, _ = run(api, clients, backend="vmap", fused=fused,
                 **dict(RUN, population=2, generations=2,
                        client_sim=ClientSimConfig(dropout=1.0)))
    init = api.init(None)
    master = res.extras["final_master"]
    assert all(torch.equal(master[k], init[k]) for k in init)
    assert res.stats.up_bytes == 0
    assert all(float(e) == 1.0 for r in res.reports for e in r.objs[:, 0])
    # called directly: no survivor, the master comes back untouched
    backend = VmapBackend(api, clients, RunConfig(device="cpu", fused=fused))
    keys = [np.zeros(api.num_blocks, np.int32), np.ones(api.num_blocks,
                                                        np.int32)]
    out = backend.train_fill(init, keys, [np.array([0, 1]),
                                          np.array([2, 3])], 0.01,
                             survivors=set())
    assert out is init


@pytest.mark.parametrize("fused", [True, False])
def test_baselines_match_loop(apis, fused):
    api = apis[2]
    clients = port_clients(num_clients=4, n=240)
    for strategy, kw in ((OfflineNas, dict(population=2, generations=1)),
                         (lambda: FedAvgBaseline(BASELINE_KEY),
                          dict(population=4, generations=2))):
        kw = dict(RUN, seed=1, **kw)
        loop, _ = run(api, clients, strategy(), backend="loop", **kw)
        ours, dispatches = run(api, clients, strategy(), backend="vmap",
                               fused=fused, **kw)
        assert_same_search(loop, ours)
        if "params" in loop.extras:
            assert max_master_diff(loop.extras["params"],
                                   ours.extras["params"]) <= LOOP_ATOL
            if fused:       # one fedavg call and one eval per round
                assert dispatches == 2 * kw["generations"]


def test_int8_uplink_matches_loop(apis):
    api, clients = apis[2], port_clients()
    kw = dict(RUN, generations=2, uplink_codec="int8")
    loop, _ = run(api, clients, backend="loop", **kw)
    eng = FedEngine(api, clients, RunConfig(device="cpu", backend="vmap",
                                            **kw))
    ours = eng.run()
    assert eng.backend.inner.donate_master is False
    assert_same_search(loop, ours)
    init = api.init(torch.Generator().manual_seed(0))
    a, b = loop.extras["final_master"], ours.extras["final_master"]
    for k in init:
        atol = LOOP_ATOL + float((a[k] - init[k]).abs().max()) / 127
        assert float((a[k] - b[k]).abs().max()) <= atol


@pytest.mark.parametrize("fused", [True, False])
def test_eval_tile_does_not_change_error_rates(apis, fused):
    """8 clients in tiles of 1, 3 (two tiles and a tail of 2) and 32
    (one tile of all): equal to the loop backend's rates."""
    api, clients = apis[1], port_clients()
    master = api.init(None)
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 4, api.num_blocks).astype(np.int32)
            for _ in range(3)]
    ids = np.arange(len(clients))
    loop = LoopBackend(api, clients, RunConfig(device="cpu"))
    want = loop.eval_shared(master, keys, ids)
    want_paired = loop.eval_paired([master] * 3, keys, ids,
                                   survivors={0, 2, 3, 7})
    for tile in (1, 3, 32):
        backend = VmapBackend(api, clients, RunConfig(
            device="cpu", fused=fused, vmap_eval_tile=tile))
        np.testing.assert_array_equal(
            backend.eval_shared(master, keys, ids), want)
        np.testing.assert_array_equal(
            backend.eval_paired([master] * 3, keys, ids,
                                survivors={0, 2, 3, 7}), want_paired)


def test_vmap_eval_tile_validated():
    with pytest.raises(ValueError, match="vmap_eval_tile"):
        RunConfig(device="cpu", vmap_eval_tile=0)
    cfg = RunConfig(device="cpu")
    assert (cfg.vmap_eval_tile, cfg.fused) == (32, True)


# ---------------------------------------------------------------------------
# stacking, caches, the lazy fleet
# ---------------------------------------------------------------------------

def test_train_store_lru_evicts_and_refreshes_on_hit(apis):
    backend = VmapBackend(apis[1], port_clients(num_clients=16, n=960),
                          RunConfig(device="cpu"))
    a, b, c = [0, 1, 2], [3, 4], [5, 6, 7]
    sa = backend._train_store(a)
    backend._train_store(b)
    assert backend._train_store(a) is sa       # hit: same stacked tensors
    backend._train_store(c)                    # evicts b (LRU), not a
    assert set(backend._train_cache) == {(0, 1, 2), (5, 6, 7)}
    assert backend._train_store(a) is sa       # survived the eviction
    # unordered / duplicated ids canonicalize to the same key
    assert backend._train_store([2, 0, 1, 1]) is sa
    assert backend.cache_stats["train_store_hits"] == 3
    assert backend.cache_stats["train_store_misses"] == 3


def test_train_store_stacks_only_sampled_clients(apis):
    clients = port_clients(num_clients=16, n=960)
    backend = VmapBackend(apis[1], clients, RunConfig(device="cpu"))
    store = backend._train_store([3, 7, 11])
    assert sum(xb.shape[0] for _, xb, _ in store) == 3
    assert sorted(cid for pos, _, _ in store for cid in pos) == [3, 7, 11]
    for pos, xb, yb in store:
        for cid, row in pos.items():
            assert torch.equal(xb[row], torch.as_tensor(clients[cid].train[0]))
            assert torch.equal(yb[row], torch.as_tensor(clients[cid].train[1]))


def test_test_batches_lru_refreshes_on_hit(apis):
    backend = VmapBackend(apis[1], port_clients(num_clients=6, n=360),
                          RunConfig(device="cpu"))
    first = backend._test_batches([0, 1])
    backend._test_batches([2, 3])
    assert backend._test_batches([1, 0]) is first
    backend._test_batches([4, 5])               # evicts (2, 3)
    assert set(backend._test_cache) == {(0, 1), (4, 5)}
    assert backend.cache_stats == {
        "train_store_hits": 0, "train_store_misses": 0,
        "test_stack_hits": 1, "test_stack_misses": 3}


def test_lazy_fleet_materialises_only_participants(apis):
    k, spc = 400, 30
    src = VirtualClassification(2, k * spc, image=8, signal=1.5, noise=0.5)
    fleet = ClientFleet(src, partition_iid(2, k * spc, k), batch=5,
                        test_batch=5, cache_size=64)
    res, _ = run(apis[1], fleet, backend="vmap", participation=16 / k,
                 **dict(RUN, generations=2))
    assert res.reports[-1].best_err is not None
    assert 16 <= fleet.materialized <= 16 * 2
    assert fleet.cached <= fleet.cache_size < k


def test_fleet_and_eager_clients_give_the_same_run(apis):
    x, y = make_classification(0, 480, image=8, signal=1.5, noise=0.5)
    part = partition_iid(0, 480, 8)
    eager, _ = run(apis[1], make_clients(x, y, part, batch=20,
                                         test_batch=20),
                   backend="vmap", **dict(RUN, generations=1))
    lazy, _ = run(apis[1], make_fleet(x, y, part, batch=20, test_batch=20),
                  backend="vmap", **dict(RUN, generations=1))
    assert_same_search(eager, lazy, atol=0)
    m1, m2 = eager.extras["final_master"], lazy.extras["final_master"]
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


@pytest.mark.parametrize("split", ["train", "test"])
def test_client_batch_equals_reference(split):
    ref_clients = tiny_clients(ref_make_classification, ref_make_clients,
                               ref_partition_iid, num_clients=4, n=240)
    clients = port_clients(num_clients=4, n=240)
    ref_cb = ref_pipeline.ClientBatch.stack(ref_clients, split=split)
    cb = ClientBatch.stack(clients, split=split)
    for f in ("xb", "yb", "weights", "client_ids"):
        a, b = getattr(ref_cb, f), getattr(cb, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (cb.num_shards, cb.samples_per_shard) == \
        (ref_cb.num_shards, ref_cb.samples_per_shard)
    with pytest.raises(ValueError, match="ragged"):
        ClientBatch.stack([clients[0], port_clients(num_clients=2)[0]],
                          split=split)
    with pytest.raises(ValueError):
        ClientBatch.stack([], split=split)


def test_shape_buckets_equal_reference():
    shapes = [(2, 5), (3, 5), (2, 5), (3, 5), (2, 5), (4, 1)]
    assert shape_buckets(shapes) == ref_pipeline.shape_buckets(shapes) \
        == [[0, 2, 4], [1, 3], [5]]
    ragged = ragged_clients()
    shapes = [c.train[0].shape for c in ragged]
    assert shape_buckets(shapes) == ref_pipeline.shape_buckets(shapes) \
        == [[0, 1, 2, 3], [4, 5]]


# ---------------------------------------------------------------------------
# the stacked Algorithm 3
# ---------------------------------------------------------------------------

def stacked_inputs(ref_api, seed, n_up, chunk_sizes):
    """A master, n_up uploads (master + a per-upload offset), keys and
    weights, in both packages' layouts, cut into chunks."""
    master = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4, (n_up, ref_api.num_blocks)).astype(np.int32)
    weights = rng.random(n_up).astype(np.float32) * 3 + 0.5
    ups = [jax.tree.map(lambda x: x + np.float32(0.05 * (i + 1))
                        * rng.normal(size=x.shape).astype(np.float32),
                        master) for i in range(n_up)]
    ref_chunks, chunks, lo = [], [], 0
    for n in chunk_sizes:
        sl = slice(lo, lo + n)
        lo += n
        ref_chunks.append((jax.tree.map(lambda *xs: np.stack(xs), *ups[sl]),
                           keys[sl], weights[sl]))
        port_ups = [params_from_reference(u) for u in ups[sl]]
        chunks.append(({k: torch.stack([u[k] for u in port_ups])
                        for k in port_ups[0]}, keys[sl], weights[sl]))
    return master, ref_chunks, chunks


@pytest.fixture(scope="module", params=[(3,), (2, 2, 1)],
                ids=["one_chunk", "three_chunks"])
def stacked_case(apis, request):
    """Inputs cut into the given chunks and the JAX package's stacked
    Algorithm 3 of them (its ``"xla"`` route), computed once."""
    ref_api = apis[0]
    master, ref_chunks, chunks = stacked_inputs(
        ref_api, 1, sum(request.param), request.param)
    want = ref_aggregate.fill_aggregate_stacked(
        master, ref_chunks, mask_fn=ref_api.trained_mask, backend="xla")
    return master, chunks, want


@pytest.mark.parametrize("route", ROUTES)
def test_fill_aggregate_stacked_matches_reference(apis, stacked_case, route):
    api = apis[1]
    master, chunks, want = stacked_case
    prev = params_from_reference(master)
    before = {k: v.clone() for k, v in prev.items()}
    got = aggregate.fill_aggregate_stacked(prev, chunks,
                                           mask_fn=api.trained_mask,
                                           backend=route)
    assert max_ref_diff(want, got) <= 1e-6
    # the caller's master is never written (the kernel route's in-place
    # launch writes into its own flat copy)
    assert all(torch.equal(prev[k], before[k]) for k in prev)
    # already-normalized weights with total=1.0 give the same master
    norm = float(sum(float(np.sum(w)) for _, _, w in chunks))
    got1 = aggregate.fill_aggregate_stacked(
        prev, [(s, k, np.asarray(w, np.float32) / norm)
               for s, k, w in chunks],
        mask_fn=api.trained_mask, backend=route, total=1.0)
    assert max_master_diff(got, got1) <= 1e-6


def test_fill_partial_matches_reference(apis):
    ref_api, api, _ = apis
    master, (ref_chunk,), (chunk,) = stacked_inputs(ref_api, 2, 4, (4,))
    stacked, keys, w = chunk
    wnorm = (w / w.sum()).astype(np.float32)
    ref_masks = jax.vmap(ref_api.trained_mask)(ref_chunk[0],
                                               jax.numpy.asarray(keys))
    want = ref_aggregate.fill_partial(master, ref_chunk[0], ref_masks,
                                      jax.numpy.asarray(wnorm))
    prev = params_from_reference(master)
    masks = aggregate.stacked_masks(api.trained_mask, stacked, keys)
    assert all(m.shape == (4,) for m in masks.values())
    got = aggregate.fill_partial(prev, stacked, masks,
                                 torch.from_numpy(wnorm))
    assert max_ref_diff(want, got) <= 1e-6


def test_unknown_stacked_route_raises(apis):
    api = apis[1]
    with pytest.raises(ValueError, match="aggregate backend"):
        aggregate.fill_aggregate_stacked(api.init(None), [],
                                         mask_fn=api.trained_mask,
                                         backend="xla", total=1.0)


# ---------------------------------------------------------------------------
# master donation, construction
# ---------------------------------------------------------------------------

def test_master_donation_gating(apis):
    assert master_donation_safe(RunConfig(device="cpu"))
    assert master_donation_safe(RunConfig(device="cpu",
                                          downlink_codec="cast"))
    assert not master_donation_safe(RunConfig(device="cpu",
                                              uplink_codec="int8"))
    assert not master_donation_safe(RunConfig(device="cpu",
                                              uplink_codec="topk:0.25"))
    # CPU: never donated
    backend = VmapBackend(apis[1], port_clients(num_clients=4, n=240),
                          RunConfig(device="cpu"))
    assert backend.donate_master is False


def test_donation_writes_only_into_the_backends_own_master(apis):
    """With donation forced on (it is CUDA-only): the injected master is
    never written; the next call writes into the master the backend
    returned, and both results equal the undonated ones."""
    api = apis[1]
    clients = port_clients(num_clients=4, n=240)
    keys = [np.asarray([1, 0, 2, 3], np.int32),
            np.asarray([3, 2, 1, 0], np.int32)]
    groups = [np.array([0, 1]), np.array([2, 3])]
    init = api.init(None)
    before = {k: v.clone() for k, v in init.items()}
    plain = VmapBackend(api, clients, RunConfig(device="cpu",
                                                aggregate_backend="torch"))
    want1 = plain.train_fill(init, keys, groups, 0.01)
    want2 = plain.train_fill(want1, keys[::-1], groups, 0.01)
    donor = VmapBackend(api, clients, RunConfig(device="cpu",
                                                aggregate_backend="torch"))
    donor.donate_master = True
    got1 = donor.train_fill(init, keys, groups, 0.01)
    assert got1 is not init
    assert all(torch.equal(init[k], before[k]) for k in init)
    assert all(torch.equal(want1[k], got1[k]) for k in want1)
    ptrs = {k: v.data_ptr() for k, v in got1.items()}
    got2 = donor.train_fill(got1, keys[::-1], groups, 0.01)
    assert got2 is got1
    assert all(got2[k].data_ptr() == ptrs[k] for k in got2)
    assert all(torch.equal(want2[k], got2[k]) for k in want2)
    assert donor.dispatches == plain.dispatches == 2


def test_cast_like_donate_writes_into_ref():
    ref = {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.float64)}
    tree = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    fresh = cast_like(tree, ref)
    assert fresh["b"].dtype == torch.float64 and float(ref["a"].sum()) == 0
    out = cast_like(tree, ref, donate=True)
    assert out is ref and torch.equal(ref["a"], torch.ones(3))
    assert torch.equal(ref["b"], torch.full((2,), 2.0, dtype=torch.float64))


def test_vmap_on_cuda_without_a_card_raises(apis):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device is usable")
    clients = port_clients(num_clients=4, n=240)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VmapBackend(apis[1], clients, RunConfig(backend="vmap"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedEngine(apis[1], clients, RunConfig(backend="vmap"))
