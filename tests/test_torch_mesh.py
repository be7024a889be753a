"""repro_torch's mesh slice: ``engine/mesh_backend.py``, ``launch/mesh.py``,
``launch/policy.py``, ``launch/sharding.py``, the MoE's expert-parallel
path and the pinned decode attention, against the JAX package and
against the port's own ``vmap`` backend, on the CPU.

The port's mesh is one process driving a grid of ``torch.device``s; a
mesh that names ``"cpu"`` N times is how these tests grow an N-way mesh,
where the JAX package forces N host devices.  The JAX engine and the
JAX package's 4-device runs live in ONE subprocess (forced to 4 host
devices), started as the module begins so that it runs beside the
port's runs (the tests that read it come last):

  * granite's MoE layer on (2, 2) and (1, 4) meshes, where each of the
    four token slices is routed with a capacity of its own: the port on
    the same meshes within 2e-5 (y) and 1e-4 (aux), tests/test_moe.py's
    limits, and both about 0.1 from the gather path (measured 0.103:
    the per-slice drops are reproduced, not averaged away);
  * the JAX package's fused ``MeshBackend`` run on a mesh of one CPU
    device (``aggregate_backend="xla"``; the smoke CIFAR supernet, 4
    clients of 60 samples, population 4, 2 generations, lr0 0.01)
    against the port's 1-way CPU mesh on the torch route from the same
    init: keys and ``CommStats`` equal, objectives within 1e-5, masters
    within MASTER_ATOL = 3.7e-5 (the port's ``vmap`` against the JAX
    package's, tests/test_torch_backends.py; measured here 4.5e-8).

In process, the JAX package's (1, 1) mesh cases (the MoE layer, the
decode replay) and its sharding specs.  The JAX imports sit in fixtures,
so the card-only case runs where there is no JAX.  Against the port's
``vmap`` (no JAX, the port's own init): a 1-way mesh bit for bit on both
Algorithm 3 routes; 4- and 8-way meshes at population 3 (padded with
weight-0 groups) with equal keys and ``CommStats``, objectives and
masters within 1e-5; dispatches as the JAX package's mesh counts them;
dropout, codecs, the baselines and one LM supernet step.  Every test
that registers a mesh resets it in ``finally``.
"""
import dataclasses
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_unflatten  # noqa: E402
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference, \
    params_from_reference, params_to_reference  # noqa: E402
from repro_torch.core import cnn_supernet_api, make_api  # noqa: E402
from repro_torch.data import ClientDataset, make_classification, \
    make_clients, make_lm_stream, partition_iid  # noqa: E402
from repro_torch.engine import ClientSimConfig, FedAvgBaseline, \
    FedEngine, MeshBackend, OfflineNas, RunConfig, VmapBackend  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import policy  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import Mesh, all_gather, all_to_all, \
    data_axes, fsdp_axes, make_host_mesh, make_production_mesh, \
    mesh_axis_size, psum  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

MASTER_ATOL = 3.7e-5    # against the JAX package
ATOL = 1e-5             # N-way mesh against the port's vmap
MOE_Y, MOE_AUX = 2e-5, 1e-4
RUN = dict(seed=0, lr0=0.01, generations=2)
MOE_ARCH = "granite-moe-1b-a400m"
MOE_X = (4, 12)         # B, S of the MoE layer's input
SUB_MESHES = ((2, 2), (1, 4))
DECODE_ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m")
DECODE_TOKENS = (2, 6)  # B, S of the decode replay
# bf16's step at 0.5, the logits' scale (they reach 0.46-0.47): the two
# packages' bf16 replays differ by 0.0029 with no mesh too, as much as
# the pinned rounding moves them (0.0024-0.0039), so the replay cannot
# tell that rounding apart; test_pinned_attention_matches_reference does
BF16_STEP = 2.0 ** -8
SPEC_MESHES = (((1, 1), ("data", "model")), ((8, 1), ("data", "model")),
               ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))
CACHE_SHAPES = ("decode_32k", "long_500k")
LM_TINY = dict(supernet=True, d_model=64, d_ff=128, vocab_size=128,
               num_heads=4, num_kv_heads=4)

# The JAX subprocess (argv: the pickle it writes): a forced 4-device
# process, granite's MoE layer on (2, 2) and (1, 4) meshes, then the JAX
# package's fused mesh run on a mesh of its first device only
REF_SCRIPT = r"""
import dataclasses
import pickle
import sys

import jax
import numpy as np
from repro.configs import get_config
from repro.core import make_api
from repro.data import make_classification, make_clients, partition_iid
from repro.engine import FedEngine, RunConfig
from repro.engine.mesh_backend import MeshBackend
from repro.launch import policy
from repro.models import moe

assert len(jax.devices()) == 4, jax.devices()
out = {"moe": {}}
cfg = get_config("granite-moe-1b-a400m", smoke=True)
p = moe.moe_init(jax.random.PRNGKey(0), cfg)
out["moe_params"] = jax.tree.map(np.asarray, p)
x = np.random.default_rng(0).standard_normal(
    (4, 12, cfg.d_model)).astype(np.float32)
for shape in ((2, 2), (1, 4)):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    policy.set_mesh(mesh)
    try:
        with mesh:
            y, aux = jax.jit(lambda p_, x_: moe.moe_apply(p_, x_, cfg))(p, x)
    finally:
        policy.set_mesh(None)
    out["moe"][shape] = (np.asarray(y), float(aux))

api = make_api(get_config("cifar-supernet", smoke=True))
x, y = make_classification(0, 240, image=8, signal=1.5, noise=0.5)
clients = make_clients(x, y, partition_iid(0, 240, 4), batch=20,
                       test_batch=20)
run = RunConfig(backend="mesh", aggregate_backend="xla", population=4,
                generations=2, seed=0, lr0=0.01)
mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
backend = MeshBackend(api, clients, run, mesh=mesh)
res = FedEngine(api, clients, run, backend=backend).run()
out["init"] = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))
out["master"] = jax.tree.map(np.asarray, res.extras["final_master"])
out["reports"] = [jax.tree.map(np.asarray, dataclasses.asdict(r))
                  for r in res.reports]
out["stats"] = dataclasses.asdict(res.stats)
out["dispatches"] = backend.dispatches
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def cpu_mesh(n: int) -> Mesh:
    return make_host_mesh(["cpu"] * n)


def tiny_clients(num_clients=8, n=480, seed=0):
    x, y = make_classification(seed, n, image=8, signal=1.5, noise=0.5)
    return make_clients(x, y, partition_iid(seed, n, num_clients), batch=20,
                        test_batch=20)


def run(api, clients, mesh=None, strategy=None, **kw):
    """One engine run on the CPU -> (result, dispatches); ``mesh`` (a
    device count) builds the mesh backend over that many CPU devices."""
    cfg = RunConfig(device="cpu", **kw)
    backend = None
    if mesh is not None:
        backend = MeshBackend(api, clients, cfg, mesh=cpu_mesh(mesh))
    eng = FedEngine(api, clients, cfg, strategy=strategy, backend=backend)
    result = eng.run()
    inner = eng.backend
    while hasattr(inner, "inner"):
        inner = inner.inner
    return result, inner.dispatches


def master_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def stats_dict(stats) -> dict:
    return vars(stats) if isinstance(stats, types.SimpleNamespace) \
        else dataclasses.asdict(stats)


def assert_same_search(a, b, atol=ATOL):
    """Equal keys and CommStats, objectives within ``atol``."""
    assert stats_dict(a.stats) == stats_dict(b.stats)
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


def assert_bitwise(a, b):
    assert_same_search(a, b, atol=0)
    ma, mb = a.extras["final_master"], b.extras["final_master"]
    assert list(ma) == list(mb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


class CardRule(TorchFunctionMode):
    """CUDA's one-device rule, emulated on the CPU for meshes that name
    ``cpu:1``, ``cpu:2``, ...: a tensor carries the index of the device
    it was put on (by ``.to`` or a factory's ``device=``; a device with
    no index leaves it as it was), ``.device`` reads that index back, and
    an operation whose tensor arguments carry two indices raises, as
    CUDA does for tensors on two cards.  Tensors made before the mode
    carry no index until ``on_card`` gives them one."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__self__", None) is torch.Tensor.device:
            index = getattr(args[0], "card", None)
            return func(*args) if index is None else \
                torch.device("cpu", index)
        if func is torch.Tensor.to:
            dev = kwargs.get("device", next(
                (a for a in args[1:] if isinstance(a, (str, torch.device))),
                None))
            index = getattr(args[0], "card", None) if dev is None \
                else torch.device(dev).index
        else:
            found = {getattr(t, "card", None)
                     for t in tree_flatten((args, kwargs))[0]
                     if isinstance(t, torch.Tensor)}
            if kwargs.get("device") is not None:
                found.add(torch.device(kwargs["device"]).index)
            found.discard(None)
            if len(found) > 1:
                name = getattr(func, "__name__", func)
                raise RuntimeError(f"{name}: tensors on the devices "
                                   f"cpu:{sorted(found)}")
            index = next(iter(found), None)
        out = func(*args, **kwargs)
        if index is not None:
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    o.card = index
        return out


def on_card(tree, index: int):
    """A copy of ``tree`` whose tensors carry ``index`` (``CardRule``)."""
    leaves, spec = tree_flatten(tree)
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.clone()
            leaf.card = index
        out.append(leaf)
    return tree_unflatten(out, spec)


def fused_bound(generations: int) -> int:
    """Fused dispatches of a RealTimeNas run on the torch route: two
    train_fill in generation 1, then one a generation, and one eval each."""
    return 2 * generations + 1


# ---------------------------------------------------------------------------
# fixtures: the JAX package, its subprocess, the port's engine runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX package in process, imported here so that a machine without
    it (the card's) still runs the card-only case."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config, get_shape
    from repro.launch import policy as ref_policy
    from repro.launch import sharding as ref_sharding, specs as ref_specs
    from repro.models import moe as ref_moe
    from repro.models import transformer as ref_tr
    return types.SimpleNamespace(
        jax=jax, get_config=ref_get_config, get_shape=get_shape,
        policy=ref_policy, sharding=ref_sharding, specs=ref_specs,
        moe=ref_moe, tr=ref_tr)


@pytest.fixture(scope="module", autouse=True)
def ref_sub(tmp_path_factory):
    """The JAX subprocess, started as the module begins so that it runs
    beside the port's runs; ``.result()`` waits for what it wrote.  Not
    started where there is no JAX (the card's machine)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    # LLVM at -O0: at these sizes the process is compiling most of the
    # time, and -O0 takes it from 47 s to 32 s; its results move by
    # 1e-7 at most (the MoE's y; the master 1.2e-7), far inside the
    # limits below
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_force_"
                          "host_platform_device_count=4 --xla_backend_"
                          "optimization_level=0").strip(),
               PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    done = {}

    def result():
        if not done:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + stderr
            with open(out, "rb") as f:     # written by REF_SCRIPT above
                done.update(pickle.load(f))
        return done

    yield types.SimpleNamespace(result=result)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def own():
    """The port's CIFAR smoke API from its own init (no JAX)."""
    return cnn_supernet_api(get_config("cifar-supernet", smoke=True))


@pytest.fixture(scope="module")
def ref_runs(own, ref_sub):
    """The JAX package's fused mesh run on one CPU device (in the
    subprocess), and the port's 1-way CPU mesh on the torch route from
    the JAX package's init carried across."""
    data = ref_sub.result()
    init = data["init"]
    api = dataclasses.replace(own, init=lambda g: params_from_reference(init))
    ref_result = types.SimpleNamespace(
        reports=[types.SimpleNamespace(**r) for r in data["reports"]],
        stats=types.SimpleNamespace(**data["stats"]),
        extras={"final_master": data["master"]})
    ours = run(api, tiny_clients(4, 240), mesh=1, aggregate_backend="torch",
               population=4, **RUN)
    return (ref_result, data["dispatches"]), ours


@pytest.fixture(scope="module")
def port_runs(own):
    """The port's fused runs on the CPU from its own init."""
    clients = tiny_clients(4, 240)
    out = {}
    for route in ("torch", "kernel"):
        kw = dict(RUN, population=4, aggregate_backend=route)
        out["vmap", route] = run(own, clients, backend="vmap", **kw)
        out[1, route] = run(own, clients, mesh=1, **kw)
    out[8, "kernel"] = run(own, clients, mesh=8, population=4,
                           aggregate_backend="kernel", **RUN)
    padded = dict(RUN, population=3, aggregate_backend="torch")
    out["vmap", "pop3"] = run(own, clients, backend="vmap", **padded)
    for n in (4, 8):
        out[n, "pop3"] = run(own, clients, mesh=n, **padded)
    return out


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------

def test_make_host_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


def test_host_mesh_of_listed_devices():
    mesh = make_host_mesh(["cpu"] * 8)
    assert mesh.axis_names == ("data", "model")
    assert dict(mesh.shape) == {"data": 8, "model": 1} and mesh.size == 8
    assert mesh.devices.shape == (8, 1) and not mesh.abstract
    assert mesh.axis_devices(data_axes(mesh)) == [torch.device("cpu")] * 8
    assert data_axes(mesh) == fsdp_axes(mesh) == ("data",)
    assert mesh_axis_size(mesh, "data") == 8
    assert mesh_axis_size(mesh, ("data", "model")) == 8


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_is_abstract(multi_pod, shape, axes):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.abstract and mesh.devices is None
    assert tuple(mesh.shape.values()) == shape and mesh.axis_names == axes
    assert data_axes(mesh) == axes[:-1]
    assert mesh_axis_size(mesh, data_axes(mesh)) == int(np.prod(shape[:-1]))


def test_mesh_backend_refuses_an_abstract_mesh(own):
    clients = tiny_clients(4, 240)
    cfg = RunConfig(device="cpu", backend="mesh")
    with pytest.raises(ValueError, match="abstract"):
        MeshBackend(own, clients, cfg, mesh=make_production_mesh())
    # and a mesh whose devices are not RunConfig.device's type
    with pytest.raises(ValueError, match="does not match"):
        MeshBackend(own, clients, cfg,
                    mesh=Mesh((1, 1), ("data", "model"), ["meta"]))


def test_collectives():
    """One device: each collective hands its input back (no copy).  N
    devices: psum adds in device order, all_gather concatenates, and
    all_to_all sends block i of every device to device i."""
    a = {"w": torch.arange(6.0).reshape(2, 3)}
    assert psum([a]) is a and all_gather([a]) is a
    xs = [torch.arange(8.0).reshape(2, 4)]
    assert all_to_all(xs, 0, 1)[0] is xs[0]
    parts = [{"w": torch.full((2,), float(i))} for i in range(3)]
    assert torch.equal(psum(parts)["w"], torch.full((2,), 3.0))
    assert torch.equal(all_gather(parts)["w"],
                       torch.tensor([0.0, 0, 1, 1, 2, 2]))
    xs = [torch.arange(4.0).reshape(2, 2) + 10 * i for i in range(2)]
    out = all_to_all(xs, split_dim=0, concat_dim=1)
    assert torch.equal(out[0], torch.tensor([[0.0, 1, 10, 11]]))
    assert torch.equal(out[1], torch.tensor([[2.0, 3, 12, 13]]))
    back = all_to_all(out, split_dim=1, concat_dim=0)
    assert all(torch.equal(b, x) for b, x in zip(back, xs))


# ---------------------------------------------------------------------------
# the engine against the port's vmap backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["torch", "kernel"])
def test_one_way_mesh_is_vmap_bit_for_bit(port_runs, route):
    vmap, vmap_dispatches = port_runs["vmap", route]
    ours, dispatches = port_runs[1, route]
    assert_bitwise(vmap, ours)
    # the kernel route: one train_uploads call per bucket (1) and one K1
    # per bucket, 3 train_fill; vmap's one uploads call equals it here
    assert dispatches == vmap_dispatches == fused_bound(2) + (
        3 if route == "kernel" else 0)
    assert ops.LAUNCHES["fill_aggregate"] == 0      # CPU: plain version


@pytest.mark.parametrize("n", [4, 8])
def test_padded_meshes_match_vmap(port_runs, n):
    """Population 3 on 4 and 8 devices: the groups pad with weight-0
    rows; the float32 sums are added per device, then across devices."""
    vmap, _ = port_runs["vmap", "pop3"]
    ours, dispatches = port_runs[n, "pop3"]
    assert_same_search(vmap, ours)
    assert master_diff(vmap.extras["final_master"],
                       ours.extras["final_master"]) <= ATOL
    assert dispatches == fused_bound(2)


def test_fused_kernel_route_dispatches_on_eight_devices(port_runs):
    vmap, _ = port_runs["vmap", "kernel"]
    ours, dispatches = port_runs[8, "kernel"]
    assert_same_search(vmap, ours)
    assert master_diff(vmap.extras["final_master"],
                       ours.extras["final_master"]) <= ATOL
    assert dispatches == fused_bound(2) + 3


def test_nonfused_dispatches_constant_in_clients_and_below_vmap(own):
    """Non-fused, one call per shape bucket and phase, whatever the
    number of clients, and fewer than non-fused ``vmap``'s
    (tests/test_engine.py's mesh case)."""
    kw = dict(RUN, population=4, generations=1, fused=False,
              aggregate_backend="torch")
    counts = {m: run(own, tiny_clients(m, 60 * m), mesh=2, **kw)[1]
              for m in (4, 8)}
    assert counts[4] == counts[8] == 3
    _, vmap = run(own, tiny_clients(8, 480), backend="vmap", **kw)
    assert counts[8] < vmap


def test_dropout_keeps_the_fused_bound(own):
    kw = dict(RUN, population=4, aggregate_backend="torch",
              client_sim=ClientSimConfig(dropout=0.3, seed=1))
    clients = tiny_clients()
    vmap, _ = run(own, clients, backend="vmap", **kw)
    ours, dispatches = run(own, clients, mesh=4, **kw)
    assert vmap.stats.wasted_down_bytes > 0
    assert_same_search(vmap, ours)
    assert master_diff(vmap.extras["final_master"],
                       ours.extras["final_master"]) <= ATOL
    assert dispatches == fused_bound(2)


@pytest.mark.parametrize("up,down", [("int8", "none"), ("topk:0.25", "cast")])
def test_codecs_ride_the_mesh(own, up, down):
    """A codec wraps the mesh backend as any other (tests/test_comm.py's
    backend parity): on one device bit for bit ``vmap``'s run."""
    kw = dict(RUN, population=4, aggregate_backend="torch", uplink_codec=up,
              downlink_codec=down)
    clients = tiny_clients(4, 240)
    vmap, _ = run(own, clients, backend="vmap", **kw)
    ours, _ = run(own, clients, mesh=1, **kw)
    assert_bitwise(vmap, ours)
    assert ours.stats.up_wire_bytes < ours.stats.up_bytes


@pytest.mark.parametrize("strategy,kw", [
    (OfflineNas, dict(population=2, generations=1)),
    (lambda: FedAvgBaseline(np.asarray([1, 0, 2, 3], np.int32)),
     dict(population=4, generations=2))], ids=["offline", "fedavg"])
def test_baselines_match_loop(own, strategy, kw):
    """The FedAvg paths on a 3-way mesh (2 individuals and 1 pad out to
    3) against the port's loop backend."""
    kw = dict(seed=1, lr0=0.01, aggregate_backend="torch", **kw)
    clients = tiny_clients(4, 240)
    loop, _ = run(own, clients, strategy=strategy(), backend="loop",
                  **kw)
    ours, dispatches = run(own, clients, mesh=3, strategy=strategy(),
                           **kw)
    assert_same_search(loop, ours)
    if "params" in loop.extras:
        assert master_diff(loop.extras["params"],
                           ours.extras["params"]) <= ATOL
    assert dispatches < run(own, clients, strategy=strategy(),
                            backend="loop", **kw)[1]


def test_lm_supernet_step_on_the_mesh_equals_vmap():
    """One generation of the tiny qwen supernet search: the mesh's run
    is ``vmap``'s bit for bit."""
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(**LM_TINY)
    api = make_api(cfg)
    x, y = make_lm_stream(0, 96, 32, cfg.vocab_size)
    clients = [ClientDataset(i, x[i * 24:(i + 1) * 24],
                             y[i * 24:(i + 1) * 24], batch=8, test_batch=8)
               for i in range(4)]
    kw = dict(seed=0, lr0=0.01, population=4, generations=1)
    vmap, _ = run(api, clients, backend="vmap", **kw)
    ours, _ = run(api, clients, mesh=1, **kw)
    assert_bitwise(vmap, ours)


def test_mesh_backend_on_the_default_cpu_mesh(own):
    """``backend="mesh"`` with no mesh builds ``make_host_mesh`` over
    ``RunConfig.device``: on the CPU one CPU device."""
    eng = FedEngine(own, tiny_clients(4, 240),
                    RunConfig(device="cpu", backend="mesh"))
    assert eng.backend.num_devices == 1
    assert eng.backend.shard_devices == [torch.device("cpu")]


@pytest.mark.parametrize("route,fused,strategy", [
    ("torch", True, None), ("kernel", False, None),
    ("torch", True, OfflineNas)], ids=["torch-fused", "kernel", "offline"])
def test_mesh_of_distinct_devices(own, route, fused, strategy):
    """A mesh of cpu:1 and cpu:2 under ``CardRule``, the engine on cpu:0
    (a mesh of several cards need not start at the engine's): no
    operation mixes two devices, and the run is the same mesh's on one
    repeated device bit for bit."""
    kw = dict(seed=0, lr0=0.01, population=3, generations=2,
              aggregate_backend=route, fused=fused)
    if strategy is OfflineNas:
        kw.update(population=2, generations=1)
    clients = tiny_clients(4, 240)

    def go(device, devices):
        cfg = RunConfig(device=device, **kw)
        backend = MeshBackend(own, clients, cfg,
                              mesh=make_host_mesh(devices))
        return FedEngine(own, clients, cfg, backend=backend,
                         strategy=strategy and strategy()).run()

    want = go("cpu", ["cpu"] * 2)
    with CardRule():
        got = go("cpu:0", ["cpu:1", "cpu:2"])
    assert_same_search(want, got, atol=0)
    for name in ("final_master", "params"):
        if name in want.extras:
            assert all(torch.equal(want.extras[name][k], got.extras[name][k])
                       for k in want.extras[name])


def test_mesh_probe_on_one_cpu_device(capsys):
    """``launch/mesh_probe`` on one CPU device: the client update from
    cloned views equals the one from fresh leaves, and with one device
    there are no runs to compare; it prints what it returns."""
    from repro_torch.launch import mesh_probe
    out = mesh_probe.main(["--devices", "cpu"])
    assert out["devices"] == ["cpu"] and out["runs"] == {}
    assert out["align"]["cloned views"] == 0.0
    assert 0.0 <= out["align"]["views"] < 1e-3
    assert json.loads(capsys.readouterr().out) == out


def test_vmap_backend_is_unchanged_without_padding(own):
    """The padding hook is off for ``vmap``: its buckets carry exactly
    the groups it was given."""
    clients = tiny_clients(4, 240)
    backend = VmapBackend(own, clients, RunConfig(device="cpu"))
    keys = [np.ones(4, np.int32), np.zeros(4, np.int32)]
    (karr, xb, yb, w), = backend._group_bucket_arrays(
        keys, [np.array([0, 1]), np.array([2, 3])], 4.0)
    assert karr.shape == (2, 4) and xb.shape[:2] == (2, 2)
    mesh = MeshBackend(own, clients, RunConfig(device="cpu"),
                       mesh=cpu_mesh(3))
    (ks, xs, ys, ws), = mesh._group_bucket_arrays(
        keys, [np.array([0, 1]), np.array([2, 3])], 4.0)
    assert [k.shape[0] for k in ks] == [1, 1, 1]
    np.testing.assert_array_equal(np.concatenate(ks)[:2], karr)
    assert not np.concatenate(ks)[2].any() and not ws[2].any()
    np.testing.assert_array_equal(np.concatenate(ws)[:2], w)


# ---------------------------------------------------------------------------
# the MoE's expert-parallel path and the pinned decode
# ---------------------------------------------------------------------------

def moe_inputs():
    cfg = get_config(MOE_ARCH, smoke=True)
    x = np.random.default_rng(0).standard_normal(
        MOE_X + (cfg.d_model,)).astype(np.float32)
    return cfg, torch.from_numpy(x)


def under_mesh(mesh, fn):
    policy.set_mesh(mesh)
    try:
        return fn()
    finally:
        policy.set_mesh(None)


@pytest.fixture(scope="module")
def moe_trivial(ref):
    """The JAX package's ``moe_apply`` under a registered (1, 1) mesh, in
    process (``jit`` inside ``with mesh``, tests/test_moe.py's way), from
    its own init."""
    jax = ref.jax
    jcfg = ref.get_config(MOE_ARCH, smoke=True)
    jp = ref.moe.moe_init(jax.random.PRNGKey(0), jcfg)
    _, x = moe_inputs()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref.policy.set_mesh(mesh)
    try:
        with mesh:
            y, aux = jax.jit(lambda p_, x_: ref.moe.moe_apply(p_, x_, jcfg))(
                jp, x.numpy())
    finally:
        ref.policy.set_mesh(None)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return params, np.asarray(y), float(aux)


def test_expert_parallel_moe_on_a_trivial_mesh(moe_trivial, monkeypatch):
    """(1, 1): the JAX package's within its limits, the port's gather
    path within 1e-7, and no K5 even on the kernel route (the JAX
    package's body never calls its expert_gemm)."""
    params, y_ref, aux_ref = moe_trivial
    cfg, x = moe_inputs()

    def no_k5(*args, **kwargs):
        raise AssertionError("the expert-parallel path called K5")

    gather_y, gather_aux = moe.moe_apply(params, x, cfg, backend="torch")
    monkeypatch.setattr(moe.kops, "expert_ffn", no_k5)
    y, aux = under_mesh(cpu_mesh(1), lambda: moe.moe_apply(
        params, x, cfg, backend="kernel"))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=MOE_Y, atol=MOE_Y)
    assert float(aux) == pytest.approx(aux_ref, rel=MOE_AUX)
    assert float((y - gather_y).abs().max()) <= 1e-7
    assert float(aux) == pytest.approx(float(gather_aux), rel=1e-6)


def test_expert_parallel_moe_gradient_equals_the_gather_path(moe_trivial):
    params, _, _ = moe_trivial
    cfg, x = moe_inputs()

    def grads(fn):
        p = {g: {n: v.clone().requires_grad_() for n, v in leaves.items()}
             for g, leaves in params.items()}
        xg = x.clone().requires_grad_()
        y, aux = fn(p, xg)
        (y.square().sum() + aux).backward()
        return [xg.grad] + [v.grad for leaves in p.values()
                            for v in leaves.values()]

    want = grads(lambda p, xg: moe.moe_apply(p, xg, cfg, backend="torch"))
    got = grads(lambda p, xg: under_mesh(cpu_mesh(1), lambda: moe.moe_apply(
        p, xg, cfg)))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)], ids=str)
def test_expert_parallel_moe_on_distinct_devices(shape):
    """A mesh of cpu:1 ... cpu:4 under ``CardRule``, the caller's tensors
    on cpu:0: the router, the experts and ``ff_mask`` reach each device
    that uses them, y and aux come back to the caller's device, and both
    are the same mesh's on one repeated device bit for bit."""
    cfg, x = moe_inputs()
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    ff = cfg.moe_d_ff or cfg.d_ff
    for ff_mask in (None, (torch.arange(ff) < ff // 2).float()):
        want = under_mesh(Mesh(shape, ("data", "model"), ["cpu"] * 4),
                          lambda: moe.moe_apply(params, x, cfg,
                                                ff_mask=ff_mask))
        p, xc, m = on_card((params, x, ff_mask), 0)
        mesh = Mesh(shape, ("data", "model"),
                    [f"cpu:{i}" for i in range(1, 5)])
        with CardRule():
            y, aux = under_mesh(mesh, lambda: moe.moe_apply(p, xc, cfg,
                                                            ff_mask=m))
        assert y.card == aux.card == 0
        assert torch.equal(y, want[0]) and torch.equal(aux, want[1])


@pytest.fixture(scope="module", params=[(a, d) for a in DECODE_ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def replayed(request, ref):
    """The decode replay (``prefill_cache``, then one ``decode_step``) of
    DECODE_TOKENS under a (1, 1) mesh in both packages, from the JAX
    package's init, and the port's without a mesh."""
    jax = ref.jax
    arch, dtype = request.param
    jcfg = ref.get_config(arch, smoke=True).replace(dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jp = ref.tr.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=DECODE_TOKENS).astype(np.int32)
    s = DECODE_TOKENS[1]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    def ref_replay(p, t):
        cache = ref.tr.prefill_cache(p, jcfg, t[:, :-1], cache_len=s)
        return ref.tr.decode_step(p, jcfg, t[:, -1:], cache)[0]

    ref.policy.set_mesh(mesh)
    try:
        with mesh:
            want = jax.jit(ref_replay)(jp, toks)
    finally:
        ref.policy.set_mesh(None)
    want = np.asarray(want.astype(np.float32))

    def replay():
        with torch.inference_mode():
            t = torch.from_numpy(toks).long()
            c = tr.prefill_cache(params, cfg, t[:, :-1], cache_len=s)
            return tr.decode_step(params, cfg, t[:, -1:], c)[0].float()

    return dtype, want, under_mesh(cpu_mesh(1), replay).numpy(), \
        replay().numpy()


def test_pinned_decode_matches_reference(replayed):
    """float32 within 1e-6; bf16 within one bf16 step (BF16_STEP): the
    probabilities are rounded to V's dtype on both sides.  Without the
    mesh the bf16 replay differs (the pinned path ran); in float32 the
    two paths are one."""
    dtype, want, ours, plain = replayed
    gap = float(np.abs(ours - want).max())
    if dtype == "float32":
        assert gap <= 1e-6
        assert np.array_equal(ours, plain)
    else:
        assert gap <= BF16_STEP
        assert float(np.abs(ours - plain).max()) > 0.0


def test_pinned_attention_matches_reference(ref):
    """The pinned decode attention alone, in bf16 on the same q, k, v
    (GQA, a masked tail), under a (1, 1) mesh in the JAX package: the
    port's is the JAX package's bit for bit.  With the probabilities
    left in float32 the port's moves 40 % of the outputs, by up to
    0.0078 (measured), so this holds the rounding to V's dtype."""
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.models import attention as ref_att
    from repro_torch.models import attention as att
    jax, jnp = ref.jax, ref.jax.numpy
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 1, 8, 32)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 64, 2, 32)).astype(np.float32)
    mask = np.arange(64)[None, None, :] < 50
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    hd = NamedSharding(mesh, PartitionSpec(None, None, None, "model"))
    with mesh:
        want = jax.jit(lambda *a: ref_att._attend_decode_pinned(
            *a, jnp.asarray(mask), None, hd))(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ours = att._attend_decode_pinned(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# launch/sharding.py: the specs of every architecture at full size
# ---------------------------------------------------------------------------

def assert_specs_match(jspec, spec, stacked=0):
    """The port's spec tree against the JAX package's: a list level of
    the port (per-layer dicts) is a leading stacked axis of the JAX
    package's leaves, whose entry must be None and is dropped."""
    if isinstance(spec, list):
        for item in spec:
            assert_specs_match(jspec, item, stacked + 1)
    elif isinstance(spec, dict):
        assert set(spec) == set(jspec)
        for k in spec:
            assert_specs_match(jspec[k], spec[k], stacked)
    else:
        entries = tuple(jspec)
        assert entries[:stacked] == (None,) * stacked
        assert entries[stacked:] == spec


@pytest.fixture(scope="module")
def arch_trees(ref):
    """Per architecture of ``ARCH_IDS``: the JAX package's abstract params
    and decode caches, and the port's on the meta device."""
    from repro.configs import ARCH_ALIASES, ARCH_IDS
    names = {v: k for k, v in ARCH_ALIASES.items()}
    out = {}
    for arch in ARCH_IDS:
        jcfg, cfg = ref.get_config(arch), get_config(names[arch])
        params = specs.abstract_params(cfg)     # on meta: nothing allocated
        jparams = ref.specs.abstract_params(jcfg)
        enc = cfg.num_prefix if cfg.family == "audio" else 0
        caches = []
        for shape_name in CACHE_SHAPES:
            shape = ref.get_shape(shape_name)
            b, c = shape.global_batch, ref.specs.cache_len(jcfg, shape)
            caches.append((b, ref.jax.eval_shape(
                lambda: ref.tr.init_cache(jparams, jcfg, b, c,
                                          enc_len=enc)),
                tr.init_cache(params, cfg, b, c, enc_len=enc)))
        out[arch] = (jparams, params, caches)
    return out


@pytest.mark.parametrize("shape,axes", SPEC_MESHES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
def test_specs_match_reference(ref, arch_trees, shape, axes):
    from jax.sharding import AbstractMesh
    jmesh, mesh = AbstractMesh(shape, axes), Mesh(shape, axes)
    assert len(arch_trees) == 10
    for arch, (jparams, params, caches) in arch_trees.items():
        assert_specs_match(ref.sharding.param_specs(jmesh, jparams),
                           sharding.param_specs(mesh, params))
        for batch, jcache, cache in caches:
            assert_specs_match(ref.sharding.cache_specs(jmesh, jcache, batch),
                               sharding.cache_specs(mesh, cache, batch))
    for batch in (1, 3, 8, 16, 128, 512):
        for ndim in (1, 2, 3):
            assert tuple(ref.sharding.batch_spec(jmesh, batch, ndim)) == \
                sharding.batch_spec(mesh, batch, ndim)


# ---------------------------------------------------------------------------
# against the JAX subprocess (last: it runs beside everything above)
# ---------------------------------------------------------------------------

def test_one_way_mesh_matches_reference(ref, ref_runs):
    jax = ref.jax
    (ref_result, ref_dispatches), (ours, dispatches) = ref_runs
    assert_same_search(ref_result, ours)
    for a, b in zip(ref_result.reports, ours.reports):
        np.testing.assert_array_equal(a.best_key, b.best_key)
        np.testing.assert_array_equal(a.knee_key, b.knee_key)
    gap = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
        jax.tree.leaves(ref_result.extras["final_master"]),
        jax.tree.leaves(params_to_reference(ours.extras["final_master"]))))
    assert gap <= MASTER_ATOL
    assert dispatches == ref_dispatches == fused_bound(2)


@pytest.mark.parametrize("shape", SUB_MESHES, ids=str)
def test_expert_parallel_moe_on_four_devices(ref_sub, shape):
    """(2, 2) and (1, 4): the forced 4-device JAX run's y and aux, with
    the per-slice capacity drops that set both apart from the gather
    path's."""
    data = ref_sub.result()
    params = {g: {n: torch.from_numpy(v) for n, v in leaves.items()}
              for g, leaves in data["moe_params"].items()}
    y_ref, aux_ref = data["moe"][shape]
    cfg, x = moe_inputs()
    y, aux = under_mesh(Mesh(shape, ("data", "model"), ["cpu"] * 4),
                        lambda: moe.moe_apply(params, x, cfg))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=MOE_Y, atol=MOE_Y)
    assert float(aux) == pytest.approx(aux_ref, rel=MOE_AUX)
    gather_y, gather_aux = moe.moe_apply(params, x, cfg, backend="torch")
    assert float((y - gather_y).abs().max()) > 0.05
    assert abs(float(aux) - float(gather_aux)) > 1e-3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_device_mesh_kernel_route_is_vmap_on_the_card(cuda):
    """On the card the kernel route (K1, the last launch in place) of a
    one-device mesh is ``vmap``'s bit for bit, with its dispatches."""
    own = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    clients = tiny_clients()
    cfg = RunConfig(device="cuda", population=4, aggregate_backend="kernel",
                    **RUN)
    out = {}
    for name in ("vmap", "mesh"):
        backend = MeshBackend(own, clients, cfg,
                              mesh=make_host_mesh(["cuda:0"])) \
            if name == "mesh" else None
        eng = FedEngine(own, clients, dataclasses.replace(cfg, backend=name),
                        backend=backend)
        out[name] = (eng.run(), eng.backend.dispatches)
    torch.cuda.synchronize()
    assert_bitwise(out["vmap"][0], out["mesh"][0])
    assert out["vmap"][1] == out["mesh"][1] == fused_bound(2) + 3


@pytest.mark.cuda
def test_mesh_over_every_card(cuda):
    """With two or more cards ``make_host_mesh()`` names each once.  From
    one fresh master, a ``train_fill`` on each route and an evaluation
    over every card equal the same mesh's on cuda:0 repeated, the master
    back on cuda:0; the expert-parallel MoE on every split of the cards
    equals cuda:0's.  Whole runs are not compared: a master that K1
    wrote is a set of views into its flat output, at addresses cuDNN
    picks other convolutions for than the aligned copies on the other
    cards, so from the second aggregation on those cards train a few ulp
    apart (ROADMAP queue 3)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    own = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    clients = tiny_clients()
    master = {k: v.cuda() for k, v in
              own.init(torch.Generator().manual_seed(0)).items()}
    keys = list(np.random.default_rng(0).integers(
        0, 4, size=(4, own.num_blocks)).astype(np.int32))
    groups = [np.arange(2 * g, 2 * g + 2) for g in range(4)]
    for route in ("torch", "kernel"):
        cfg = RunConfig(device="cuda", aggregate_backend=route, **RUN)
        out = []
        for devs in (None, ["cuda:0"] * n):
            backend = MeshBackend(own, clients, cfg,
                                  mesh=make_host_mesh(devs))
            out.append((backend.train_fill(master, keys, groups, 0.01),
                        backend.eval_shared(master, keys,
                                            list(range(len(clients))))))
        torch.cuda.synchronize()
        (filled, rates), (filled1, rates1) = out
        assert {t.device for t in filled.values()} == {torch.device(
            "cuda", 0)}
        assert master_diff(filled, filled1) <= 1e-6
        np.testing.assert_array_equal(rates, rates1)
    cfg, x = moe_inputs()
    x = x.cuda()
    params = {g: {k: v.cuda() for k, v in leaves.items()} for g, leaves in
              moe.moe_init(torch.Generator().manual_seed(0), cfg).items()}
    ff = cfg.moe_d_ff or cfg.d_ff
    ff_mask = (torch.arange(ff, device="cuda") < ff // 2).float()
    shapes = [(1, n), (n, 1)] + ([(2, n // 2)] if n % 2 == 0 and n > 2
                                 else [])
    for shape, mask in ((a, b) for a in shapes for b in (None, ff_mask)):
        (y, aux), (y1, aux1) = (
            under_mesh(Mesh(shape, ("data", "model"), devs),
                       lambda: moe.moe_apply(params, x, cfg, ff_mask=mask))
            for devs in ([f"cuda:{i}" for i in range(n)], ["cuda:0"] * n))
        assert y.device == aux.device == x.device
        assert float((y - y1).abs().max()) <= 1e-6
        assert abs(float(aux) - float(aux1)) <= 1e-6
