"""The LM supernet NAS path of repro_torch against the JAX package: the
paper's technique on a transformer supernet (``lm_supernet_api``,
``make_api``, the branch masks, ``supernet_trained_mask``, the
transformer counts, ``make_lm_stream`` and the weight bridge).

The whole slice: one JAX ``loop`` run of real-time NAS (population 4, 2
generations, lr0 0.01) on a tiny qwen supernet (d_model 64, d_ff 128,
vocab 128, 4 heads, 2 layers) over 4 clients of 24 sequences of 32
tokens, against the port's run on both Algorithm 3 routes from the same
initial master (the JAX package's init, carried over by the bridge):
keys, CommStats and ``train_passes`` equal, objectives within 1e-5,
masters within 1e-4 (measured on the CPU: 2.2e-8).  Per branch, for the
dense, moe and ssm families at smoke size: losses within 1e-5 and
logits within 1e-4 of the JAX package's (measured: 9.5e-7 and 3.9e-7),
one JAX compile per family since its choice key is traced.  Counts,
masks, the token stream and the bridge are exact.

An LM "error rate" is wrong tokens per sequence (the JAX package divides
the wrong-token count by batches x batch), so it can exceed 1; the port
keeps that for parity.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import flops as ref_flops  # noqa: E402
from repro.core import make_api as ref_make_api  # noqa: E402
from repro.data import make_lm_stream as ref_make_lm_stream  # noqa: E402
from repro.data.pipeline import ClientDataset as RefClientDataset  # noqa: E402,E501
from repro.engine import FedEngine as RefEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference  # noqa: E402
from repro_torch.core import aggregate, flops, lm_supernet_api, \
    make_api  # noqa: E402
from repro_torch.core.federated import client_update_fn  # noqa: E402
from repro_torch.core.supernet import SupernetAPI  # noqa: E402
from repro_torch.data import ClientDataset, make_lm_stream  # noqa: E402
from repro_torch.engine import FedEngine, RunConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

TINY = dict(supernet=True, d_model=64, d_ff=128, vocab_size=128,
            num_heads=4, num_kv_heads=4)
RUN = dict(population=4, generations=2, seed=0, lr0=0.01)
ROUTES = ("torch", "kernel")
MASTER_ATOL = 1e-4
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-4
FAMILIES = ["qwen1.5-0.5b", "granite-moe-1b-a400m", "mamba2-780m"]
# every branch of every layer, and one mixed key per layer count
KEYS = [(0, 0), (1, 1), (2, 2), (3, 3), (2, 0), (3, 1)]
FULL = {"qwen1.5-0.5b": (1_080_574_976, 463_913_984, 155_583_488),
        "mamba2-780m": (2_185_504_512, 779_989_248, 77_231_616),
        "granite-moe-1b-a400m": (3_903_213_568, 1_334_628_352,
                                 50_335_744)}


def lm_clients(stream, dataset, vocab, num_clients=4, seqs=96, seq_len=32):
    x, y = stream(0, seqs, seq_len, vocab)
    shard = seqs // num_clients
    return [dataset(i, x[i * shard:(i + 1) * shard],
                    y[i * shard:(i + 1) * shard], batch=8, test_batch=8)
            for i in range(num_clients)]


@pytest.fixture(scope="module")
def apis():
    """(JAX api, port api, port cfg, JAX init as numpy) on the tiny qwen
    supernet; the port's init is the JAX package's, bridged."""
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(**TINY)
    ref_api = ref_make_api(ref_get_config("qwen1.5-0.5b", smoke=True)
                           .replace(**TINY))
    init = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(0)))
    api = dataclasses.replace(
        make_api(cfg),
        init=lambda g: tr.flat_params(lm_params_from_reference(cfg, init)))
    return ref_api, api, cfg, init


@pytest.fixture(scope="module")
def runs(apis):
    ref_api, api, cfg, _ = apis
    ref = RefEngine(ref_api, lm_clients(ref_make_lm_stream, RefClientDataset,
                                        cfg.vocab_size),
                    RefRunConfig(backend="loop", aggregate_backend="xla",
                                 **RUN)).run()
    clients = lm_clients(make_lm_stream, ClientDataset, cfg.vocab_size)
    out = {route: FedEngine(api, clients, RunConfig(
        aggregate_backend=route, device="cpu", **RUN)).run()
        for route in ROUTES}
    return ref, out


def master_to_reference(cfg, master):
    return lm_params_to_reference(cfg, tr.nested_params(master))


@pytest.mark.parametrize("route", ROUTES)
def test_lm_nas_keys_and_objectives_match_reference(runs, route):
    ref, ours = runs[0], runs[1][route]
    assert len(ours.reports) == len(ref.reports) == 2
    for a, b in zip(ref.reports, ours.reports):
        assert len(a.parent_keys) == len(b.parent_keys)
        for ka, kb in zip(a.parent_keys, b.parent_keys):
            np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(a.best_key, b.best_key)
        np.testing.assert_array_equal(a.knee_key, b.knee_key)
        np.testing.assert_allclose(a.objs, b.objs, atol=1e-5)
        assert a.train_passes == b.train_passes
        assert (a.down_gb, a.up_gb) == (b.down_gb, b.up_gb)


@pytest.mark.parametrize("route", ROUTES)
def test_lm_nas_comm_stats_are_byte_identical(runs, route):
    ref, ours = runs[0], runs[1][route]
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(ours.stats)


@pytest.mark.parametrize("route", ROUTES)
def test_lm_nas_final_master_within_tolerance(apis, runs, route):
    cfg = apis[2]
    ref, ours = runs[0], runs[1][route]
    back = master_to_reference(cfg, ours.extras["final_master"])
    gap = max(float(np.abs(np.asarray(a) - b).max())
              for a, b in zip(jax.tree.leaves(ref.extras["final_master"]),
                              jax.tree.leaves(back)))
    assert gap <= MASTER_ATOL
    assert ops.LAUNCHES["fill_aggregate"] == 0     # CPU: the plain version


def test_lm_nas_run_invariants(runs):
    """``tests/test_lm_supernet_nas.py``'s run on the port: finite
    objectives, FLOPs spread across subnets, one client pass per client
    and generation after the first."""
    ours = runs[1]["kernel"]
    objs = ours.reports[-1].objs
    assert objs.shape == (8, 2) and np.isfinite(objs).all()
    assert len(np.unique(objs[:, 1])) > 1
    passes = [r.train_passes for r in ours.reports]
    assert passes[-1] - passes[0] == 4
    # per-sequence error rates: wrong tokens / sequences, up to 32 here
    assert objs[:, 0].max() > 1.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_nas_on_vmap_equals_loop(arch):
    """The batched backend runs the LM supernets too (the MoE's dispatch
    is out of place, so ``torch.func.vmap`` batches it): at smoke size
    its run is the loop backend's bit for bit, from the port's own
    init."""
    cfg = get_config(arch, smoke=True).replace(supernet=True)
    api = make_api(cfg)
    clients = lm_clients(make_lm_stream, ClientDataset, cfg.vocab_size)
    loop, vmap = (FedEngine(api, clients, RunConfig(
        backend=backend, device="cpu", **RUN)).run()
        for backend in ("loop", "vmap"))
    assert dataclasses.asdict(loop.stats) == dataclasses.asdict(vmap.stats)
    for a, b in zip(loop.reports, vmap.reports):
        np.testing.assert_array_equal(a.objs, b.objs)
        for ka, kb in zip(a.parent_keys, b.parent_keys):
            np.testing.assert_array_equal(ka, kb)
    m1, m2 = loop.extras["final_master"], vmap.extras["final_master"]
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_lm_payload_scales_with_key(apis):
    cfg, api = apis[2], apis[1]
    n = cfg.num_layers
    full = api.payload_params(np.ones(n, dtype=int))
    skip = api.payload_params(np.zeros(n, dtype=int))
    lite = api.payload_params(np.full(n, 3))
    assert skip < lite < full
    assert api.flops(np.zeros(n, dtype=int)) < api.flops(np.ones(n, dtype=int))
    ref_api = apis[0]
    assert api.master_params() == ref_api.master_params()
    assert api.key_bytes == ref_api.key_bytes
    for key in KEYS:
        assert api.payload_params(np.array(key)) == \
            ref_api.payload_params(np.array(key))
        assert api.flops(np.array(key)) == ref_api.flops(np.array(key))


def test_client_update_leaves_unselected_branches_bit_unchanged(apis):
    """Only the selected branch of each layer (plus embedding and final
    norm) is trained: every other leaf comes back as the master's own
    tensor, an identity layer's three branches included."""
    _, api, cfg, _ = apis
    master = api.init(None)
    x, y = make_lm_stream(3, 8, 16, cfg.vocab_size)
    xb = torch.from_numpy(x).reshape(2, 4, 16)
    yb = torch.from_numpy(y).reshape(2, 4, 16)
    key = np.array([0, 2])
    out = client_update_fn(api)(master, key, xb, yb, 0.1)
    mask = aggregate.supernet_trained_mask(master, key)
    for k, v in master.items():
        if float(mask[k]):
            assert not torch.equal(out[k], v), k
        else:
            assert out[k] is v, k


@pytest.mark.parametrize("arch", FAMILIES)
def test_per_branch_losses_and_logits_match_reference(arch):
    cfg = get_config(arch, smoke=True).replace(supernet=True)
    rcfg = ref_get_config(arch, smoke=True).replace(supernet=True)
    ref_api = ref_make_api(rcfg)
    ref_params = ref_api.init(jax.random.PRNGKey(1))
    api = make_api(cfg)
    params = tr.flat_params(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, ref_params)))
    x, y = make_lm_stream(5, 2, 16, cfg.vocab_size)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    @jax.jit
    def ref_fn(p, b, key):                  # one compile: the key is traced
        logits, _, _ = jtr.forward(p, rcfg, b["x"], choice_key=key)
        return ref_api.loss(p, b, key), logits

    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    outs = {}
    for key in KEYS:
        k = np.array(key)
        ref_loss, ref_logits = ref_fn(ref_params, batch,
                                      jnp.asarray(k, jnp.int32))
        loss = api.loss(params, tb, k)
        np.testing.assert_allclose(float(loss), float(ref_loss),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        for backend in ("torch", "kernel"):
            nested = tr.nested_params(params)
            logits = tr.forward(nested, cfg, tb["x"], choice_key=k,
                                backend=backend)
            np.testing.assert_allclose(logits.numpy(),
                                       np.asarray(ref_logits),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert int(api.error_count(params, tb, k)) == int(
            jnp.sum(jnp.argmax(ref_logits, -1) != batch["y"]))
        outs[key] = logits
    # the four uniform keys give four different models
    uniform = [outs[(b, b)] for b in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert float((uniform[i] - uniform[j]).abs().max()) > 1e-5


def test_supernet_branches_differ_and_identity_skips():
    """``tests/test_models.py::test_supernet_branches_differ_and_identity_
    skips`` on the port's own init."""
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(supernet=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(7))
    outs = {b: tr.forward(params, cfg, toks,
                          choice_key=np.full(cfg.num_layers, b))
            for b in range(4)}
    for i in range(4):
        for j in range(i + 1, 4):
            assert float((outs[i] - outs[j]).abs().max()) > 1e-5, (i, j)
    # all-identity == embedding -> final norm -> unembed
    p0 = {"embed": params["embed"], "final_ln": params["final_ln"],
          "layers": []}
    out0 = tr.forward(p0, cfg.replace(num_layers=0, supernet=False), toks)
    torch.testing.assert_close(outs[0], out0, rtol=1e-4, atol=1e-5)
    # an identity layer reads none of its branches
    mixed = [[None] * tr.N_BRANCHES, params["layers"][1]]
    torch.testing.assert_close(
        tr.forward({**params, "layers": mixed}, cfg, toks,
                   choice_key=np.array([0, 2])),
        tr.forward(params, cfg, toks, choice_key=np.array([0, 2])),
        rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_moe_supernet_branches_run_on_both_routes(backend):
    """Every branch of the MoE supernet on either route (the bottleneck
    on einsums on both, as the JAX package's), the aux loss summed over
    the layers that are not identities; on the CPU nothing launches."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        supernet=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((1, 8), dtype=torch.int64)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    for b in range(4):
        logits, aux = tr.forward(params, cfg, toks, backend=backend,
                                 choice_key=np.full(cfg.num_layers, b),
                                 return_aux=True)
        assert torch.isfinite(logits).all()
        assert (float(aux) == 0.0) == (b == 0)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_choice_key_is_checked():
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(supernet=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a choice_key"):
        tr.forward(params, cfg, toks)
    with pytest.raises(ValueError, match="choice key"):
        tr.forward(params, cfg, toks, choice_key=np.array([1, 4]))
    with pytest.raises(ValueError, match="not a supernet"):
        plain = get_config("qwen1.5-0.5b", smoke=True)
        tr.forward(tr.init_params(torch.Generator().manual_seed(0), plain),
                   plain, toks, choice_key=np.array([1, 1]))
    with pytest.raises(NotImplementedError, match="not decoded"):
        tr.decode_step(params, cfg, toks[:, :1], {"t": 0, "layers": []})



def test_make_api_dispatches_by_family(apis):
    cnn = make_api(get_config("cifar-supernet", smoke=True))
    assert isinstance(cnn, SupernetAPI)
    assert cnn.trained_mask is aggregate.cnn_trained_mask
    lm = apis[1]
    assert lm.trained_mask is aggregate.supernet_trained_mask
    with pytest.raises(ValueError, match="supernet=True"):
        make_api(get_config("qwen1.5-0.5b", smoke=True))


@pytest.mark.parametrize("key", [(0, 0), (1, 3), (2, 1), (3, 3)])
def test_supernet_trained_mask_matches_reference_after_the_bridge(apis, key):
    _, api, cfg, init = apis
    k = np.array(key)
    ref_mask = jax.tree.map(np.asarray,
                            ref_aggregate.supernet_trained_mask(init, k))
    # the reference's (L, 3, 1, ...) mask broadcast to its leaves, bridged
    full = jax.tree.map(lambda m, p: np.broadcast_to(m, p.shape).copy(),
                        ref_mask, init)
    bridged = tr.flat_params(lm_params_from_reference(cfg, full))
    ours = api.trained_mask(api.init(None), k)
    assert list(ours) == list(bridged)
    for name, m in ours.items():
        assert m.shape == () and m.dtype == torch.float32
        assert torch.equal(m.expand(bridged[name].shape), bridged[name]), name


@pytest.mark.parametrize("args", [(0, 96, 32, 128), (3, 5, 17, 1000),
                                  (7, 12, 256, 151936)])
def test_make_lm_stream_matches_reference(args):
    x, y = make_lm_stream(*args)
    rx, ry = ref_make_lm_stream(*args)
    assert x.dtype == rx.dtype == np.int32 and y.dtype == ry.dtype
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def ref_configs():
    from repro.configs.base import ARCH_ALIASES
    return sorted(a for a in ARCH_ALIASES if a != "cifar-supernet")


@pytest.mark.parametrize("arch", ref_configs())
def test_transformer_counts_match_reference(arch):
    """Every count for every branch, on the full configs of every
    architecture of the JAX package (the port's ``ModelConfig`` takes
    the same fields)."""
    rcfg = ref_get_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    for fn in ("attn_params", "mlp_params"):
        assert getattr(flops, fn)(cfg) == getattr(ref_flops, fn)(rcfg)
    if cfg.ssm_state:
        assert flops.ssm_params(cfg) == ref_flops.ssm_params(rcfg)
    for b in range(4):
        assert flops.layer_params(cfg, b) == ref_flops.layer_params(rcfg, b)
    for active in (False, True):
        assert flops.model_params(cfg, active) == \
            ref_flops.model_params(rcfg, active)
    rng = np.random.default_rng(0)
    for key in [np.zeros(cfg.num_layers, int), np.ones(cfg.num_layers, int),
                rng.integers(0, 4, cfg.num_layers)]:
        assert flops.subnet_params(cfg, key) == \
            ref_flops.subnet_params(rcfg, key)
    assert flops.train_flops(cfg, 4096) == ref_flops.train_flops(rcfg, 4096)
    assert flops.decode_flops(cfg, 8) == ref_flops.decode_flops(rcfg, 8)


@pytest.mark.parametrize("arch", sorted(FULL))
def test_supernet_master_counts(arch):
    cfg = get_config(arch).replace(supernet=True)
    api = lm_supernet_api(cfg)
    master, full, skip = FULL[arch]
    assert api.master_params() == master
    assert api.payload_params(np.ones(cfg.num_layers, int)) == full
    assert api.payload_params(np.zeros(cfg.num_layers, int)) == skip


def test_model_params_match_model_names():
    """``tests/test_flops.py``'s name check on the port's configs."""
    approx = {"qwen1.5-0.5b": 0.62e9, "mamba2-780m": 0.78e9}
    for arch, expect in approx.items():
        got = flops.model_params(get_config(arch))
        assert 0.55 * expect < got < 1.6 * expect, (arch, got, expect)


def test_moe_active_params_smaller():
    cfg = get_config("llama4-scout-17b-a16e")
    total = flops.model_params(cfg)
    active = flops.model_params(cfg, active_only=True)
    assert active < total
    assert total > 15e9
    assert active < 0.35 * total


@pytest.mark.parametrize("seed", range(5))
def test_subnet_params_bounded_by_full(seed):
    cfg = get_config("qwen1.5-0.5b")
    key = np.random.default_rng(seed).integers(0, 4, 24)
    sub = flops.subnet_params(cfg, key)
    full = flops.subnet_params(cfg, np.ones(24, dtype=int))
    assert sub <= flops.model_params(cfg)
    assert flops.subnet_params(cfg, np.zeros(24, dtype=int)) <= sub
    assert sub <= full or key.max() > 1


def test_train_flops_is_6nd():
    cfg = get_config("qwen1.5-0.5b")
    n = flops.model_params(cfg, active_only=True)
    assert flops.train_flops(cfg, 1000) == pytest.approx(6.0 * n * 1000)


@pytest.mark.parametrize("arch", FAMILIES)
def test_supernet_bridge_round_trip_is_exact(arch):
    cfg = get_config(arch, smoke=True).replace(supernet=True)
    rcfg = ref_get_config(arch, smoke=True).replace(supernet=True)
    ref = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(2),
                                                   rcfg))
    params = lm_params_from_reference(cfg, ref)
    assert [len(layer) for layer in params["layers"]] == \
        [tr.N_BRANCHES] * cfg.num_layers
    back = lm_params_to_reference(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    flat = tr.flat_params(params)
    again = tr.flat_params(lm_params_from_reference(
        cfg, master_to_reference(cfg, flat)))
    assert list(again) == list(flat)
    assert all(torch.equal(flat[k], again[k]) for k in flat)
    # the port's own init has the bridge's names, shapes and dtypes (the
    # bridge orders names as the JAX package's sorted dicts)
    fresh = make_api(cfg).init(torch.Generator().manual_seed(0))
    assert sorted(fresh) == sorted(flat)
    assert all(fresh[k].shape == flat[k].shape
               and fresh[k].dtype == flat[k].dtype for k in flat)
