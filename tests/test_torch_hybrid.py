"""The hybrid family of repro_torch (zamba2-2.7b: Mamba2 layers and one
shared attention+MLP block applied after every ``attn_every``-th layer,
with a KV cache per application point) against the JAX package on the
CPU.

The smoke config is cut to 4 layers at ``attn_every`` 2, so the shared
block fires twice (after layers 1 and 3) and decode keeps two of its
caches.  Weights are the port's init, carried to the JAX package with
``convert`` (the JAX package's own init takes seconds); tokens are made
with numpy.  Each JAX run is made once, in
a module fixture.  Limits (float32): logits, caches and the supernet's
logits within 1e-4, as ``tests/test_torch_models.py``; one SGD step's
loss within 1e-6 relative and its parameters within 1e-6, as
``tests/test_torch_train.py``; the bridge and the counts exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import flops as ref_flops  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference  # noqa: E402
from repro_torch.core import flops, lm_supernet_api  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ARCH = "zamba2-2.7b"
CUT = dict(num_layers=4)          # attn_every 2: two application points
B, S = 2, 24
TOL = 1e-4
SGD_TOL, LOSS_RTOL, LR = 1e-6, 1e-6, 0.1
# layers 1 and 3, where the shared block fires, as identities; every
# layer an identity; and a mixed key
SUPERNET_KEYS = [(1, 0, 2, 0), (0, 0, 0, 0), (3, 1, 0, 2)]


def configs(supernet=False):
    cfg = get_config(ARCH, smoke=True).replace(supernet=supernet, **CUT)
    jcfg = ref_get_config(ARCH, smoke=True).replace(supernet=supernet, **CUT)
    return cfg, jcfg


def close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's forward, prefill cache, supernet logits and one
    SGD step, from the port's init (as numpy, in the JAX package's
    layout)."""
    def init_of(cfg, seed):
        return lm_params_to_reference(cfg, tr.init_params(
            torch.Generator().manual_seed(seed), cfg))

    cfg, jcfg = configs()
    init = init_of(cfg, 0)
    jparams = jax.tree.map(jnp.asarray, init)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"init": init, "toks": toks,
           "logits": np.asarray(jtr.forward(jparams, jcfg,
                                            jnp.asarray(toks))[0]),
           "cache": jax.tree.map(np.asarray, jtr.prefill_cache(
               jparams, jcfg, jnp.asarray(toks), cache_len=S))}

    scfg, sjcfg = configs(supernet=True)
    out["supernet_init"] = init_of(scfg, 1)
    sparams = jax.tree.map(jnp.asarray, out["supernet_init"])
    fwd = jax.jit(lambda p, t, k: jtr.forward(p, sjcfg, t, choice_key=k)[0])
    out["supernet"] = {key: np.asarray(fwd(sparams, jnp.asarray(toks),
                                           jnp.asarray(key, jnp.int32)))
                       for key in SUPERNET_KEYS}

    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    step = jax.jit(jtrain.make_train_step(jcfg, optimizer="sgd", lr=LR))
    new, _, loss = step(jparams, jtrain.init_opt(jparams, "sgd"),
                        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(y)})
    out["train"] = (y, float(loss), jax.tree.map(np.asarray, new))
    return out


def port_params(ref, supernet=False):
    cfg, _ = configs(supernet)
    return cfg, lm_params_from_reference(
        cfg, ref["supernet_init" if supernet else "init"])


@pytest.mark.parametrize("backend", ["torch", "kernel", "chunked"])
def test_forward_matches_reference(ref, backend):
    cfg, params = port_params(ref)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    logits = tr.forward(params, cfg, torch.from_numpy(ref["toks"]),
                        backend=backend)
    close(logits, ref["logits"])
    assert all(n == 0 for n in ops.LAUNCHES.values())   # nothing on the CPU


def test_shared_block_fires_after_every_attn_every_th_layer(ref):
    """Without the shared block the logits move; with its application
    points after layers 1 and 3 they are the JAX package's (above), and
    a model of one application point is not."""
    cfg, params = port_params(ref)
    toks = torch.from_numpy(ref["toks"])
    assert [li for li in range(cfg.num_layers)
            if tr._shared_fires(cfg, li)] == [1, 3]
    once = tr.forward(params, cfg.replace(attn_every=4), toks)
    assert float((once - torch.tensor(ref["logits"])).abs().max()) > 1e-3


def test_decode_replay_matches_forward(ref):
    """``tests/test_models.py::test_hybrid_decode_matches_forward`` on the
    port: the last position's logits of a decode replay against the
    forward's (and the JAX package's)."""
    cfg, params = port_params(ref)
    toks = torch.from_numpy(ref["toks"])
    cache = tr.init_cache(params, cfg, B, S + 4)
    assert len(cache["shared"]) == cfg.num_layers // cfg.attn_every == 2
    for i in range(S):
        dec, cache = tr.decode_step(params, cfg, toks[:, i:i + 1], cache)
    full = tr.forward(params, cfg, toks)
    close(dec[:, 0], full[:, -1].numpy())
    close(dec[:, 0], ref["logits"][:, -1])
    assert cache["t"] == S


def test_prefill_cache_matches_reference(ref):
    """The SSM records of every layer and each application point's K/V
    ring (keys, values, stored positions) equal the JAX package's."""
    cfg, params = port_params(ref)
    cache = tr.prefill_cache(params, cfg, torch.from_numpy(ref["toks"]))
    jcache = ref["cache"]
    assert cache["t"] == int(jcache["t"]) == S
    for li, c_l in enumerate(cache["layers"]):
        assert sorted(c_l) == sorted(jcache["layers"])
        for name, t in c_l.items():
            close(t, jcache["layers"][name][li])
    assert len(cache["shared"]) == jcache["shared"]["k"].shape[0] == 2
    for idx, c in enumerate(cache["shared"]):
        for name in ("k", "v"):
            close(c[name], jcache["shared"][name][idx])
        assert c["pos"].tolist() == jcache["shared"]["pos"][idx].tolist()
    # the two application points hold different keys
    assert not torch.allclose(cache["shared"][0]["k"],
                              cache["shared"][1]["k"])


@pytest.mark.parametrize("key", SUPERNET_KEYS,
                         ids=["identity_at_shared", "all_identity", "mixed"])
@pytest.mark.parametrize("backend", ["torch", "kernel", "chunked"])
def test_supernet_forward_matches_reference(ref, key, backend):
    """The shared block fires by layer index, also after an identity
    layer (the JAX package's ``cond`` sits outside its ``switch``); an
    identity layer reads none of its branches."""
    cfg, params = port_params(ref, supernet=True)
    toks = torch.from_numpy(ref["toks"])
    sparse = {**params, "layers": [
        [b if i == k - 1 else None for i, b in enumerate(layer)]
        for layer, k in zip(params["layers"], key)]}
    logits = tr.forward(sparse, cfg, toks, choice_key=np.array(key),
                        backend=backend)
    close(logits, ref["supernet"][key])


@pytest.mark.parametrize("supernet", [False, True], ids=["plain", "supernet"])
def test_bridge_round_trip_is_exact(ref, supernet):
    """``shared`` is one unstacked dense block in both packages; a
    supernet's layers keep the ``(L, 3, ...)`` layout.  The port's own
    init has the bridge's names, shapes and dtypes."""
    cfg, params = port_params(ref, supernet)
    init = ref["supernet_init" if supernet else "init"]
    # the JAX package's own init has these names, shapes and dtypes
    shapes = jax.eval_shape(lambda k: jtr.init_params(k, configs(supernet)[1]),
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(init)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(shapes), jax.tree.leaves(init)))
    back = lm_params_to_reference(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    again = lm_params_from_reference(cfg, back)
    flat, flat2 = tr.flat_params(params), tr.flat_params(again)
    assert list(flat) == list(flat2)
    assert all(torch.equal(flat[k], flat2[k]) for k in flat)
    assert any(k.startswith("shared.attn.") for k in flat)
    fresh = tr.flat_params(tr.init_params(torch.Generator().manual_seed(0),
                                          cfg))
    assert sorted(fresh) == sorted(flat)
    assert all(fresh[k].shape == flat[k].shape
               and fresh[k].dtype == flat[k].dtype for k in flat)
    assert tr.flat_params(tr.nested_params(flat)).keys() == flat.keys()


def test_param_counts_match_reference(ref):
    """``core/flops.py`` counts the shared block once: equal to the JAX
    package's for the full and smoke configs, and to the entries of the
    port's init at smoke size but for the biases, which the analytic
    count leaves out: the hybrid's are the SSM's three causal
    convolutions', d_inner + 2 N a layer."""
    for smoke in (False, True):
        rcfg = ref_get_config(ARCH, smoke=smoke)
        cfg = get_config(ARCH, smoke=smoke)
        for active in (False, True):
            assert flops.model_params(cfg, active) == \
                ref_flops.model_params(rcfg, active)
        key = np.arange(cfg.num_layers) % 4
        assert flops.subnet_params(cfg, key) == \
            ref_flops.subnet_params(rcfg, key)
    assert flops.model_params(get_config(ARCH)) == 2_338_252_416
    cfg, params = port_params(ref)
    flat = tr.flat_params(params)
    biases = sum(t.numel() for k, t in flat.items() if k.endswith(".b"))
    assert biases == cfg.num_layers * (cfg.d_inner + 2 * cfg.ssm_state)
    assert flops.model_params(cfg) + biases == sum(
        t.numel() for t in flat.values())


def test_sgd_step_matches_reference(ref):
    """One SGD step: the shared block's gradient is summed over its two
    applications, as ``jax.grad`` sums it."""
    cfg, params = port_params(ref)
    y, jloss, jnew = ref["train"]
    step = train.make_train_step(cfg, optimizer="sgd", lr=LR)
    new, _, loss = step(params, train.init_opt(params, "sgd"),
                        {"tokens": torch.from_numpy(ref["toks"]),
                         "labels": torch.from_numpy(y)})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    got = lm_params_to_reference(cfg, new)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jnew),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=SGD_TOL,
                                   err_msg=str(path))
    moved = tr.flat_params(new)
    before = tr.flat_params(params)
    assert all(not torch.equal(moved[k], before[k])
               for k in moved if k.startswith("shared."))


def test_lm_supernet_api_still_refuses_the_hybrid():
    """As the JAX package's ``lm_supernet_api`` asserts its family is
    dense, moe or ssm; the hybrid supernet's forward runs (above)."""
    cfg, _ = configs(supernet=True)
    with pytest.raises(ValueError, match="dense, moe or ssm"):
        lm_supernet_api(cfg)
    assert dataclasses.asdict(cfg)["family"] == "hybrid"
