"""repro_torch CIFAR CNN supernet against the JAX package.

The weights come from the reference's own init, carried across with
``repro_torch.convert``.  Forward logits and loss gradients are held
within ATOL = 1e-5 for every branch of every block: measured on the CPU
the gap is <= 5e-7 (the two packages sum convolutions and BN statistics
in different orders).  The counts (payload, master size, MACs, key
bytes) and trained masks must be equal.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import make_api  # noqa: E402
from repro.core.aggregate import cnn_trained_mask as ref_mask  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference, \
    params_to_reference  # noqa: E402
from repro_torch.core import cnn_supernet_api  # noqa: E402
from repro_torch.core.aggregate import cnn_trained_mask  # noqa: E402
from repro_torch.models.cnn import BRANCH_NAMES, CnnSupernet  # noqa: E402
from torch.func import functional_call  # noqa: E402

ATOL = 1e-5
KEYS = ([np.full(4, b, np.int32) for b in range(4)]
        + [np.random.default_rng(s).integers(0, 4, 4).astype(np.int32)
           for s in range(3)])


@pytest.fixture(scope="module")
def setup():
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=True))
    api = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    ref_params = ref_api.init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    # one compilation each: the key is traced, as in the JAX package
    ref_fwd = jax.jit(ref_cnn.forward)
    ref_loss_grad = jax.jit(jax.value_and_grad(ref_api.loss))
    return ref_api, api, ref_params, params, x, y, ref_fwd, ref_loss_grad


def test_bridge_round_trip_is_bit_exact(setup):
    _, api, ref_params, params = setup[:4]
    back = params_to_reference(params)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, ref_params))
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = params_from_reference(back)
    assert list(again) == list(params)
    assert all(torch.equal(again[k], params[k]) for k in params)
    # the bridge emits the module's own names, shapes and order
    fresh = api.init(torch.Generator().manual_seed(0))
    assert list(fresh) == list(params)
    assert all(fresh[k].shape == params[k].shape for k in params)


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "".join(map(str, k)))
def test_forward_and_grad_match_reference(setup, key):
    ref_api, api, ref_params, params, x, y, ref_fwd, ref_loss_grad = setup
    ref_logits = np.asarray(ref_fwd(ref_params, jnp.asarray(x),
                                    jnp.asarray(key)))
    net = CnnSupernet(get_config("cifar-supernet", smoke=True))
    with torch.no_grad():
        logits = functional_call(net, params, (torch.from_numpy(x), key))
    assert logits.shape == (6, 10)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL, rtol=0)

    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    ref_loss, ref_g = ref_loss_grad(ref_params, batch, jnp.asarray(key))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = api.loss(leaves, {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)}, key)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=ATOL)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    g = {k: (t if t is not None else torch.zeros_like(leaves[k]))
         for k, t in zip(leaves, grads)}
    for a, b in zip(jax.tree.leaves(ref_g),
                    jax.tree.leaves(params_to_reference(g))):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL, rtol=0)
    # leaves outside the selected subnet get no gradient at all
    for k, t in zip(leaves, grads):
        if k.startswith("blocks."):
            _, i, nm, _ = k.split(".")
            if nm != BRANCH_NAMES[key[int(i)]]:
                assert t is None, k


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_counts_match_reference(smoke):
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=smoke))
    api = cnn_supernet_api(get_config("cifar-supernet", smoke=smoke))
    assert api.master_params() == ref_api.master_params()
    assert api.key_bytes == ref_api.key_bytes
    assert api.num_blocks == ref_api.num_blocks
    nb = api.num_blocks
    keys = [np.full(nb, b, np.int32) for b in range(4)]
    keys += [np.random.default_rng(s).integers(0, 4, nb).astype(np.int32)
             for s in range(10)]
    for k in keys:
        assert api.payload_params(k) == ref_api.payload_params(k)
        assert api.flops(k) == ref_api.flops(k)
    if not smoke:
        assert api.master_params() == 26_119_059


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "".join(map(str, k)))
def test_trained_mask_matches_reference(setup, key):
    ref_params, params = setup[2:4]
    mask = cnn_trained_mask(params, key)
    assert list(mask) == list(params)
    as_ref = params_to_reference({k: m.reshape(1) for k, m in mask.items()})
    ref = ref_mask(ref_params, key)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(as_ref)):
        assert float(a) == float(b[0])
