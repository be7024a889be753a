"""repro_torch's MoE layer (``models/moe.py``) against the JAX package's
gather formulation (``repro.models.moe._moe_apply_gather``) at smoke size.

One module fixture per JAX run: the JAX package's ``moe_init`` weights
(carried across as numpy) and 2 x 12 tokens of ``0.5 * normal`` go
through ``_moe_apply_gather`` once per case, with its ``top_k`` and its
``expert_ffn`` spied on, so the test sees the reference's top-k indices
and its dispatched (E, capacity, d) expert input.  Held (float32 on the
CPU): top-k indices and the dispatch equal exactly (the slots are then
equal: every token row is distinct), the number of dropped choices
equal, ``y`` and ``aux`` within 1e-5 on both routes.  The fixture
asserts that the top-k margin of its inputs (the gap between the k-th
and the (k+1)-th router probability) exceeds 1e-5, so that a float gap
between the packages cannot flip the routing silently.

The other tests mirror ``tests/test_moe.py`` on the port alone.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
MARGIN = 1e-5
# (arch, capacity factor, choices the JAX package drops on these inputs)
CASES = [("granite-moe-1b-a400m", 1.25, 0),
         ("granite-moe-1b-a400m", 0.5, 16),
         ("llama4-scout-17b-a16e", 1.25, 0)]
B, S = 2, 12


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-cf{c}" for a, c, _ in CASES])
def gathered(request):
    arch, cf, drops = request.param
    jcfg = ref_get_config(arch, smoke=True).replace(capacity_factor=cf)
    cfg = get_config(arch, smoke=True).replace(capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (B, S, jcfg.d_model)) * 0.5)
    seen = {}
    top_k, ffn = jax.lax.top_k, jmoe.expert_ffn

    def spy_top_k(probs, k):
        seen["probs"] = np.array(probs)
        out = top_k(probs, k)
        seen["expert"] = np.array(out[1])
        return out

    def spy_ffn(experts, expert_in):
        seen["expert_in"] = np.array(expert_in)
        return ffn(experts, expert_in)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", spy_top_k)
        mp.setattr(jmoe, "expert_ffn", spy_ffn)
        y, aux = jmoe._moe_apply_gather(jp, jax.numpy.asarray(x), jcfg)
    top = np.sort(seen["probs"], axis=-1)[:, ::-1]
    k = cfg.top_k
    margin = float((top[:, k - 1] - top[:, k]).min())
    assert margin > MARGIN, f"near-tie in the routing: margin {margin}"
    return (cfg, to_torch(jp), x, seen, np.asarray(y), float(aux), drops)


def test_capacity_rounding():
    assert moe.capacity(100, 4, 2, 1.25) % 8 == 0
    assert moe.capacity(100, 4, 2, 1.25) >= 100 * 2 * 1.25 / 4
    for t, e, k, f in [(1, 32, 8, 1.25), (4, 32, 8, 1.25),
                       (4096, 32, 8, 1.25), (24, 4, 2, 0.5),
                       (24, 4, 1, 1.25), (1000, 16, 1, 0.1)]:
        assert moe.capacity(t, e, k, f) == jmoe._capacity(t, e, k, f)


def test_dispatch_matches_reference(gathered):
    cfg, p, x, seen, _, _, drops = gathered
    x2 = torch.from_numpy(x).reshape(B * S, cfg.d_model)
    r = moe.route(p, x2, cfg)
    assert torch.equal(r["expert"], torch.from_numpy(seen["expert"]).long())
    e, cap = cfg.num_experts, r["cap"]
    assert int((r["slot"] == e * cap).sum()) == drops
    kept = r["slot"][r["slot"] < e * cap]
    assert kept.unique().numel() == kept.numel()   # one choice per slot
    expert_in = moe.dispatch(x2, r["slot"], cfg, cap)
    assert expert_in.shape == (e, cap, cfg.d_model)
    np.testing.assert_array_equal(expert_in.numpy(), seen["expert_in"])
    # the rows the reference filled are the kept choices
    assert int((np.abs(seen["expert_in"]).sum(-1) > 0).sum()) == (
        B * S * cfg.top_k - drops)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_moe_apply_matches_reference(gathered, backend):
    cfg, p, x, _, y_ref, aux_ref, _ = gathered
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg, backend=backend)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), aux_ref, rtol=TOL, atol=TOL)
    # on the CPU the kernel route takes K5's plain version: no launch
    assert ops.LAUNCHES["expert_gemm"] == 0


# ---------------------------------------------------------------------------
# tests/test_moe.py's invariants, on the port
# ---------------------------------------------------------------------------

AMPLE = get_config("granite-moe-1b-a400m", smoke=True).replace(
    capacity_factor=8.0)   # ample capacity: nothing drops


@pytest.fixture(scope="module")
def setup():
    p = moe.moe_init(torch.Generator().manual_seed(0), AMPLE)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32, AMPLE.d_model)).astype(np.float32) * 0.5)
    return p, x


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_output_finite_and_shaped(setup, backend):
    p, x = setup
    y, aux = moe.moe_apply(p, x, AMPLE, backend=backend)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux) >= 1.0 - 1e-3   # >= 1 by Cauchy-Schwarz for top-k


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_ample_capacity_every_token_processed(setup, backend):
    """With gates renormalised and no drops, output != 0 for all tokens."""
    p, x = setup
    r = moe.route(p, x.reshape(-1, AMPLE.d_model), AMPLE)
    assert int((r["slot"] == AMPLE.num_experts * r["cap"]).sum()) == 0
    y, _ = moe.moe_apply(p, x, AMPLE, backend=backend)
    assert float(y.reshape(-1, AMPLE.d_model).norm(dim=-1).min()) > 0


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_tight_capacity_drops_gracefully(setup, backend):
    """At capacity factor 0.1 most choices drop; a token whose every
    choice dropped gets exactly zero (granite has no shared expert)."""
    p, x = setup
    cfg = AMPLE.replace(capacity_factor=0.1)
    x2 = x.reshape(-1, cfg.d_model)
    r = moe.route(p, x2, cfg)
    dropped = (r["slot"] == cfg.num_experts * r["cap"]).reshape(
        -1, cfg.top_k)
    assert 0 < int(dropped.sum()) < dropped.numel()
    y, _ = moe.moe_apply(p, x, cfg, backend=backend)
    assert torch.isfinite(y).all()
    y2 = y.reshape(-1, cfg.d_model)
    all_dropped = dropped.all(-1)
    assert bool(all_dropped.any())
    assert float(y2[all_dropped].abs().max()) == 0.0
    assert float(y2[~all_dropped].norm(dim=-1).min()) > 0


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_permutation_equivariance(setup, backend):
    """Routing is per token: permuting the batch permutes the outputs
    (with ample capacity, so the rank order cannot change drops)."""
    p, x = setup
    y, _ = moe.moe_apply(p, x, AMPLE, backend=backend)
    perm = torch.tensor([1, 0])
    y_p, _ = moe.moe_apply(p, x[perm], AMPLE, backend=backend)
    np.testing.assert_allclose(y[perm].numpy(), y_p.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_shared_expert_is_added_to_every_token():
    """llama4's shared expert: 48 tokens all routed top-1 to expert 0
    (capacity 16): the 32 dropped tokens get the shared MLP alone, the
    16 kept ones the shared MLP plus their expert."""
    from repro_torch.models.layers import mlp
    cfg = get_config("llama4-scout-17b-a16e", smoke=True)
    p = moe.moe_init(torch.Generator().manual_seed(2), cfg)
    assert set(p) == {"router", "experts", "shared"}
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    p["router"]["w"][:, 0] = 1.0
    x = torch.ones((2, 24, cfg.d_model))      # every token to expert 0
    y, _ = moe.moe_apply(p, x, cfg, backend="torch")
    shared = mlp(p["shared"], x.reshape(-1, cfg.d_model)).reshape(x.shape)
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    kept = r["slot"] < cfg.num_experts * r["cap"]
    assert int(kept.sum()) == r["cap"]        # the first cap tokens only
    kept = kept.reshape(2, 24)
    torch.testing.assert_close(y[~kept], shared[~kept], rtol=0, atol=0)
    assert float((y[kept] - shared[kept]).abs().max()) > 0


def test_unknown_backend_raises(setup):
    p, x = setup
    with pytest.raises(ValueError, match="the port takes"):
        moe.moe_apply(p, x, AMPLE, backend="pallas")
