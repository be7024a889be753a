"""repro_torch language-model modules against the JAX package at smoke
size (``smoke_config()``: 2 layers, d_model 128, float32): the dense,
SSM and MoE families, and the ``chunked`` attention route.

The weights come from the JAX package's own init, carried across with
``repro_torch.convert.lm_params_from_reference``; every input is made
with numpy and handed to both packages.  Tolerances (float32 on the
CPU): the elementwise layers (RoPE, RMSNorm, the MLPs, the
cross entropy) and the ``chunked`` route within 1e-5 (bf16: one bf16
step of the output); attention, the SSD scan and the SSM block,
whose sums run in another order (einsum contractions, the chunked scan's
products), within 1e-4; the weight bridge exact both ways.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, layers, ssm  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ELEM_TOL = 1e-5
TOL = 1e-4
# llama4's smoke config is the only one with a shared expert; chatglm3
# the only one with 2d RoPE; starcoder2 and deepseek complete the dense
# shelf (their configs and the bridge)
ARCHS = ["qwen1.5-0.5b", "mamba2-780m", "granite-moe-1b-a400m",
         "llama4-scout-17b-a16e", "chatglm3-6b", "starcoder2-3b",
         "deepseek-67b"]


def close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def weights():
    """arch -> (cfg, JAX params, port params): the JAX package's init."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        ref = jtr.init_params(jax.random.PRNGKey(0),
                              ref_get_config(arch, smoke=True))
        out[arch] = (cfg, ref, lm_params_from_reference(
            cfg, jax.tree.map(np.asarray, ref)))
    return out


def layer0(tree):
    """Layer 0 of the JAX package's stacked per-layer leaves."""
    return jax.tree.map(lambda a: a[0], tree["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                == dataclasses.asdict(ref_get_config(arch, smoke=smoke)))
    assert get_config(arch).torch_dtype == torch.bfloat16
    assert get_config(arch, smoke=True).torch_dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_exact(weights, arch):
    cfg, ref, params = weights[arch]
    assert len(params["layers"]) == cfg.num_layers
    back = lm_params_to_reference(cfg, params)
    ref_np = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref_np)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref_np),
                            jax.tree.leaves(back)):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    again = lm_params_from_reference(cfg, back)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        assert torch.equal(a, b)
    # the bridge gives the port's own init its names, shapes and dtypes
    fresh = tr.init_params(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, fresh))
            == jax.tree.structure(jax.tree.map(lambda t: 0, params)))
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("style", ["1d", "2d", "none"])
def test_rope_matches_reference(style):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 37, (2, 7))
    ours = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                             10000.0, style)
    close(ours, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                                   style), ELEM_TOL)
    if style == "none":
        assert np.array_equal(ours.numpy(), x)


def test_rmsnorm_embed_and_cross_entropy_match_reference(weights):
    _, ref, params = weights["qwen1.5-0.5b"]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    g = {"g": rng.normal(size=(128,)).astype(np.float32)}
    close(layers.rmsnorm({"g": torch.from_numpy(g["g"])}, torch.from_numpy(x)),
          jlayers.rmsnorm({"g": jnp.asarray(g["g"])}, jnp.asarray(x)),
          ELEM_TOL)
    toks = rng.integers(0, 512, size=(2, 5)).astype(np.int32)
    emb = layers.embed(params["embed"], torch.from_numpy(toks))
    close(emb, jlayers.embed(ref["embed"], jnp.asarray(toks)), 0.0)
    close(layers.unembed(params["embed"], torch.from_numpy(x)),
          jlayers.unembed(ref["embed"], jnp.asarray(x)), TOL)
    logits = rng.normal(size=(2, 5, 512)).astype(np.float32)
    labels = toks.copy()
    labels[0, 1] = -1
    close(layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels)),
          jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)),
          ELEM_TOL)


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_mlp_matches_reference(gated):
    p = jlayers.mlp_init(jax.random.PRNGKey(3), 64, 96, jnp.float32,
                         gated=gated)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    close(layers.mlp(pt, torch.from_numpy(x)),
          jlayers.mlp(p, jnp.asarray(x)), ELEM_TOL)


@pytest.mark.parametrize("window", [0, 5], ids=["causal", "window5"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_self_attention_matches_reference(weights, window, backend):
    cfg, ref, params = weights["qwen1.5-0.5b"]
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.hd, rope_style=cfg.rope_style,
              theta=cfg.rope_theta, window=window)
    x = np.random.default_rng(4).normal(size=(2, 12, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    ours = attention.self_attention(
        params["layers"][0]["attn"], torch.from_numpy(x),
        torch.from_numpy(pos), backend=backend, **kw)
    for route in ("xla", "pallas"):
        close(ours, jattn.self_attention(layer0(ref)["attn"], jnp.asarray(x),
                                         jnp.asarray(pos), backend=route,
                                         **kw), TOL)


def test_decode_attention_matches_reference_on_a_ring_cache(weights):
    """Ten tokens through a 6-slot ring with window 4: slots are reused
    and the window masks by the stored positions."""
    cfg, ref, params = weights["qwen1.5-0.5b"]
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.hd, rope_style=cfg.rope_style,
              theta=cfg.rope_theta, window=4)
    xs = np.random.default_rng(5).normal(size=(10, 2, 1, 128)).astype(
        np.float32)
    cache = attention.init_cache(2, cfg.num_kv_heads, cfg.hd, 6,
                                 torch.float32, "cpu")
    jcache = jattn.init_cache(2, cfg.num_kv_heads, cfg.hd, 6, jnp.float32)
    p, jp = params["layers"][0]["attn"], layer0(ref)["attn"]
    for t, x in enumerate(xs):
        out, cache = attention.decode_self_attention(
            p, torch.from_numpy(x), cache, t, **kw)
        jout, jcache = jattn.decode_self_attention(
            jp, jnp.asarray(x), jcache, jnp.int32(t), **kw)
        close(out, jout, TOL)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    close(cache["k"], jcache["k"], TOL)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_ssd_chunked_on_a_padded_length_matches_reference(backend):
    """S = 100 is padded to one chunk of 128 with dt = 0; y is cut back
    and the state is that of the 100 real steps."""
    b, s, h, p, n = 2, 100, 3, 8, 16
    rng = np.random.default_rng(6)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.2).astype(np.float32)
    a_head = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a_head, bm, cm)),
                            backend=backend)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    y_r, s_r = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_head, bm, cm)),
                                backend="xla")
    close(y, y_r, TOL)
    close(st, s_r, TOL)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_ssm_forward_matches_reference(weights, backend):
    cfg, ref, params = weights["mamba2-780m"]
    jcfg = ref_get_config("mamba2-780m", smoke=True)
    x = np.random.default_rng(7).normal(size=(2, 20, 128)).astype(np.float32)
    ours = ssm.ssm_forward(params["layers"][0]["ssm"], torch.from_numpy(x),
                           cfg, backend=backend)
    for route in ("xla", "pallas"):
        close(ours, jssm.ssm_forward(layer0(ref)["ssm"], jnp.asarray(x), jcfg,
                                     backend=route), TOL)


def test_ssm_decode_steps_match_reference(weights):
    cfg, ref, params = weights["mamba2-780m"]
    jcfg = ref_get_config("mamba2-780m", smoke=True)
    xs = np.random.default_rng(8).normal(size=(6, 2, 1, 128)).astype(
        np.float32)
    cache = ssm.init_ssm_cache(2, cfg, torch.float32, "cpu")
    jcache = jssm.init_ssm_cache(2, jcfg, jnp.float32)
    p, jp = params["layers"][0]["ssm"], layer0(ref)["ssm"]
    for x in xs:
        out, cache = ssm.ssm_decode_step(p, torch.from_numpy(x), cache, cfg)
        jout, jcache = jssm.ssm_decode_step(jp, jnp.asarray(x), jcache, jcfg)
        close(out, jout, TOL)
    for k in cache:
        close(cache[k], jcache[k], TOL)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_moe_layer_and_aux_sum_match_reference(weights, backend):
    """Layer 0's MoE block on both routes == the JAX package's, and the
    forward's aux loss, summed over the layers, == the JAX forward's."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    cfg, ref, params = weights["granite-moe-1b-a400m"]
    jcfg = ref_get_config("granite-moe-1b-a400m", smoke=True)
    x = np.random.default_rng(9).normal(size=(2, 12, 128)).astype(
        np.float32) * 0.5
    y, aux = moe.moe_apply(params["layers"][0]["moe"], torch.from_numpy(x),
                           cfg, backend=backend)
    y_r, aux_r = jmoe._moe_apply_gather(layer0(ref)["moe"], jnp.asarray(x),
                                        jcfg)
    close(y, y_r, ELEM_TOL)
    close(aux, aux_r, ELEM_TOL)
    toks = np.random.default_rng(10).integers(0, 512, size=(2, 12)).astype(
        np.int32)
    logits, aux = tr.forward(params, cfg, torch.from_numpy(toks),
                             backend=backend, return_aux=True)
    logits_r, aux_r, _ = jtr.forward(ref, jcfg, jnp.asarray(toks))
    close(logits, logits_r, TOL)
    close(aux, aux_r, ELEM_TOL)
    assert float(aux) > cfg.num_layers * (1.0 - 1e-3)   # >= 1 a layer
    # the other families report no aux loss
    qcfg, _, qparams = weights["qwen1.5-0.5b"]
    _, zero = tr.forward(qparams, qcfg, torch.from_numpy(toks),
                         backend=backend, return_aux=True)
    assert float(zero) == 0.0


@pytest.mark.parametrize("window", [0, 16], ids=["causal", "window16"])
def test_chunked_route_matches_reference(weights, window):
    """``tests/test_models.py::test_chunked_attention_backend_matches_xla``
    on the port: chatglm3 (2 KV heads, 2d RoPE), 100 tokens in one
    block, against the JAX package's ``chunked`` and ``xla`` routes."""
    cfg, ref, params = weights["chatglm3-6b"]
    jcfg = ref_get_config("chatglm3-6b", smoke=True)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    ours = tr.forward(params, cfg, torch.from_numpy(toks), window=window,
                      backend="chunked")
    for route in ("chunked", "xla"):
        close(ours, jtr.forward(ref, jcfg, jnp.asarray(toks), window=window,
                                backend=route)[0], ELEM_TOL)


def attend_inputs(s, kh, dtype=np.float32, seed=12):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(2, s, n, 16)).astype(dtype)
                 for n in (4, kh, kh))


@pytest.mark.parametrize("window,lite", [(0, False), (16, False), (0, True),
                                         (16, True)],
                         ids=["causal", "window16", "head_mask",
                              "window16_head_mask"])
def test_attend_chunked_on_a_ragged_length_matches_reference(window, lite):
    """Blocks of 32 queries over 100 tokens (a padded last block), GQA 2,
    against the JAX package's ``_attend`` (the ``xla`` route): query i
    sits at position i in every block.  The JAX package's own
    ``_attend_chunked`` shifts every query by the padding at such a
    length (ROADMAP queue 3) and is off by more than 1 here."""
    q, k, v = attend_inputs(100, 2)
    head_mask = np.array([True, False, True, False]) if lite else None
    ours = attention._attend_chunked(
        *map(torch.from_numpy, (q, k, v)), window=window, chunk=32,
        head_mask=None if head_mask is None else torch.from_numpy(head_mask))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jmask = None if head_mask is None else jnp.asarray(head_mask)
    close(ours, jattn._attend(jq, jk, jv, jattn.causal_mask(100, window=window),
                              jmask), ELEM_TOL)
    theirs = jattn._attend_chunked(jq, jk, jv, window=window, chunk=32,
                                   head_mask=jmask)
    assert float(np.abs(ours.numpy() - np.asarray(theirs)).max()) > 1.0


def test_attend_chunked_in_bf16_matches_reference():
    """bf16 q, k, v at 64 tokens in blocks of 32 (no padding, where the
    JAX package's chunked route is right): the probabilities rounded to
    bf16 before the product with v, as the JAX package's; the outputs
    within one bf16 step of each other."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in attend_inputs(64, 2, seed=13))
    ours = attention._attend_chunked(q, k, v, chunk=32)
    assert ours.dtype == torch.bfloat16
    theirs = jattn._attend_chunked(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        chunk=32)
    theirs = np.asarray(theirs.astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(theirs), 1e-30))) - 7)
    assert (np.abs(ours.float().numpy() - theirs) <= step).all()
    # the rounding of the probabilities shows: float32 ones differ
    exact = attention._attend_chunked(q.float(), k.float(), v.float(),
                                      chunk=32)
    assert not torch.equal(ours, exact.to(torch.bfloat16))


def test_attend_chunked_gradients_match_the_torch_route():
    """Gradients of q, k and v through the blocks, each recomputed in the
    backward pass, equal those through ``_attend`` (100 tokens in blocks
    of 32, window 16, GQA 2)."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in attend_inputs(100, 2, seed=14))
    w = torch.from_numpy(np.random.default_rng(15).normal(
        size=(2, 100, 64)).astype(np.float32))
    grads = []
    for fn in (lambda: attention._attend_chunked(q, k, v, window=16,
                                                 chunk=32),
               lambda: attention._attend(q, k, v, attention.causal_mask(
                   100, window=16))):
        grads.append(torch.autograd.grad((fn() * w).sum(), [q, k, v]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=ELEM_TOL, atol=ELEM_TOL)
    # without grad mode the blocks run without checkpoint: the same bits
    with torch.no_grad():
        plain = attention._attend_chunked(q, k, v, window=16, chunk=32)
    torch.testing.assert_close(
        plain, attention._attend_chunked(q, k, v, window=16, chunk=32),
        rtol=0, atol=0)


def test_ssd_chunked_takes_the_torch_route_under_chunked():
    """``"chunked"`` is an attention route: the SSD scan runs its
    einsums there, as the JAX package's scan does for every route but
    ``"pallas"``, and launches nothing."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(2, 100, 3, 8)).astype(np.float32))
    dt = torch.from_numpy(np.abs(rng.normal(size=(2, 100, 3))).astype(
        np.float32) * 0.2)
    a_head = torch.from_numpy(-np.abs(rng.normal(size=(3,))).astype(
        np.float32))
    bm, cm = (torch.from_numpy(rng.normal(size=(2, 100, 16)).astype(
        np.float32)) for _ in range(2))
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    got = ssm.ssd_chunked(x, dt, a_head, bm, cm, backend="chunked")
    want = ssm.ssd_chunked(x, dt, a_head, bm, cm, backend="torch")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("backend", ["xla", "pallas", "cuda"])
def test_other_route_names_raise(weights, backend):
    cfg, _, params = weights["qwen1.5-0.5b"]
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="the port takes"):
        tr.forward(params, cfg, toks, backend=backend)
    with pytest.raises(ValueError, match="the port takes"):
        ssm.ssd_chunked(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2),
                        torch.zeros(2), torch.zeros(1, 4, 4),
                        torch.zeros(1, 4, 4), backend=backend)


@pytest.mark.parametrize("arch,match", [
    ("cifar-supernet", "not a language model"),
    ("supernet", "LM supernet NAS path")])
def test_unported_model_kinds_raise(arch, match):
    if arch == "supernet":
        # the LM supernet builds and runs forward now; decoding one stays
        # unported, as in the JAX package, and says why
        cfg = get_config("qwen1.5-0.5b", smoke=True).replace(supernet=True)
        params = tr.init_params(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(NotImplementedError, match=match):
            tr.init_cache(params, cfg, 1, 4)
        return
    with pytest.raises(ValueError, match=match):
        tr.init_params(torch.Generator().manual_seed(0), get_config(arch))

