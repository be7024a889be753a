"""The VLM and audio families of repro_torch against the JAX package on
the CPU: internvl2-1b (a dense decoder after a projected prefix of stub
patch embeddings) and whisper-large-v3 (a bidirectional encoder over
stub frame embeddings, a decoder with cross attention and a cross K/V
cache).

Smoke configs: internvl2-1b at 2 layers and 8 patches, whisper at 2
encoder and 2 decoder layers and 16 frames.  Weights are the JAX
package's own init, carried across with ``convert``; tokens, patches and
frames (normal x 0.1) are made with numpy from a seed.  Each JAX run is
made once, in a module fixture.  Limits (float32): logits, hidden
states, encoder outputs and caches within 1e-5; one SGD step's loss and
parameters within 1e-5; the bridge, the greedy tokens and the counts
exact.

The JAX package's VLM decode never sees the image: its ``prefill_cache``
ignores the prefix it is given (ROADMAP queue 3).  The port mirrors it;
``test_vlm_decode_replay_is_the_text_only_decoder`` shows both.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference  # noqa: E402
from repro_torch.core import flops, lm_supernet_api  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402

VLM, AUDIO = "internvl2-1b", "whisper-large-v3"
B, S = 2, 12
TOL = 1e-5
LR = 0.1
NEW_TOKENS = 6
ROUTES = ["torch", "kernel", "chunked"]
# a key with an identity layer, and a mixed one
VLM_KEYS = [(0, 2), (3, 1)]
# the full configs' analytic parameter counts (no biases)
FULL_PARAMS = {VLM: 494_557_056, AUDIO: 1_534_602_240}


def configs(arch, **kw):
    return (get_config(arch, smoke=True).replace(**kw),
            ref_get_config(arch, smoke=True).replace(**kw))


def close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def run_jax(arch, seed):
    """The JAX package's init of ``arch`` (numpy leaves), inputs, and its
    forward, decode replay, SGD step and greedy generation on them."""
    cfg, jcfg = configs(arch)
    init = as_np(jtr.init_params(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree.map(jnp.asarray, init)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = (rng.standard_normal((B, cfg.num_prefix, cfg.d_model))
              * 0.1).astype(np.float32)
    jt, jpre = jnp.asarray(toks), jnp.asarray(prefix)
    out = {"init": init, "toks": toks, "labels": labels, "prefix": prefix,
           "logits": np.asarray(jtr.forward(jp, jcfg, jt, prefix=jpre)[0])}
    enc_out = None
    if arch == AUDIO:
        enc_out = jtr.encode(jp, jcfg, jpre)
        out["enc_out"] = np.asarray(enc_out)
    else:
        out["hidden"] = np.asarray(jtr.forward(jp, jcfg, jt, prefix=jpre,
                                               return_hidden=True)[0])
    cache = jtr.prefill_cache(jp, jcfg, jt[:, :-1], cache_len=S + 4,
                              enc_out=enc_out)
    out["cache"] = as_np(cache)
    out["decode"] = np.asarray(jtr.decode_step(jp, jcfg, jt[:, -1:],
                                               cache)[0])
    step = jax.jit(jtrain.make_train_step(jcfg, optimizer="sgd", lr=LR))
    new, _, loss = step(jp, jtrain.init_opt(jp, "sgd"),
                        {"tokens": jt, "labels": jnp.asarray(labels),
                         "prefix": jpre})
    out["train"] = (float(loss), as_np(new))
    out["greedy"] = np.asarray(jserve.greedy_generate(
        jp, jcfg, jt, NEW_TOKENS, prefix=jpre))
    return out


@pytest.fixture(scope="module")
def ref():
    out = {VLM: run_jax(VLM, 0), AUDIO: run_jax(AUDIO, 1)}
    scfg, sjcfg = configs(VLM, supernet=True)
    init = as_np(jtr.init_params(jax.random.PRNGKey(2), sjcfg))
    sp = jax.tree.map(jnp.asarray, init)
    fwd = jax.jit(lambda p, t, x, k: jtr.forward(p, sjcfg, t, prefix=x,
                                                 choice_key=k)[0])
    v = out[VLM]
    out["supernet"] = {"init": init, "logits": {
        key: np.asarray(fwd(sp, jnp.asarray(v["toks"]),
                            jnp.asarray(v["prefix"]),
                            jnp.asarray(key, jnp.int32)))
        for key in VLM_KEYS}}
    return out


def port(ref, arch, **kw):
    """(config, the JAX package's init as the port's params, inputs)."""
    cfg, _ = configs(arch, **kw)
    r = ref[arch]
    return (cfg, lm_params_from_reference(cfg, r["init"]),
            torch.from_numpy(r["toks"]), torch.from_numpy(r["prefix"]))


# ---------------------------------------------------------------------------
# internvl2-1b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ROUTES)
def test_vlm_forward_matches_reference(ref, backend):
    cfg, params, toks, patches = port(ref, VLM)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    logits = tr.forward(params, cfg, toks, prefix=patches, backend=backend)
    assert logits.shape == (B, S, cfg.vocab_size)
    close(logits, ref[VLM]["logits"])
    assert all(n == 0 for n in ops.LAUNCHES.values())   # nothing on the CPU


def test_vlm_return_hidden_strips_the_prefix(ref):
    cfg, params, toks, patches = port(ref, VLM)
    hidden = tr.forward(params, cfg, toks, prefix=patches,
                        return_hidden=True)
    assert hidden.shape == (B, S, cfg.d_model)
    close(hidden, ref[VLM]["hidden"])
    with pytest.raises(ValueError, match="needs a prefix"):
        tr.forward(params, cfg, toks)


def test_vlm_decode_replay_is_the_text_only_decoder(ref):
    """The reference caveat, mirrored: the decode replay equals the JAX
    package's, which never sees the patches, and the port's forward of
    the same weights as a dense model on the tokens alone; it is not
    the VLM's forward with its patches."""
    cfg, params, toks, patches = port(ref, VLM)
    cache = tr.prefill_cache(params, cfg, toks[:, :-1], cache_len=S + 4)
    dec, cache = tr.decode_step(params, cfg, toks[:, -1:], cache)
    close(dec, ref[VLM]["decode"])
    jcache = ref[VLM]["cache"]
    for li, c_l in enumerate(cache["layers"]):
        for name in ("k", "v"):
            close(c_l[name][:, :S - 1], jcache["layers"][name][li][:, :S - 1])
    text = tr.forward(params, cfg.replace(family="dense"), toks)
    close(dec[:, 0], text[:, -1].numpy())
    vlm = tr.forward(params, cfg, toks, prefix=patches)
    assert float((dec[:, 0] - vlm[:, -1]).abs().max()) > 1e-2


@pytest.mark.parametrize("key", VLM_KEYS, ids=["identity", "mixed"])
@pytest.mark.parametrize("backend", ROUTES)
def test_vlm_supernet_forward_matches_reference(ref, key, backend):
    cfg, _ = configs(VLM, supernet=True)
    params = lm_params_from_reference(cfg, ref["supernet"]["init"])
    sparse = {**params, "layers": [
        [b if i == k - 1 else None for i, b in enumerate(layer)]
        for layer, k in zip(params["layers"], key)]}
    logits = tr.forward(sparse, cfg, torch.from_numpy(ref[VLM]["toks"]),
                        prefix=torch.from_numpy(ref[VLM]["prefix"]),
                        choice_key=np.array(key), backend=backend)
    close(logits, ref["supernet"]["logits"][key])


# ---------------------------------------------------------------------------
# whisper-large-v3
# ---------------------------------------------------------------------------

# sin and cos round differently in XLA and in PyTorch: in float32 by a
# few ulp of values below 1 (measured 9.4e-7); after the cast to bf16 by
# at most one bf16 ulp there (2^-8), where such a gap straddles a
# rounding boundary
SINUSOID_TOL = {"float32": 2e-6, "bfloat16": 2 ** -8}


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_match_reference(offset, dtype):
    ours = sinusoidal_positions(16, 128, getattr(torch, dtype), offset=offset)
    theirs = jlayers.sinusoidal_positions(16, 128, getattr(jnp, dtype),
                                          offset=offset)
    assert ours.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32), rtol=0,
                               atol=SINUSOID_TOL[dtype])


@pytest.mark.parametrize("backend", ROUTES)
def test_encode_matches_reference(ref, backend):
    cfg, params, _, frames = port(ref, AUDIO)
    close(tr.encode(params, cfg, frames, backend=backend),
          ref[AUDIO]["enc_out"])


@pytest.mark.parametrize("backend", ROUTES)
def test_audio_forward_matches_reference(ref, backend):
    cfg, params, toks, frames = port(ref, AUDIO)
    logits = tr.forward(params, cfg, toks, prefix=frames, backend=backend)
    assert logits.shape == (B, S, cfg.vocab_size)
    close(logits, ref[AUDIO]["logits"])


def test_audio_prefill_cache_matches_reference(ref):
    """Each layer's cross K/V (from ``enc_out``) and its self K/V ring
    (keys, values, stored positions) equal the JAX package's."""
    cfg, params, toks, frames = port(ref, AUDIO)
    enc_out = tr.encode(params, cfg, frames)
    cache = tr.prefill_cache(params, cfg, toks[:, :-1], cache_len=S + 4,
                             enc_out=enc_out)
    jcache = ref[AUDIO]["cache"]
    assert cache["t"] == int(jcache["t"]) == S - 1
    for li, c_l in enumerate(cache["layers"]):
        assert sorted(c_l) == sorted(jcache["layers"]) == \
            ["cross_k", "cross_v", "k", "pos", "v"]
        assert c_l["cross_k"].shape == (B, cfg.num_prefix,
                                        cfg.num_kv_heads, cfg.hd)
        for name in ("k", "v", "cross_k", "cross_v"):
            close(c_l[name], jcache["layers"][name][li])
        assert c_l["pos"].tolist() == jcache["layers"]["pos"][li].tolist()
    with pytest.raises(ValueError, match="enc_out"):
        tr.prefill_cache(params, cfg, toks)


def test_audio_decode_matches_forward_and_reference(ref):
    """``tests/test_models.py::test_whisper_decode_matches_forward`` on
    the port, and the decode step against the JAX package's."""
    cfg, params, toks, frames = port(ref, AUDIO)
    cache = tr.prefill_cache(params, cfg, toks[:, :-1], cache_len=S + 4,
                             enc_out=tr.encode(params, cfg, frames))
    dec, cache = tr.decode_step(params, cfg, toks[:, -1:], cache)
    assert cache["t"] == S
    close(dec, ref[AUDIO]["decode"])
    full = tr.forward(params, cfg, toks, prefix=frames)
    close(dec[:, 0], full[:, -1].numpy())


def test_audio_supernet_forward_raises(ref):
    """As the JAX package's branch functions refuse ``encdec`` layers."""
    cfg, _ = configs(AUDIO, supernet=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(ref[AUDIO]["toks"])
    with pytest.raises(ValueError, match="supernet"):
        tr.forward(params, cfg, toks,
                   prefix=torch.from_numpy(ref[AUDIO]["prefix"]),
                   choice_key=np.ones(cfg.num_layers, int))


# ---------------------------------------------------------------------------
# both families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_sgd_step_matches_reference(ref, arch):
    cfg, params, toks, prefix = port(ref, arch)
    jloss, jnew = ref[arch]["train"]
    step = train.make_train_step(cfg, optimizer="sgd", lr=LR)
    new, _, loss = step(params, train.init_opt(params, "sgd"),
                        {"tokens": toks, "prefix": prefix,
                         "labels": torch.from_numpy(ref[arch]["labels"])})
    np.testing.assert_allclose(float(loss), jloss, rtol=TOL)
    got = lm_params_to_reference(cfg, new)
    assert jax.tree.structure(got) == jax.tree.structure(jnew)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jnew),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                   err_msg=str(path))
    moved = {"proj", "encoder", "enc_ln"} & set(new)
    before, after = tr.flat_params(params), tr.flat_params(new)
    assert moved and all(
        any(not torch.equal(after[k], before[k]) for k in after
            if k.startswith(f"{name}.")) for name in moved)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_bridge_round_trip_is_exact(ref, arch):
    """The JAX package's init through the port and back, bit for bit;
    the port's own init has its names, shapes and dtypes (the audio
    encoder stacked on ``encoder_layers``, also where that differs from
    ``num_layers``)."""
    cfg, params, _, _ = port(ref, arch)
    init = ref[arch]["init"]
    back = lm_params_to_reference(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    flat = tr.flat_params(params)
    assert tr.flat_params(tr.nested_params(flat)).keys() == flat.keys()
    extra = {VLM: ("proj.w", "proj.b"),
             AUDIO: ("enc_ln.g", "encoder.1.mlp.wi.w",
                     "layers.0.xattn.wq.w")}[arch]
    assert all(k in flat for k in extra)
    for kw in [{}] + ([{"encoder_layers": 3}] if arch == AUDIO else []):
        cfg, jcfg = configs(arch, **kw)
        fresh = tr.flat_params(tr.init_params(
            torch.Generator().manual_seed(0), cfg))
        own = lm_params_to_reference(cfg, tr.nested_params(fresh))
        shapes = jax.eval_shape(lambda k: jtr.init_params(k, jcfg),
                                jax.random.PRNGKey(0))
        assert jax.tree.structure(shapes) == jax.tree.structure(own)
        assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
                   zip(jax.tree.leaves(shapes), jax.tree.leaves(own)))
        again = tr.flat_params(lm_params_from_reference(cfg, own))
        assert sorted(again) == sorted(fresh)
        assert all(torch.equal(again[k], fresh[k]) for k in fresh)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_greedy_generate_matches_reference(ref, arch):
    """The audio model's frames run through the encoder once; the VLM's
    patches are accepted and not used, as in the JAX package."""
    cfg, params, toks, prefix = port(ref, arch)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    got = serve.greedy_generate(params, cfg, toks, NEW_TOKENS, prefix=prefix)
    assert all(n == 0 for n in ops.LAUNCHES.values())
    np.testing.assert_array_equal(got.numpy(), ref[arch]["greedy"])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_param_counts_match_reference(ref, arch):
    """``core/flops.py`` on the full and smoke configs equals the JAX
    package's; at smoke size it is the port's init less its QKV biases
    (it counts the projector's bias)."""
    for smoke in (False, True):
        rcfg = ref_get_config(arch, smoke=smoke)
        cfg = get_config(arch, smoke=smoke)
        for active in (False, True):
            assert flops.model_params(cfg, active) == \
                ref_flops.model_params(rcfg, active)
    assert flops.model_params(get_config(arch)) == FULL_PARAMS[arch]
    cfg, params, _, _ = port(ref, arch)
    flat = tr.flat_params(params)
    biases = sum(t.numel() for k, t in flat.items()
                 if k.endswith(".b") and not k.startswith("proj."))
    assert flops.model_params(cfg) + biases == sum(
        t.numel() for t in flat.values())


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_lm_supernet_api_refuses(arch):
    """As the JAX package's ``lm_supernet_api`` asserts its family is
    dense, moe or ssm."""
    cfg = get_config(arch, smoke=True).replace(supernet=True)
    with pytest.raises(ValueError, match="dense, moe or ssm"):
        lm_supernet_api(cfg)
    assert dataclasses.asdict(cfg)["family"] in ("vlm", "audio")


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_bidirectional_self_attention_on_every_route(arch):
    """``self_attention(causal=False)`` over 600 positions (two query
    blocks of the chunked route, the last ragged) equals the JAX
    package's on all three routes, and differs from the causal one."""
    cfg, jcfg = configs(arch)
    gen = torch.Generator().manual_seed(3)
    p = attn.attention_init(gen, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.hd, torch.float32,
                            qkv_bias=cfg.qkv_bias)
    for name in ("wq", "wk", "wv"):
        if "b" in p[name]:
            p[name]["b"] = torch.randn(p[name]["b"].shape, generator=gen)
    s = 600
    x = np.random.default_rng(4).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (1, s))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.hd, rope_style=cfg.rope_style,
              theta=cfg.rope_theta)
    theirs = jattn.self_attention(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), jnp.asarray(x),
        jnp.asarray(pos), causal=False, **kw)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos.copy())
    theirs = np.asarray(theirs)
    for backend in ROUTES:
        close(attn.self_attention(p, xt, pt, causal=False, backend=backend,
                                  **kw), theirs)
    causal = attn.self_attention(p, xt, pt, backend="torch", **kw)
    assert float((causal[:, :-1] - torch.from_numpy(theirs[:, :-1]))
                 .abs().max()) > 1e-3
