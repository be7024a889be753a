"""Per-architecture smoke tests of the port, mirroring
``tests/test_arch_smoke.py`` for every architecture the port takes: the
smoke config (2 layers, d_model 128, at most 4 experts) runs a forward,
an SGD train step (``launch/train.py``) and a decode step on the CPU,
with finite outputs of the expected shapes; the full configs carry the
published spec.  The VLM and audio models get a prefix of
``num_prefix`` embeddings (patches, frames), as the JAX package's tests
give theirs.

Torch only, but for one forward-parity case each of chatglm3-6b (2d
RoPE, 2 KV heads, QKV bias) and starcoder2-3b (its sliding window)
against the JAX package, on both of the port's routes, within
``tests/test_torch_models.py``'s 1e-4 (float32; the weights are the
port's init, carried across with ``convert``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_to_reference  # noqa: E402
from repro_torch.launch.train import init_opt, make_train_step  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

BATCH, SEQ = 2, 64
ARCHS = ["qwen1.5-0.5b", "chatglm3-6b", "starcoder2-3b", "deepseek-67b",
         "mamba2-780m", "granite-moe-1b-a400m", "llama4-scout-17b-a16e",
         "zamba2-2.7b", "internvl2-1b", "whisper-large-v3"]
TOL = 1e-4


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (BATCH, SEQ)).astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        batch["prefix"] = torch.from_numpy(rng.normal(
            0.0, 0.1, (BATCH, cfg.num_prefix, cfg.d_model)).astype(np.float32))
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    cfg = get_config(request.param, smoke=True)
    assert cfg.num_layers <= 2 and cfg.d_model <= 512
    assert cfg.num_experts <= 4
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    return request.param, cfg, params


def test_forward_shapes_and_finite(arch_setup):
    arch, cfg, params = arch_setup
    batch = make_batch(cfg, 1)
    logits, aux = tr.forward(params, cfg, batch["tokens"],
                             prefix=batch.get("prefix"), return_aux=True)
    assert logits.shape == (BATCH, SEQ, cfg.vocab_size), arch
    assert torch.isfinite(logits).all(), arch
    assert torch.isfinite(aux), arch


def test_train_step_updates_and_finite(arch_setup):
    arch, cfg, params = arch_setup
    step = make_train_step(cfg, optimizer="sgd", lr=0.01, remat=False,
                           fused_ce=True)
    new_params, _, loss = step(params, init_opt(params), make_batch(cfg, 2))
    assert torch.isfinite(loss), arch
    old, new = tr.flat_params(params), tr.flat_params(new_params)
    assert list(old) == list(new), arch
    assert all(torch.isfinite(t).all() for t in new.values()), arch
    assert any(not torch.equal(old[k], new[k]) for k in old), arch


def test_decode_step_finite(arch_setup):
    arch, cfg, params = arch_setup
    enc_len = cfg.num_prefix if cfg.family == "audio" else 0
    cache = tr.init_cache(params, cfg, BATCH, 32, enc_len=enc_len)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32)
    logits, cache = tr.decode_step(params, cfg, tok, cache)
    assert logits.shape == (BATCH, 1, cfg.vocab_size), arch
    assert torch.isfinite(logits).all(), arch
    assert cache["t"] == 1


def test_full_config_matches_assignment(arch_setup):
    """The non-smoke config carries the exact published spec."""
    arch, _, _ = arch_setup
    full = get_config(arch)
    spec = {
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024),
        "deepseek-67b": (95, 8192, 64, 8, 22016, 102400),
        "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
        "qwen1.5-0.5b": (24, 1024, 16, 16, 2816, 151936),
        "mamba2-780m": (48, 1536, 0, 0, 0, 50280),
        "zamba2-2.7b": (54, 2560, 32, 32, 10240, 32000),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
        "whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
    }[arch]
    got = (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
           full.d_ff, full.vocab_size)
    assert got == spec, (arch, got, spec)
    assert full.source, arch  # citation present


def test_moe_ssm_and_attention_extras():
    llama4 = get_config("llama4-scout-17b-a16e")
    assert (llama4.num_experts, llama4.top_k) == (16, 1)
    granite = get_config("granite-moe-1b-a400m")
    assert (granite.num_experts, granite.top_k) == (32, 8)
    assert get_config("mamba2-780m").ssm_state == 128
    chatglm = get_config("chatglm3-6b")
    assert (chatglm.rope_style, chatglm.qkv_bias, chatglm.hd) == \
        ("2d", True, 128)
    starcoder = get_config("starcoder2-3b")
    assert (starcoder.sliding_window, starcoder.hd) == (4096, 128)
    assert get_config("deepseek-67b").hd == 128
    zamba2 = get_config("zamba2-2.7b")
    assert (zamba2.attn_every, zamba2.hd, zamba2.ssm_head_dim,
            zamba2.ssm_state) == (6, 80, 80, 64)
    internvl = get_config("internvl2-1b")
    assert (internvl.num_prefix, internvl.hd, internvl.qkv_bias) == \
        (256, 64, True)
    whisper = get_config("whisper-large-v3")
    assert (whisper.encoder_layers, whisper.num_prefix, whisper.rope_style,
            whisper.hd) == (32, 1500, "none", 64)


def test_vlm_prefix_shapes():
    """``tests/test_models.py::test_vlm_prefix_shapes`` on the port: the
    logits (and ``return_hidden``) cover the token positions only."""
    cfg = get_config("internvl2-1b", smoke=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    patches = torch.ones((2, cfg.num_prefix, cfg.d_model))
    logits = tr.forward(params, cfg, toks, prefix=patches)
    assert logits.shape == (2, 16, cfg.vocab_size)
    hidden = tr.forward(params, cfg, toks, prefix=patches, return_hidden=True)
    assert hidden.shape == (2, 16, cfg.d_model)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "starcoder2-3b"])
def test_forward_matches_reference_on_both_routes(arch):
    """chatglm3 unwindowed; starcoder2 at its smoke window (64) over 96
    tokens, so the window cuts the context."""
    cfg = get_config(arch, smoke=True)
    jcfg = ref_get_config(arch, smoke=True)
    window = cfg.sliding_window if arch == "starcoder2-3b" else 0
    params = tr.init_params(torch.Generator().manual_seed(1), cfg)
    jparams = jax.tree.map(jnp.asarray, lm_params_to_reference(cfg, params))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (BATCH, 96)).astype(np.int32)
    ref = np.asarray(jtr.forward(jparams, jcfg, jnp.asarray(toks),
                                 window=window)[0])
    for backend in ("torch", "kernel"):
        ours = tr.forward(params, cfg, torch.from_numpy(toks), window=window,
                          backend=backend)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=TOL, atol=TOL)
    if window:
        # the window changes the logits past it
        full = tr.forward(params, cfg, torch.from_numpy(toks))
        assert not torch.allclose(full[:, window:], ours[:, window:])
