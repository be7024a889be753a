"""repro_torch's LM serving path against the JAX package at smoke size,
for qwen1.5-0.5b (dense), mamba2-780m (SSM) and granite-moe-1b-a400m
(MoE).

Per arch, one module fixture carries the JAX package's init across
(``convert.lm_params_from_reference``) and makes each JAX run once: the
full-sequence forward on its ``xla`` and ``pallas`` (interpret) routes,
``prefill_cache`` + ``decode_step``, and ``greedy_generate``.  Held
(float32 on the CPU): logits within TOL = 1e-4 on every route (the gap
measured on these inputs is at most 3.6e-7, on logits up to 0.49);
greedy tokens equal.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

TOL = 1e-4
ARCHS = ["qwen1.5-0.5b", "mamba2-780m", "granite-moe-1b-a400m"]
B, S, STEPS, WINDOW = 2, 12, 8, 5


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    arch = request.param
    cfg, jcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jt = jnp.asarray(toks)
    ref = {route: np.asarray(jtr.forward(jparams, jcfg, jt,
                                         backend=route)[0])
           for route in ("xla", "pallas")}
    ref["window"] = np.asarray(jtr.forward(jparams, jcfg, jt,
                                           window=WINDOW)[0])
    cache = jtr.prefill_cache(jparams, jcfg, jt[:, :-1], cache_len=S)
    ref["decode"] = np.asarray(jtr.decode_step(jparams, jcfg, jt[:, -1:],
                                               cache)[0])
    ref["greedy"] = np.asarray(jserve.greedy_generate(
        jparams, jcfg, jt[:, :4], STEPS))
    return arch, cfg, params, toks, ref


def close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_forward_matches_reference_routes(served, backend):
    _, cfg, params, toks, ref = served
    logits = tr.forward(params, cfg, torch.from_numpy(toks), backend=backend)
    assert logits.shape == (B, S, cfg.vocab_size)
    for route in ("xla", "pallas"):
        close(logits, ref[route])
    # on the CPU the kernel route takes the plain versions: no launch
    assert (ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_scan"]
            == ops.LAUNCHES["expert_gemm"] == 0)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_prefill_step_is_the_last_position_of_forward(served, backend):
    _, cfg, params, toks, ref = served
    step = serve.make_prefill_step(cfg, backend=backend)
    last = step(params, {"tokens": torch.from_numpy(toks)})
    assert last.shape == (B, 1, cfg.vocab_size)
    close(last, ref["xla"][:, -1:])
    windowed = serve.make_prefill_step(cfg, window=WINDOW, backend=backend)(
        params, {"tokens": torch.from_numpy(toks)})
    close(windowed, ref["window"][:, -1:])


def test_prefill_cache_then_decode_matches_reference(served):
    _, cfg, params, toks, ref = served
    t = torch.from_numpy(toks)
    cache = tr.prefill_cache(params, cfg, t[:, :-1], cache_len=S)
    assert cache["t"] == S - 1
    logits, cache = tr.decode_step(params, cfg, t[:, -1:], cache)
    assert cache["t"] == S
    close(logits, ref["decode"])
    if cfg.family != "moe":
        # the decode replay reproduces the full forward's last position
        close(logits, ref["xla"][:, -1:])
        return
    # The MoE prefill routes all B x S tokens under a capacity and drops
    # the overflow (the latest tokens first: 1 and 3 choices in the two
    # layers here); the replay routes B tokens a step and never drops.
    # The gap is the reference's own: the port's equals it ...
    forward_last = tr.forward(params, cfg, t)[:, -1:]
    close(logits - forward_last,
          ref["decode"] - np.asarray(ref["xla"][:, -1:]))
    # ... and at a capacity that cannot bind (E / k: every expert has a
    # slot for every token) the replay reproduces the forward
    no_drop = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    close(logits, tr.forward(params, no_drop, t)[:, -1:])


def test_greedy_generate_matches_reference_tokens(served):
    _, cfg, params, toks, ref = served
    out = serve.greedy_generate(params, cfg, torch.from_numpy(toks[:, :4]),
                                STEPS)
    assert out.shape == (B, 4 + STEPS)
    np.testing.assert_array_equal(out.numpy(), ref["greedy"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "granite-moe-1b-a400m",
                                  "chatglm3-6b", "starcoder2-3b"])
def test_serve_main_runs_on_the_cpu(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--steps", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 8) tokens" in out and "on cpu" in out


def test_serve_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b"])


def test_prefill_trace_summarizes_device_events():
    from repro_torch.launch.prefill_trace import summarize
    events = [("gemm_bf16", 200.0), ("flash", 1000.0), ("gemm_bf16", 300.0),
              ("copy", 50.0)]
    out = summarize(events, wall_ms=2.0, top=2)
    assert out["busy_ms"] == pytest.approx(1.55)
    assert out["idle_share"] == pytest.approx(1 - 1.55 / 2.0)
    assert out["top"] == [("flash", 1, 1.0), ("gemm_bf16", 2, 0.5)]


def test_prefill_trace_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import prefill_trace
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prefill_trace.main(["--arch", "granite-moe-1b-a400m"])
