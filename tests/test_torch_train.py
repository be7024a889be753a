"""repro_torch's LM training launcher against the JAX package on the CPU:
the optimizers (AdamW, ``cosine_decay``), ``fused_cross_entropy``,
``make_train_step`` on qwen1.5-0.5b's smoke config in float32 (SGD and
AdamW, microbatches 1 and 2, remat on and off, the loss over the
full logits, ``fused_ce=False``, and the ``chunked`` attention route),
the qwen supernet with a fresh key each step, and the forward-only
kernel routes.

Weights come from the port's init, carried to the JAX package through
``convert`` (the JAX package's own init of the supernet takes seconds);
tokens, labels and gradients are made with numpy and handed to both.
Each JAX run is made once, in a module fixture.  Limits (float32):

- the optimizers on identical inputs: within 1e-7 (measured: AdamW's
  parameters bit for bit over 5 steps, its moments within 3.0e-8;
  ``cosine_decay`` bit for bit);
- whole SGD steps: loss within 1e-6 relative, parameters within 1e-6
  (measured: loss 1.5e-7 relative, parameters 1.2e-7, one float32 step
  of a norm gain near 1, over 2 steps and over the supernet's 3);
- whole AdamW steps: loss within 1e-6 relative; parameters within 2e-4,
  with at most 1e-3 of the entries beyond 1e-6 (measured at lr 1e-3:
  largest gap 5.1e-5, 55-57 of 394,624 entries beyond 1e-6 over 2
  steps; over the full logits 4.4e-5 and 27-30).  An AdamW
  step is m / (sqrt(v) + eps): an entry whose gradient is rounding noise
  in one package moves by up to 2 lr, so the whole step cannot be held
  as tightly as the optimizer alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ARCH = "qwen1.5-0.5b"
B, S, STEPS = 4, 16, 2
LR = {"sgd": 0.1, "adamw": 1e-3}
# the supernet's keys, one a step: a branch trained in one step and
# left out of the next still moves (SGD: by lr x momentum x velocity)
KEYS = ([1, 2], [3, 0], [2, 1])
OPT_TOL = 1e-7
SGD_TOL = 1e-6
LOSS_RTOL = 1e-6
ADAMW_TOL, ADAMW_NOISY = 2e-4, 1e-3


def batches(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                  for _ in range(2)) for _ in range(n)]


def jax_run(optimizer, microbatch, keys=None, fused_ce=True, backend="xla"):
    """The JAX package's steps from the port's init -> (init as numpy,
    in the JAX package's layout; [(loss, params as numpy)] per step)."""
    cfg, jcfg = get_config(ARCH, smoke=True), ref_get_config(ARCH, smoke=True)
    if keys is not None:
        cfg, jcfg = cfg.replace(supernet=True), jcfg.replace(supernet=True)
    init = lm_params_to_reference(cfg, tr.init_params(
        torch.Generator().manual_seed(0), cfg))
    params = jax.tree.map(jnp.asarray, init)
    step = jax.jit(jtrain.make_train_step(jcfg, optimizer=optimizer,
                                          lr=LR[optimizer],
                                          microbatch=microbatch,
                                          fused_ce=fused_ce,
                                          backend=backend))
    opt = jtrain.init_opt(params, optimizer)
    out = []
    for i, (x, y) in enumerate(batches(jcfg, len(keys or ()) or STEPS)):
        batch = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
        if keys is not None:
            batch["choice_key"] = jnp.asarray(keys[i], jnp.int32)
        params, opt, loss = step(params, opt, batch)
        out.append((float(loss), jax.tree.map(np.asarray, params)))
    return init, out


@pytest.fixture(scope="module")
def reference():
    runs = {(o, mb): jax_run(o, mb) for o in ("sgd", "adamw")
            for mb in (1, 2)}
    runs["supernet"] = jax_run("sgd", 1, keys=KEYS)
    # the loss over the full logits (``fused_ce=False``)
    runs.update({(o, "logits"): jax_run(o, 1, fused_ce=False)
                 for o in ("sgd", "adamw")})
    # the chunked route: 16 tokens, one block of queries, where the JAX
    # package's chunked route computes the right mask
    runs["chunked"] = jax_run("sgd", 1, backend="chunked")
    return runs


def port_run(init, optimizer, microbatch, remat, keys=None, fused_ce=True,
             backend="torch"):
    cfg = get_config(ARCH, smoke=True)
    if keys is not None:
        cfg = cfg.replace(supernet=True)
    params = lm_params_from_reference(cfg, init)
    step = train.make_train_step(cfg, optimizer=optimizer, lr=LR[optimizer],
                                 microbatch=microbatch, remat=remat,
                                 fused_ce=fused_ce, backend=backend)
    opt = train.init_opt(params, optimizer)
    out = []
    for i, (x, y) in enumerate(batches(cfg, len(keys or ()) or STEPS)):
        batch = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}
        if keys is not None:
            batch["choice_key"] = np.asarray(keys[i])
        params, opt, loss = step(params, opt, batch)
        out.append((float(loss), lm_params_to_reference(cfg, params)))
    return out


def param_gaps(ours, theirs) -> np.ndarray:
    assert (jax.tree.structure(ours) == jax.tree.structure(theirs))
    return np.concatenate([np.abs(a - b).ravel() for a, b in
                           zip(jax.tree.leaves(ours),
                               jax.tree.leaves(theirs))])


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

def test_adamw_update_matches_reference_on_identical_gradients():
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "s": ()}
    p = {k: np.asarray(rng.normal(size=s), np.float32)
         for k, s in shapes.items()}
    ours = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    theirs = {k: jnp.asarray(v) for k, v in p.items()}
    st, jst = optim.adamw_init(ours), joptim.adamw_init(theirs)
    jupdate = jax.jit(joptim.adamw_update)
    assert st["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in st["m"].values())
    for i in range(5):
        g = {k: np.asarray(rng.normal(size=s) * 10.0 ** -i, np.float32)
             for k, s in shapes.items()}
        lr = float(optim.cosine_decay(1e-2, i, 5, warmup=1))
        ours, st = optim.adamw_update(
            ours, {k: torch.from_numpy(v) for k, v in g.items()}, st, lr)
        theirs, jst = jupdate(
            theirs, {k: jnp.asarray(v) for k, v in g.items()}, jst, lr)
        assert int(st["step"]) == int(jst["step"]) == i + 1
        for k in shapes:
            for a, b in ((ours[k], theirs[k]), (st["m"][k], jst["m"][k]),
                         (st["v"][k], jst["v"][k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=OPT_TOL, atol=OPT_TOL)


def test_adamw_keeps_a_bf16_parameter_in_bf16():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    st = optim.adamw_init(p)
    out, st = optim.adamw_update(p, {"w": torch.ones(3, dtype=torch.bfloat16)},
                                 st, 0.1)
    assert out["w"].dtype == torch.bfloat16
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32


@pytest.mark.parametrize("warmup", [0, 10])
def test_cosine_decay_matches_reference(warmup):
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        ours = optim.cosine_decay(3e-3, step, 100, warmup=warmup)
        assert isinstance(ours, np.float32)
        theirs = float(joptim.cosine_decay(3e-3, step, 100, warmup=warmup))
        np.testing.assert_allclose(ours, theirs, rtol=OPT_TOL, atol=0)


def quad_loss(p):
    return ((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum()


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_optimizers_converge_on_quadratic(opt):
    """``tests/test_optim_ckpt.py``'s case, on the port."""
    params = {"w": torch.zeros(4), "b": torch.zeros(2)}
    state = optim.sgd_init(params) if opt == "sgd" \
        else optim.adamw_init(params)
    for _ in range(200):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(quad_loss(leaves),
                                                 list(leaves.values()))))
        if opt == "sgd":
            params, state = optim.sgd_update(params, g, state, 0.05, 0.5)
        else:
            params, state = optim.adamw_update(params, g, state, 0.05,
                                               wd=0.0)
    assert float(quad_loss(params)) < 1e-2


def test_cosine_decay_warmup_and_floor():
    """``tests/test_optim_ckpt.py``'s case, on the port."""
    assert float(optim.cosine_decay(1.0, 0, 100, warmup=10)) == \
        pytest.approx(0.0)
    assert float(optim.cosine_decay(1.0, 10, 100, warmup=10)) == \
        pytest.approx(1.0, rel=1e-3)
    assert float(optim.cosine_decay(1.0, 100, 100, warmup=10)) == \
        pytest.approx(0.0, abs=1e-6)


# ---------------------------------------------------------------------------
# fused cross entropy
# ---------------------------------------------------------------------------

def test_fused_cross_entropy_matches_naive_and_reference():
    """2 x 13 tokens in chunks of 16: two chunks, the second padded with
    ``ignore_id``; one label ignored.  Loss and both gradients against
    the naive loss of the full logits and the JAX package's fused one
    (``tests/test_models.py``'s case)."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 13, 32)).astype(np.float32)
    table = (rng.normal(size=(64, 32)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 64, size=(2, 13)).astype(np.int32)
    labels[1, 4] = -1

    def ours(fused):
        ht, tt = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (h, table))
        y = torch.from_numpy(labels)
        loss = layers.fused_cross_entropy(ht, tt, y, chunk=16) if fused \
            else layers.cross_entropy(layers.unembed({"table": tt}, ht), y)
        gh, gt = torch.autograd.grad(loss, [ht, tt])
        return float(loss.detach()), gh.numpy(), gt.numpy()

    def jfused(hh, tt):
        return jlayers.fused_cross_entropy(hh, tt, jnp.asarray(labels),
                                           chunk=16)

    jloss, jgrads = jax.jit(jax.value_and_grad(jfused, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(table))
    fused, naive = ours(True), ours(False)
    for got in (fused, naive):
        np.testing.assert_allclose(got[0], float(jloss), rtol=1e-6)
        for a, b in zip(got[1:], jgrads):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    np.testing.assert_allclose(fused[0], naive[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def check_steps(got, ref, optimizer):
    for (loss, params), (jloss, jparams) in zip(got, ref):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        gaps = param_gaps(params, jparams)
        if optimizer == "sgd":
            assert gaps.max() <= SGD_TOL, gaps.max()
        else:
            assert gaps.max() <= ADAMW_TOL, gaps.max()
            assert (gaps > SGD_TOL).mean() <= ADAMW_NOISY
    assert got[-1][0] != got[0][0]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_reference(reference, optimizer, microbatch,
                                      remat):
    init, ref = reference[(optimizer, microbatch)]
    check_steps(port_run(init, optimizer, microbatch, remat), ref,
                optimizer)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_on_full_logits_matches_reference(reference, optimizer):
    """``fused_ce=False``: the cross entropy of the whole (B, S, V)
    logits, against the JAX package's same option."""
    init, ref = reference[(optimizer, "logits")]
    check_steps(port_run(init, optimizer, 1, True, fused_ce=False), ref,
                optimizer)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_step_on_the_chunked_route_matches_reference(reference, remat):
    """SGD steps with attention over blocks of queries, each recomputed
    in the backward pass (nested in the layer's own checkpoint under
    remat), against the JAX package's ``chunked`` route; no kernel
    launches and the gradient flows."""
    init, ref = reference["chunked"]
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    check_steps(port_run(init, "sgd", 1, remat, backend="chunked"), ref,
                "sgd")
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_supernet_steps_with_a_key_each_match_reference(reference):
    """Every leaf moves as in the JAX package, a branch the step's key
    left out included; and the same steps with an unselected branch
    left unchanged would not match."""
    init, ref = reference["supernet"]
    got = port_run(init, "sgd", 1, True, keys=KEYS)
    for (loss, params), (jloss, jparams) in zip(got, ref):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        assert param_gaps(params, jparams).max() <= SGD_TOL
    # layer 1's branch 2 (index 1) was trained in step 0 and left out of
    # step 1, where its velocity still moved it
    before, after = (p["layers"]["mlp"]["wi"]["w"][1, 1]
                     for p in (ref[0][1], ref[1][1]))
    assert np.abs(after - before).max() > 100 * SGD_TOL


def test_unselected_branch_gets_a_zero_gradient_under_adamw():
    """AdamW's weight decay reaches a branch no key selected: it shrinks
    by lr x wd x p, as under ``jax.grad``'s zero gradient."""
    cfg = get_config(ARCH, smoke=True).replace(supernet=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    step = train.make_train_step(cfg, optimizer="adamw", lr=0.1)
    opt = train.init_opt(params, "adamw")
    x, y = batches(cfg, 1)[0]
    new, opt, _ = step(params, opt, {"tokens": torch.from_numpy(x),
                                     "labels": torch.from_numpy(y),
                                     "choice_key": [1, 0]})
    w = params["layers"][1][2]["mlp"]["wi"]["w"]
    torch.testing.assert_close(new["layers"][1][2]["mlp"]["wi"]["w"],
                               w - 0.1 * 0.01 * w, rtol=1e-6, atol=1e-9)
    assert int(opt["step"]) == 1


def test_microbatch_must_divide_the_batch():
    cfg = get_config(ARCH, smoke=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    step = train.make_train_step(cfg, microbatch=3)
    x, y = batches(cfg, 1)[0]
    with pytest.raises(ValueError, match="does not split"):
        step(params, train.init_opt(params),
             {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    with pytest.raises(ValueError, match="unknown optimizer"):
        train.make_train_step(cfg, optimizer="lion")


# ---------------------------------------------------------------------------
# the forward-only kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kernel", [
    ("qwen1.5-0.5b", "flash_attention"), ("mamba2-780m", "ssd_scan"),
    ("granite-moe-1b-a400m", "flash_attention")])
def test_kernel_route_refuses_a_gradient(arch, kernel):
    """A train step on ``backend="kernel"`` raises at its first step, on
    the CPU as on the card; without a gradient the route runs."""
    cfg = get_config(arch, smoke=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    x, y = batches(cfg, 1)[0]
    batch = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    step = train.make_train_step(cfg, backend="kernel")
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel is "
                                           "forward-only"):
        step(params, train.init_opt(params), batch)
    with torch.no_grad():
        loss = train.make_loss_fn(cfg, backend="kernel")(params, batch)
    assert torch.isfinite(loss)
    assert ops.LAUNCHES[kernel] == 0


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    q = torch.zeros(1, 8, 2, 8, requires_grad=True)
    k = torch.zeros(1, 8, 2, 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.expert_gemm(torch.zeros(1, 2, 3), torch.zeros(1, 3, 4,
                                                          requires_grad=True))
    experts = {n: torch.zeros(2, 3, 3, requires_grad=True)
               for n in ("wi", "wg", "wo")}
    with pytest.raises(RuntimeError, match="expert_gemm: the kernel"):
        ops.expert_ffn(experts, torch.zeros(2, 4, 3))
    xs = torch.zeros(1, 1, 4, 1, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.ssd_scan(xs, torch.zeros(1, 1, 4, 1), torch.zeros(1, 1, 4, 2),
                     torch.zeros(1, 1, 4, 2))
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape
    with torch.inference_mode():
        assert ops.flash_attention(q, k, k).shape == q.shape


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def test_train_main_runs_on_the_cpu(capsys):
    train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                "--seq", "16", "--optimizer", "sgd", "--lr", "0.1"])
    out = capsys.readouterr().out
    assert "on cpu, sgd" in out and "step    2 loss" in out


def test_train_main_takes_the_hybrid_on_the_chunked_route(capsys):
    train.main(["--arch", "zamba2-2.7b", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16", "--backend", "chunked"])
    out = capsys.readouterr().out
    assert "zamba2-2.7b (smoke) on cpu, adamw, chunked route" in out
    assert "step    1 loss" in out


@pytest.mark.parametrize("supernet", [False, True])
def test_train_lm_example_loss_decreases(capsys, supernet):
    train_lm.main(["--device", "cpu", "--steps", "8", "--batch", "4",
                   "--seq", "32", "--lr", "1e-2"]
                  + (["--supernet"] if supernet else []))
    assert "(decreased: OK)" in capsys.readouterr().out


def test_drivers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for main in (train.main, train_lm.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
