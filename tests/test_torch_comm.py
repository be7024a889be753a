"""repro_torch payload codecs against the JAX package's ``repro.comm``.

Codec functions are held **bit for bit** on identical numpy inputs: the
int8 grid (plain route, and the kernel route's CPU path, against
``repro.kernels.ref`` and the Pallas kernel in interpret mode — exact
ties, zeros, clipping, bf16-sourced values), the bf16/fp16 casts, top-k
(ties resolve to the lower index, as ``lax.top_k`` does), wire bytes,
and three error-feedback steps of ``CodecBackend._up`` (sent trees and
residuals).

Whole ``RealTimeNas`` runs (4 clients, 240 samples, population 4, 2
generations, lr0 0.01) are held against the JAX ``loop`` backend under
the uplink/downlink pairs ``("int8", "int8")`` — on both of the port's
int8 routes, since the JAX package's ``"int8"`` and ``"int8:pallas"``
compute the same grid — and ``("topk:0.25", "cast")``: keys and
``CommStats`` equal, objectives within 1e-5, masters within
``1e-4 + one codec step of the leaf``.  The codec step is there because
the packages' float gap (up to 3.2e-5 without codecs, the ReLU-kink
caveat of tests/test_torch_engine.py) can move an entry across a
rounding boundary of the downlink codec, which then moves it by one step
of that leaf's grid: ``max|leaf| / 127`` for int8, ``max|leaf| * 2**-8``
for bf16.  Measured on the CPU: 7.8e-6 (int8, either route) and 2.6e-4
(top-k up / bf16 down: one bf16 step of a leaf whose largest entry is
about 0.07).
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

from repro.comm import make_codec as ref_make_codec  # noqa: E402
from repro.comm.backend import CodecBackend as RefCodecBackend  # noqa: E402
from repro.comm.quantize import leaf_scale as ref_leaf_scale  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import make_api  # noqa: E402
from repro.data import make_classification as ref_make_classification  # noqa: E402,E501
from repro.data import make_clients as ref_make_clients  # noqa: E402
from repro.data import partition_iid as ref_partition_iid  # noqa: E402
from repro.engine import FedEngine as RefEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.comm import CastCodec, CodecBackend, ErrorFeedback, \
    Int8Codec, PayloadCodec, TopKCodec, make_codec  # noqa: E402
from repro_torch.comm.quantize import leaf_scale  # noqa: E402
from repro_torch.comm.sparsify import leaf_k  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference, \
    params_to_reference  # noqa: E402
from repro_torch.core import cnn_supernet_api  # noqa: E402
from repro_torch.data import make_classification, make_clients, \
    partition_iid  # noqa: E402
from repro_torch.engine import FedEngine, RunConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the port's spec -> the JAX package's spec computing the same function
SAME_AS_REF = {"none": "none", "cast": "cast", "cast:bf16": "cast:bf16",
               "cast:fp16": "cast:fp16", "int8": "int8",
               "int8:kernel": "int8:pallas", "int8:torch": "int8",
               "topk": "topk", "topk:0.25": "topk:0.25",
               "topk:0.01": "topk:0.01", "topk:1.0": "topk:1.0"}


def bits(a) -> np.ndarray:
    """Raw bits of a float32/int8 array, so -0.0 != 0.0 and NaN == NaN."""
    a = np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor)
                             else np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_trees_bitwise(ours, theirs):
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_array_equal(bits(ours[k]), bits(theirs[k]),
                                      err_msg=k)


def mixed_tree(seed=0):
    """A few leaves of different sizes and magnitudes, one all-zero."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(513,)).astype(np.float32),
            "b": (rng.normal(size=(8, 33)) * 100).astype(np.float32),
            "c": np.zeros((7,), np.float32),
            "d": (rng.standard_cauchy(size=(4, 3, 3, 5)) * 1e-3
                  ).astype(np.float32)}


def roundtrip_both(spec, tree):
    ours = make_codec(spec).roundtrip(
        {k: torch.from_numpy(v.copy()) for k, v in tree.items()})
    theirs = ref_make_codec(SAME_AS_REF[spec]).roundtrip(
        {k: jnp.asarray(v) for k, v in tree.items()})
    return ours, {k: np.asarray(v) for k, v in theirs.items()}


# ---------------------------------------------------------------------------
# int8: the plain route and the wrappers' CPU path, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 1000, 8193, 100003])
def test_int8_grid_matches_reference(p, source):
    rng = np.random.default_rng(p)
    x = rng.normal(size=(p,)).astype(np.float32)
    if source == "bfloat16":            # values that came through bf16
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    xt = torch.from_numpy(x)
    scale = leaf_scale(xt)
    j_scale = jax.jit(ref_leaf_scale)(jnp.asarray(x))
    np.testing.assert_array_equal(bits(scale.reshape(1)),
                                  bits(np.asarray(j_scale).reshape(1)))
    q = ref.quantize_int8(xt, scale)
    assert q.dtype == torch.int8 and q.shape == (p,)
    np.testing.assert_array_equal(ops.quantize_int8(xt, scale).numpy(),
                                  q.numpy())
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax.jit(jref.quantize_int8)(jx, j_scale)))
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jops.quantize_int8(jx, j_scale)))   # Pallas
    d = ref.dequantize_int8(q, scale)
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(bits(ops.dequantize_int8(q, scale)),
                                  bits(d))
    jq = jnp.asarray(q.numpy())
    np.testing.assert_array_equal(
        bits(d), bits(jax.jit(jref.dequantize_int8)(jq, j_scale)))
    np.testing.assert_array_equal(
        bits(d), bits(jops.dequantize_int8(jq, j_scale)))
    # roundtrip error bound: half a quantization step
    assert float((d - xt).abs().max()) <= float(scale) / 2 + 1e-7
    assert ops.LAUNCHES["quantize_int8"] == ops.LAUNCHES[
        "dequantize_int8"] == 0


def test_int8_exact_ties_zeros_and_clipping():
    # a power-of-two scale puts x / s exactly on k + 0.5: every entry is
    # a tie, which rounds half to even
    s = np.float32(2.0 ** -4)
    k = np.arange(-130, 130, dtype=np.float32)
    x = np.concatenate([(k + 0.5) * s, k * s, [0.0, -0.0],
                        [1e6, -1e6, 127.5 * s, -127.5 * s, 128 * s]]
                       ).astype(np.float32)
    expect = np.clip(np.round(x / s), -127, 127).astype(np.int8)  # half-even
    xt, st = torch.from_numpy(x), torch.tensor(s)
    q = ops.quantize_int8(xt, st)
    np.testing.assert_array_equal(q.numpy(), expect)
    np.testing.assert_array_equal(ref.quantize_int8(xt, st).numpy(), expect)
    jx, js = jnp.asarray(x), jnp.float32(s)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jref.quantize_int8)(jx, js)), expect)
    np.testing.assert_array_equal(np.asarray(jops.quantize_int8(jx, js)),
                                  expect)
    # the JAX package's own fixed examples (tests/test_kernels.py)
    small = torch.tensor([0.0, 1.0, -1.0, 0.5, -0.49])
    s127 = torch.tensor(1.0 / 127.0)
    assert ops.quantize_int8(small, s127).tolist() == [0, 127, -127, 64, -62]
    assert ops.quantize_int8(torch.tensor([10.0, -10.0]),
                             s127).tolist() == [127, -127]


def test_int8_all_zero_leaf_roundtrips_to_zeros():
    ours = make_codec("int8").roundtrip({"w": torch.zeros(5)})
    assert float(leaf_scale(torch.zeros(5))) > 0
    np.testing.assert_array_equal(bits(ours["w"]), bits(np.zeros(5,
                                                                 np.float32)))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_int8_tree_route_matches_per_leaf_route_and_reference(offset):
    """The kernel route quantizes the whole tree at once, over one flat
    layout; with leaves that are views of one flat vector (as K1 returns
    the master) it still equals the per-leaf route and the JAX package's
    Pallas roundtrip bit for bit."""
    from repro.comm.quantize import _roundtrip_pallas
    tree = mixed_tree()
    flat = torch.zeros(offset + sum(v.size for v in tree.values()))
    views, off = {}, offset
    for k, v in tree.items():
        views[k] = flat[off: off + v.size].view(v.shape)
        views[k].copy_(torch.from_numpy(v))
        off += v.size
    ours = make_codec("int8:kernel").roundtrip(views)
    per_leaf = make_codec("int8:torch").roundtrip(views)
    theirs = _roundtrip_pallas({k: jnp.asarray(v) for k, v in tree.items()})
    assert_trees_bitwise(ours, per_leaf)
    assert_trees_bitwise(ours, {k: np.asarray(v) for k, v in theirs.items()})
    assert all(ours[k].shape == tree[k].shape for k in tree)
    assert all(n == 0 for n in ops.LAUNCHES.values())    # CPU: no kernel


def test_int8_tree_route_outputs_are_independent():
    """The reconstructed leaves are views of one flat buffer, in disjoint
    segments: writing one changes no other, nor the input."""
    tree = {k: torch.from_numpy(v) for k, v in mixed_tree(1).items()}
    inputs = {k: v.clone() for k, v in tree.items()}
    out = make_codec("int8:kernel").roundtrip(tree)
    kept = {k: v.clone() for k, v in out.items()}
    out["b"].fill_(7.0)
    assert all(torch.equal(out[k], kept[k]) for k in out if k != "b")
    assert all(torch.equal(tree[k], inputs[k]) for k in tree)
    assert len({v.untyped_storage().data_ptr() for v in out.values()}) == 1


# ---------------------------------------------------------------------------
# every codec's roundtrip and wire bytes against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["int8", "int8:kernel", "int8:torch",
                                  "cast", "cast:fp16", "topk:0.25",
                                  "topk:0.01", "topk:1.0", "none"])
def test_roundtrip_matches_reference_bitwise(spec):
    ours, theirs = roundtrip_both(spec, mixed_tree())
    assert_trees_bitwise(ours, theirs)


def test_topk_ties_resolve_to_the_lower_index():
    x = np.array([1.0, -2.0, 2.0, 0.5, -2.0, 2.0, 1.0, -1.0],
                 np.float32)
    ours, theirs = roundtrip_both("topk:0.25", {"w": x})   # k = 2
    np.testing.assert_array_equal(ours["w"].numpy(),
                                  [0, -2, 2, 0, 0, 0, 0, 0])
    assert_trees_bitwise(ours, theirs)
    # many ties at every k
    rng = np.random.default_rng(3)
    y = rng.choice(np.float32([-1, 1, 0.5, -0.5, 0]), size=999)
    for ratio in ("0.01", "0.25", "1.0"):
        assert_trees_bitwise(*roundtrip_both(f"topk:{ratio}",
                                             {"w": y.astype(np.float32)}))


@pytest.mark.parametrize("spec", sorted(SAME_AS_REF))
@pytest.mark.parametrize("n", [1, 7, 67181, 26_119_059])
def test_wire_bytes_match_reference(spec, n):
    assert make_codec(spec).wire_bytes(n) == \
        ref_make_codec(SAME_AS_REF[spec]).wire_bytes(n)


def test_make_codec_specs():
    assert make_codec("none") == PayloadCodec() and \
        make_codec("none").is_identity
    assert make_codec("cast") == make_codec("cast:bf16") == \
        CastCodec(dtype="bf16")
    assert make_codec("cast:fp16") == CastCodec(dtype="fp16")
    # the kernel route is the default, as for aggregate_backend
    assert make_codec("int8") == make_codec("int8:kernel") == \
        Int8Codec(backend="kernel")
    assert make_codec("int8:torch") == Int8Codec(backend="torch")
    assert make_codec("topk") == TopKCodec(ratio=0.1)
    assert make_codec("topk:0.25") == TopKCodec(ratio=0.25)
    assert leaf_k(10, 0.25) == 2 and leaf_k(3, 0.01) == 1  # round(2.5) == 2
    for spec in ("cast", "int8", "topk"):
        assert not make_codec(spec).is_identity


@pytest.mark.parametrize("spec", [
    "none", "cast", "cast:bf16", "cast:fp16", "int8", "int8:kernel",
    "int8:torch", "topk", "topk:0.25"])
def test_run_config_accepts(spec):
    cfg = RunConfig(uplink_codec=spec, downlink_codec=spec, device="cpu")
    assert cfg.uplink_codec == cfg.downlink_codec == spec


@pytest.mark.parametrize("spec", [
    "int8:pallas", "int8:xla", "int8:gpu", "topk:0", "topk:2.0", "topk:x",
    "cast:f8", "bogus", "", "none:x"])
def test_run_config_rejects(spec):
    with pytest.raises(ValueError, match="codec|ratio|route|dtype"):
        RunConfig(uplink_codec=spec)
    with pytest.raises(ValueError):
        RunConfig(downlink_codec=spec)


# ---------------------------------------------------------------------------
# error feedback: the uplink stream against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["int8", "int8:torch", "topk:0.25",
                                  "cast", "cast:fp16"])
@pytest.mark.parametrize("stream", ["fill", None])
def test_uplink_steps_match_reference(spec, stream):
    """Three ``CodecBackend._up`` steps on identical trees: equal
    reconstructed masters and residuals, bit for bit."""
    ours = CodecBackend(None, make_codec(spec), make_codec("none"))
    theirs = RefCodecBackend(None, ref_make_codec(SAME_AS_REF[spec]),
                             ref_make_codec("none"))
    rng = np.random.default_rng(7)
    down = mixed_tree(1)
    for _ in range(3):
        raw = {k: (v + rng.normal(size=v.shape) * 0.05).astype(np.float32)
               for k, v in down.items()}
        a = ours._up({k: torch.from_numpy(v) for k, v in down.items()},
                     {k: torch.from_numpy(v) for k, v in raw.items()},
                     stream)
        b = theirs._up({k: jnp.asarray(v) for k, v in down.items()},
                       {k: jnp.asarray(v) for k, v in raw.items()}, stream)
        assert_trees_bitwise(a, {k: np.asarray(v) for k, v in b.items()})
        if stream is not None:
            assert_trees_bitwise(
                ours._ef[stream].residual,
                {k: np.asarray(v)
                 for k, v in theirs._ef[stream].residual.items()})
        down = {k: v.numpy() for k, v in a.items()}
    ours.reset()
    assert all(ef.residual is None for ef in ours._ef.values())


@pytest.mark.parametrize("spec", ["topk:0.1", "int8", "cast"])
def test_error_feedback_telescopes(spec):
    """sum_t sent_t == sum_t delta_t - residual_T: the cumulative bias is
    one single-step compression error, not O(T) of them."""
    rng = np.random.default_rng(4)
    ef = ErrorFeedback(make_codec(spec))
    true_sum = torch.zeros(257)
    sent_sum = torch.zeros(257)
    for _ in range(30):
        delta = torch.from_numpy((rng.normal(size=257) * 0.1)
                                 .astype(np.float32))
        sent_sum += ef.step({"w": delta})["w"]
        true_sum += delta
    torch.testing.assert_close(true_sum - sent_sum, ef.residual["w"],
                               rtol=0, atol=1e-4)


def test_error_feedback_identity_codec_is_exact():
    ef = ErrorFeedback(make_codec("none"))
    d = {"w": torch.arange(4.0)}
    assert ef.step(d)["w"] is d["w"] and ef.residual is None


def test_codecs_pass_integer_leaves_through():
    tree = {"w": torch.ones(16), "step": torch.tensor([3], dtype=torch.int32)}
    for spec in ("cast", "int8", "int8:torch", "topk:0.5"):
        assert make_codec(spec).roundtrip(tree)["step"].tolist() == [3]


# ---------------------------------------------------------------------------
# whole RealTimeNas runs against the JAX loop backend
# ---------------------------------------------------------------------------

RUN = dict(population=4, generations=2, seed=0, lr0=0.01)
PAIRS = {"int8": ("int8", "int8"), "int8:torch": ("int8:torch", "int8:torch"),
         "topk/cast": ("topk:0.25", "cast")}
REF_PAIRS = {"int8": ("int8", "int8"), "int8:torch": ("int8", "int8"),
             "topk/cast": ("topk:0.25", "cast")}
MASTER_ATOL = 1e-4


def tiny_clients(mod_classification, mod_clients, mod_partition,
                 num_clients=4, n=240, seed=0):
    x, y = mod_classification(seed, n, image=8, signal=1.5, noise=0.5)
    return mod_clients(x, y, mod_partition(seed, n, num_clients),
                       batch=20, test_batch=20)


@pytest.fixture(scope="module")
def rt_runs():
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=True))
    init = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(0)))
    api = dataclasses.replace(
        cnn_supernet_api(get_config("cifar-supernet", smoke=True)),
        init=lambda g: params_from_reference(init))
    ref_clients = tiny_clients(ref_make_classification, ref_make_clients,
                               ref_partition_iid)
    clients = tiny_clients(make_classification, make_clients, partition_iid)
    refs = {}
    for up, down in dict.fromkeys(REF_PAIRS.values()):
        refs[(up, down)] = RefEngine(ref_api, ref_clients, RefRunConfig(
            backend="loop", aggregate_backend="xla", uplink_codec=up,
            downlink_codec=down, **RUN)).run()
    out = {}
    for name, (up, down) in PAIRS.items():
        eng = FedEngine(api, clients, RunConfig(
            device="cpu", uplink_codec=up, downlink_codec=down, **RUN))
        first = eng.run()
        again = eng.run()
        out[name] = (refs[REF_PAIRS[name]], first, again)
    return out


def codec_step_atol(ref_leaf, spec):
    """1e-4 plus one step of the downlink codec's grid for this leaf."""
    m = float(np.abs(ref_leaf).max())
    return MASTER_ATOL + (m / 127 if spec.startswith("int8")
                          else m * 2.0 ** -8)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_codec_run_keys_and_objectives_match_reference(rt_runs, name):
    ref_run, ours, _ = rt_runs[name]
    assert len(ours.reports) == len(ref_run.reports) == 2
    for a, b in zip(ref_run.reports, ours.reports):
        for ka, kb in zip(a.parent_keys, b.parent_keys):
            np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(a.best_key, b.best_key)
        np.testing.assert_array_equal(a.knee_key, b.knee_key)
        np.testing.assert_allclose(a.objs, b.objs, atol=1e-5)
        assert (a.down_gb, a.up_gb) == (b.down_gb, b.up_gb)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_codec_run_comm_stats_are_byte_identical(rt_runs, name):
    ref_run, ours, _ = rt_runs[name]
    assert dataclasses.asdict(ref_run.stats) == dataclasses.asdict(ours.stats)
    assert ours.stats.up_wire_bytes < ours.stats.up_bytes
    assert ours.stats.down_wire_bytes < ours.stats.down_bytes


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_codec_run_master_within_tolerance(rt_runs, name):
    ref_run, ours, _ = rt_runs[name]
    down = PAIRS[name][1]
    ref_leaves = jax.tree.leaves(ref_run.extras["final_master"])
    our_leaves = jax.tree.leaves(
        params_to_reference(ours.extras["final_master"]))
    for a, b in zip(ref_leaves, our_leaves):
        a = np.asarray(a)
        assert float(np.abs(a - b).max()) <= codec_step_atol(a, down)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_codec_run_is_reentrant(rt_runs, name):
    """EF residuals reset per run(): two runs of one engine match."""
    _, first, again = rt_runs[name]
    assert dataclasses.asdict(first.stats) == dataclasses.asdict(again.stats)
    m1, m2 = first.extras["final_master"], again.extras["final_master"]
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_int8_routes_agree_and_cpu_runs_launch_no_kernel(rt_runs):
    a = rt_runs["int8"][1].extras["final_master"]
    b = rt_runs["int8:torch"][1].extras["final_master"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(ops.LAUNCHES) >= {"fill_aggregate", "quantize_int8",
                                 "dequantize_int8"}
    assert all(n == 0 for n in ops.LAUNCHES.values())
