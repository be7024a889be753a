"""repro_torch kernels: fill-aggregation's plain version and both
Algorithm 3 routes against the JAX package, the wrappers' checks, and —
on a CUDA card only — the hand-written kernels (fill-aggregation, int8
quantize and dequantize) against their plain versions.

Tolerances: float32 sums of at most 8 terms taken in another order, so
1e-6 (rtol and atol) for the flat function; the tree routes add the
float32 rounding of ``w / total`` and are held at 1e-6 too.  The int8
kernels are held bit for bit (tests/test_torch_comm.py holds the plain
versions bit for bit against the JAX package).
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-6


def rand_inputs(m, p, seed=0):
    rng = np.random.default_rng(seed)
    cl = rng.normal(size=(m, p)).astype(np.float32)
    mk = rng.integers(0, 2, size=(m, p)).astype(np.float32)
    w = rng.random(m).astype(np.float32)
    w = w / w.sum()
    prev = rng.normal(size=(p,)).astype(np.float32)
    return cl, mk, w, prev


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jax, jops, jref


@pytest.mark.parametrize("m,p", [(2, 1000), (8, 8192), (5, 100000)])
def test_plain_fill_aggregate_matches_reference(jax_ref, m, p):
    jax, jops, jref = jax_ref
    import jax.numpy as jnp
    cl, mk, w, prev = rand_inputs(m, p, seed=m)
    args = [jnp.asarray(a) for a in (cl, mk, w, prev)]
    ours = ops.fill_aggregate(*map(torch.from_numpy, (cl, mk, w, prev)))
    assert ours.dtype == torch.float32 and ours.shape == (p,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jref.fill_aggregate(*args)),
                               rtol=TOL, atol=TOL)
    # the Pallas kernel, run in interpret mode as the JAX package's tests do
    np.testing.assert_allclose(ours.numpy(), np.asarray(jops.fill_aggregate(*args)),
                               rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def uploads(jax_ref):
    """Smoke-size master and three perturbed uploads with their keys, in
    both packages' layouts."""
    jax = jax_ref[0]
    from repro.configs import get_config as ref_get_config
    from repro.core import make_api
    from repro_torch.convert import params_from_reference, \
        params_to_reference
    from repro_torch.core.aggregate import cnn_trained_mask
    ref_api = make_api(ref_get_config("cifar-supernet", smoke=True))
    prev_ref = jax.tree.map(np.asarray, ref_api.init(jax.random.PRNGKey(1)))
    prev = params_from_reference(prev_ref)
    rng = np.random.default_rng(2)
    ups, ups_ref = [], []
    for key, w in (([1, 0, 2, 3], 40.0), ([1, 3, 3, 0], 60.0),
                   ([2, 2, 1, 1], 20.0)):
        key = np.asarray(key, np.int32)
        p = {k: v + torch.from_numpy(
            rng.normal(size=v.shape).astype(np.float32))
            for k, v in prev.items()}
        ups.append((p, cnn_trained_mask(p, key), w))
        p_ref = jax.tree.map(jax.numpy.asarray, params_to_reference(p))
        ups_ref.append((p_ref, ref_api.trained_mask(p_ref, key), w))
    return prev, prev_ref, ups, ups_ref


@pytest.mark.parametrize("ours,theirs", [("torch", "xla"),
                                         ("kernel", "pallas"),
                                         ("kernel", "xla")])
def test_tree_routes_match_reference(jax_ref, uploads, ours, theirs):
    jax = jax_ref[0]
    from repro.core.aggregate import fill_aggregate as ref_fill
    from repro_torch.convert import params_to_reference
    from repro_torch.core.aggregate import fill_aggregate
    prev, prev_ref, ups, ups_ref = uploads
    before = ops.LAUNCHES["fill_aggregate"]
    out = fill_aggregate(prev, ups, backend=ours)
    # on the CPU the wrapper takes the plain version: no kernel launch
    assert ops.LAUNCHES["fill_aggregate"] == before == 0
    assert list(out) == list(prev)
    assert all(out[k].shape == prev[k].shape for k in prev)
    exp = ref_fill(jax.tree.map(jax.numpy.asarray, prev_ref), ups_ref,
                   backend=theirs)
    for a, b in zip(jax.tree.leaves(exp),
                    jax.tree.leaves(params_to_reference(out))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=TOL, atol=TOL)


def test_unknown_route_raises(uploads):
    from repro_torch.core.aggregate import fill_aggregate
    prev, _, ups, _ = uploads
    with pytest.raises(ValueError, match="unknown aggregate backend"):
        fill_aggregate(prev, ups, backend="pallas")


@pytest.mark.parametrize("case", ["dtype", "shape_masks", "shape_weights",
                                  "shape_prev", "rank", "contiguous",
                                  "empty", "mixed_devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    cl, mk, w, prev = map(torch.from_numpy, rand_inputs(3, 64))
    args = {"dtype": (cl.double(), mk, w, prev),
            "shape_masks": (cl, mk[:, :32], w, prev),
            "shape_weights": (cl, mk, w[:2], prev),
            "shape_prev": (cl, mk, w, prev[:63]),
            "rank": (cl, mk, w, prev[None]),
            "contiguous": (torch.zeros(64, 3).t(), mk, w, prev),
            "empty": (cl[:0], mk[:0], w[:0], prev),
            "mixed_devices": (cl, mk, w, prev.to("meta"))}[case]
    with pytest.raises((TypeError, ValueError)):
        ops.fill_aggregate(*args)
    assert ops.LAUNCHES["fill_aggregate"] == 0


@pytest.mark.parametrize("fn", ["quantize_int8", "dequantize_int8"])
@pytest.mark.parametrize("case", ["dtype", "scale_dtype", "rank", "empty",
                                  "scale_shape", "contiguous",
                                  "mixed_devices"])
def test_int8_wrappers_reject_what_the_kernels_do_not_take(fn, case):
    src = (torch.ones(64) if fn == "quantize_int8"
           else torch.ones(64, dtype=torch.int8))
    other = src.to(torch.float64 if fn == "quantize_int8" else torch.int32)
    s = torch.tensor(0.5)
    args = {"dtype": (other, s),
            "scale_dtype": (src, s.double()),
            "rank": (src.view(8, 8), s),
            "empty": (src[:0], s),
            "scale_shape": (src, torch.ones(2)),
            "contiguous": (src[::2], s),
            "mixed_devices": (src, s.to("meta"))}[case]
    with pytest.raises((TypeError, ValueError)):
        getattr(ops, fn)(*args)
    assert ops.LAUNCHES[fn] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,p", [(1, 1000), (2, 8193), (5, 100000),
                                 (8, 1 << 20)])
def test_cuda_kernel_matches_plain_version(cuda, m, p):
    cl, mk, w, prev = (torch.from_numpy(a).to(cuda)
                       for a in rand_inputs(m, p, seed=p))
    if m > 1:
        w[0] = 0.0                  # a zero-weight row adds nothing
    before = ops.LAUNCHES["fill_aggregate"]
    out = ops.fill_aggregate(cl, mk, w, prev)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fill_aggregate"] == before + 1
    assert out.device.type == "cuda" and out.shape == (p,)
    torch.testing.assert_close(out, ref.fill_aggregate(cl, mk, w, prev),
                               rtol=TOL, atol=TOL)
    # all-zero masks: the output is prev, weighted to sum(w)
    zeros = torch.zeros_like(mk)
    w1 = w / w.sum()
    torch.testing.assert_close(ops.fill_aggregate(cl, zeros, w1, prev), prev,
                               rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 1000, 8193, 100003, 2_359_296])
def test_cuda_int8_kernels_match_plain_version(cuda, p):
    g = torch.Generator(device=cuda).manual_seed(p)
    x = torch.randn(p, device=cuda, generator=g)
    # a power-of-two scale below max|x| / 127: exact ties and clipping
    scale = torch.tensor(2.0 ** -6, device=cuda)
    x[: p // 4] = torch.round(x[: p // 4] / scale) * scale + scale / 2
    x[-1] = 10.0
    before = dict(ops.LAUNCHES)
    q = ops.quantize_int8(x, scale)
    d = ops.dequantize_int8(q, scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quantize_int8"] == before["quantize_int8"] + 1
    assert ops.LAUNCHES["dequantize_int8"] == before["dequantize_int8"] + 1
    assert q.dtype == torch.int8 and q.device.type == "cuda"
    assert torch.equal(q, ref.quantize_int8(x, scale))
    assert torch.equal(d.view(torch.int32),
                       ref.dequantize_int8(q, scale).view(torch.int32))
    assert int(q[-1]) == 127               # 640 clips
