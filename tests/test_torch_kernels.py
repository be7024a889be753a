"""repro_torch kernels: the plain versions of fill-aggregation, flash
attention, the SSD chunk scan and the grouped expert GEMM against the
JAX package (its pure-jnp oracles and its Pallas kernels in interpret
mode), the chunked scan's stages as the torch route computes them
(``ssd_chunked_torch``: one chunk, no decay, strong decay, a padded
tail, an initial state), both Algorithm 3 routes, the wrappers' checks,
flash attention's and the expert GEMM's choice of kernel, the SSD
scan's stage table, the build's cache key, the split-P product of the
tensor-core flash attention, and — on a CUDA card only — the
hand-written kernels (fill-aggregation, int8 quantize and dequantize,
flash attention on its three kernels, the SSD chunk scan's stage kernels
(without decay also against a float64 recurrence), expert GEMM on its
four kernels) against their plain versions, bit for bit on a repeat
where they take no atomics, with their launch counts.

Tolerances: float32 sums of at most 8 terms taken in another order, so
1e-6 (rtol and atol) for the flat function; the tree routes add the
float32 rounding of ``w / total`` and are held at 1e-6 too.  The int8
kernels are held bit for bit (tests/test_torch_comm.py holds the plain
versions bit for bit against the JAX package).  Flash attention and the
SSD scan take the JAX package's own kernel tolerances
(tests/test_kernels.py): rtol 2e-5 / atol 1e-4 in float32 and rtol 2e-2
/ atol 1e-1 in bfloat16 (one bf16 rounding of the output can flip), and
rtol = atol = 2e-4 for the scan (chunked against sequential sums).
The expert GEMM takes the JAX sweep's (rtol 2e-5 / atol 2e-4 in float32,
2e-2 / 2e-1 in bfloat16, on outputs divided by their largest magnitude);
on the card, against its plain version, rtol = atol = 1e-5 in float32
(float32 sums of up to 1024 exact products in another order) and rtol
2^-7 / atol 1e-3 in bfloat16 (one rounding of the output), after the
same division.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import expert_gemm as egemm  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import quantize as kq  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models.ssm import ssd_chunked_torch  # noqa: E402

TOL = 1e-6
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # atol: 5x
# the CUDA kernel against its plain version, (rtol, atol): both compute in
# float32 and round the output once, so in bfloat16 they differ by at most
# one rounding of the output (2^-7 of its magnitude)
KERNEL_FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2 ** -7, 1e-3)}
SSD_TOL = 2e-4
FLASH_SHAPES = [(2, 128, 4, 4, 64), (1, 256, 4, 2, 128),
                (1, 384, 6, 1, 64)]               # MQA, S = 3 x 128
MASKS = [(True, 0), (True, 64), (False, 0)]
SSD_SHAPES = [(2, 4, 64, 3, 32, 16), (1, 2, 128, 2, 64, 64),
              (1, 8, 32, 1, 16, 8)]
# (E, C, D, F): the JAX package's sweep, then ragged tiles (C, F and D
# no multiple of 128; the Pallas kernel takes them as one block each)
GEMM_SHAPES = [(2, 128, 256, 128), (4, 256, 256, 384), (1, 128, 512, 256),
               (2, 100, 200, 72), (3, 8, 200, 72)]
GEMM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # atol: 10x
KERNEL_GEMM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-3)}


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


@pytest.mark.parametrize("m,p", [(1, 1000), (3, 8193)])
def test_plain_fill_aggregate_in_place(m, p):
    """``donate_prev`` on the CPU: the plain version written over prev,
    which is returned (same storage), equal bit for bit to the
    out-of-place result; no kernel launches."""
    cl, mk, w, prev = map(torch.from_numpy, rand_inputs(m, p, seed=p))
    want = ops.fill_aggregate(cl, mk, w, prev)
    keep = prev.clone()
    ptr = prev.data_ptr()
    before = dict(ops.LAUNCHES)
    out = ops.fill_aggregate(cl, mk, w, prev, donate_prev=True)
    assert out is prev and out.data_ptr() == ptr
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(prev, keep)          # prev itself was written
    again = keep.clone()
    ref.fill_aggregate_(cl, mk, w, again)
    assert torch.equal(again, want)
    assert ops.LAUNCHES == before


def flash_np(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32))


def ssd_np(b, nc, q, h, p, n, seed, decay=0.1):
    """xs, a, bm, cm of K4's layout; a = -|normal| x ``decay``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nc, q, h, p)).astype(np.float32),
            (-np.abs(rng.normal(size=(b, nc, q, h))) * decay).astype(
                np.float32),
            rng.normal(size=(b, nc, q, n)).astype(np.float32),
            rng.normal(size=(b, nc, q, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_flash_attention_matches_reference(jax_ref, dtype, b, s, h,
                                                 kh, d, causal, window):
    _, jops, jref = jax_ref
    import jax.numpy as jnp
    arrs = flash_np(b, s, h, kh, d, seed=s + h + kh)
    ours = ops.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
        causal=causal, window=window)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (b, s, h, d)
    assert ops.LAUNCHES["flash_attention"] == 0
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tol = FLASH_TOL[dtype]
    for fn in (jref.flash_attention, jops.flash_attention):
        exp = fn(*jargs, causal=causal, window=window)
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(exp, np.float32),
                                   rtol=tol, atol=5 * tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d", [(1, 200, 4, 2, 64),
                                         (1, 1000, 2, 2, 80)])
def test_flash_wrapper_takes_a_ragged_last_tile(jax_ref, dtype, b, s, h, kh,
                                                d):
    """S past 128 and no multiple of it (zamba2's prompts of 1000
    tokens), which the TPU kernel asserts against and the CUDA kernels
    mask: the wrapper's plain version against the JAX package's
    oracle."""
    _, _, jref = jax_ref
    import jax.numpy as jnp
    arrs = flash_np(b, s, h, kh, d, seed=s)
    ours = ops.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
        window=64)
    assert ours.shape == (b, s, h, d)
    assert ops.LAUNCHES["flash_attention"] == 0
    tol = FLASH_TOL[dtype]
    exp = jref.flash_attention(*(jnp.asarray(a, getattr(jnp, dtype))
                                 for a in arrs), window=64)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=5 * tol)


@pytest.mark.parametrize("b,nc,q,h,p,n", SSD_SHAPES)
def test_plain_ssd_scan_matches_reference(jax_ref, b, nc, q, h, p, n):
    _, jops, jref = jax_ref
    import jax.numpy as jnp
    arrs = ssd_np(b, nc, q, h, p, n, seed=q + p)
    y, st = ops.ssd_scan(*map(torch.from_numpy, arrs))
    assert y.shape == (b, nc, q, h, p) and st.shape == (b, h, p, n)
    assert ops.LAUNCHES["ssd_scan"] == 0
    jargs = [jnp.asarray(a) for a in arrs]
    for fn in (jref.ssd_scan, jops.ssd_scan):
        y_r, s_r = fn(*jargs)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r),
                                   rtol=SSD_TOL, atol=SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(s_r),
                                   rtol=SSD_TOL, atol=SSD_TOL)


# edge cases of the chunked scan, (shape, decay, padded rows): one chunk,
# no decay, strong decay (a about -50 a step: exp(-acum) would overflow
# float32 within two steps if L were factored), and a padded tail (the
# model pads a prompt to whole chunks with dt = 0, so x, a, B and C are 0)
SSD_EDGES = {"one_chunk": ((1, 1, 32, 1, 16, 8), 0.1, 0),
             "no_decay": ((1, 8, 32, 1, 16, 8), 0.0, 0),
             "strong_decay": ((1, 8, 32, 1, 16, 8), 60.0, 0),
             "padded_tail": ((1, 8, 32, 1, 16, 8), 0.1, 20)}


def ssd_edge_np(case):
    shape, decay, pad = SSD_EDGES[case]
    xs, a, bm, cm = ssd_np(*shape, seed=11, decay=decay)
    if pad:
        for arr in (xs, a, bm, cm):
            arr[:, -1, -pad:] = 0.0
    return xs, a, bm, cm


@pytest.mark.parametrize("case", sorted(SSD_EDGES))
def test_ssd_chunked_torch_matches_reference(jax_ref, case):
    """The stages K4's kernels implement, as the torch route computes
    them (``models/ssm.ssd_chunked_torch``, on K4's layout), == the
    sequential recurrence (``ref.ssd_scan``) and the JAX package's
    oracle and Pallas kernel (interpret mode; at the sweep's shape
    (1, 8, 32, 1, 16, 8), which the Pallas kernel has compiled; the one
    chunk, a shape of its own, against the oracle alone)."""
    _, jops, jref = jax_ref
    import jax.numpy as jnp
    arrs = ssd_edge_np(case)
    b, nc, q, h, p = arrs[0].shape
    y, st = ssd_chunked_torch(*map(torch.from_numpy, arrs))
    assert y.shape == (b, nc, q, h, p) and st.shape == (b, h, p, 8)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_p, s_p = ops.ssd_scan(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), s_p.numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)
    assert ops.LAUNCHES["ssd_scan"] == 0
    assert not any(kssd.STAGE_LAUNCHES.values())
    jargs = [jnp.asarray(arr) for arr in arrs]
    fns = (jref.ssd_scan,) if nc == 1 else (jref.ssd_scan, jops.ssd_scan)
    for fn in fns:
        y_r, s_r = fn(*jargs)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r),
                                   rtol=SSD_TOL, atol=SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(s_r),
                                   rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_chunked_torch_padded_rows_keep_the_state():
    """Rows with x = a = B = C = 0 leave the state as it was: the final
    state of the padded chunks == the recurrence over the real rows."""
    xs, a, bm, cm = map(torch.from_numpy, ssd_edge_np("padded_tail"))
    b, nc, q, h, p = xs.shape
    real = nc * q - SSD_EDGES["padded_tail"][2]

    def unpadded(t):
        return t.reshape(b, 1, nc * q, *t.shape[3:])[:, :, :real] \
            .contiguous()

    y_r, s_r = ref.ssd_scan(*map(unpadded, (xs, a, bm, cm)))
    y, st = ssd_chunked_torch(xs, a, bm, cm)
    np.testing.assert_allclose(st.numpy(), s_r.numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(unpadded(y).numpy(), y_r.numpy(),
                               rtol=SSD_TOL, atol=SSD_TOL)
    assert not y.reshape(b, nc * q, h, p)[:, real:].any()


def test_ssd_chunked_torch_carries_an_initial_state():
    """From a given initial state S0, the chunked scan == the zero-state
    scan plus S0's decayed share: y += exp(cumsum a) ∘ (C S0ᵀ) and the
    final state += S0 exp(sum a)."""
    xs, a, bm, cm = map(torch.from_numpy, ssd_np(1, 3, 32, 2, 16, 8,
                                                 seed=5))
    s0 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 2, 16, 8)).astype(np.float32))
    y0, st0 = ssd_chunked_torch(xs, a, bm, cm)
    y, st = ssd_chunked_torch(xs, a, bm, cm, initial_state=s0)
    acum = torch.cumsum(a.reshape(1, 96, 2), dim=1)          # (b, t, h)
    share = torch.einsum("btn,bhpn->bthp", cm.reshape(1, 96, 8), s0) \
        * torch.exp(acum)[..., None]
    np.testing.assert_allclose(y.reshape(1, 96, 2, 16).numpy(),
                               (y0.reshape(1, 96, 2, 16) + share).numpy(),
                               rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(
        st.numpy(),
        (st0 + s0 * torch.exp(acum[:, -1])[..., None, None]).numpy(),
        rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_stage_table_covers_every_stage_kernel():
    """The three stage kernels, in launch order (the C library's stage
    numbers), each counted; on the CPU a call runs the plain version and
    counts neither the call nor a stage."""
    assert kssd.STAGES == ("chunk_state", "state_pass", "chunk_out")
    assert list(kssd.STAGE_LAUNCHES) == list(kssd.STAGES)
    xs, a, bm, cm = map(torch.from_numpy, ssd_np(1, 2, 64, 2, 32, 16, 0))
    y, st = ops.ssd_scan(xs, a, bm, cm)
    y_p, s_p = ref.ssd_scan(xs, a, bm, cm)
    assert torch.equal(y, y_p) and torch.equal(st, s_p)
    assert ops.LAUNCHES["ssd_scan"] == 0
    assert not any(kssd.STAGE_LAUNCHES.values())


def test_ssd_rounding_emulation_sums_the_scan(capsys):
    """``launch/ssd_rounding``'s emulation of K4's summation order
    computes the scan: at a = 0 it equals a float64 recurrence within
    SSD_TOL, as does each variant, and the script runs."""
    from repro_torch.launch import ssd_rounding
    g = torch.Generator().manual_seed(3)
    xs, bm, cm = (torch.randn(shape, generator=g)
                  for shape in ((2, 16, 2, 8), (2, 16, 8), (2, 16, 8)))
    y64 = ssd_rounding.recurrence(xs, bm, cm, torch.float64)
    for kw in ({}, {"exact_state": True}, {"exact_cb": True},
               {"two_acc": True}):
        y = ssd_rounding.kernel_order(xs, bm, cm, **kw)
        np.testing.assert_allclose(y.double().numpy(), y64.numpy(),
                                   rtol=SSD_TOL, atol=SSD_TOL)
    assert ssd_rounding.main(["--shape", "2", "16", "1", "8", "8"]) == 0
    assert "of the limit" in capsys.readouterr().out


def gemm_np(e, c, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, c, d)).astype(np.float32),
            rng.normal(size=(e, d, f)).astype(np.float32) * 0.05)


def scaled_close(ours, exp, rtol, atol):
    """Compare after dividing both by the expected output's largest
    magnitude, as the JAX package's sweep does."""
    exp = np.asarray(exp, np.float32)
    scale = float(np.abs(exp).max()) + 1e-6
    np.testing.assert_allclose(np.asarray(ours, np.float32) / scale,
                               exp / scale, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_plain_expert_gemm_matches_reference(jax_ref, dtype, e, c, d, f):
    _, jops, jref = jax_ref
    import jax.numpy as jnp
    x, w = gemm_np(e, c, d, f, seed=c + f)
    tdt = getattr(torch, dtype)
    ours = ops.expert_gemm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(w).to(tdt))
    assert ours.dtype == tdt and ours.shape == (e, c, f)
    assert ops.LAUNCHES["expert_gemm"] == 0
    jx, jw = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(
        w, getattr(jnp, dtype))
    tol = GEMM_TOL[dtype]
    for fn in (jref.expert_gemm, jops.expert_gemm):
        scaled_close(ours.float().numpy(), fn(jx, jw), tol, 10 * tol)


def test_expert_ffn_matches_reference(jax_ref):
    """Three K5 products with silu(g) * h between them (its plain
    version here) == the JAX package's kernel route and its einsum
    module, at the JAX test's shape and tolerance."""
    _, jops, _ = jax_ref
    import jax.numpy as jnp
    from repro.models.moe import expert_ffn as jffn
    from repro_torch.models.moe import expert_ffn
    e, c, d, f = 2, 128, 128, 256
    rng = np.random.default_rng(11)
    experts = {"wi": rng.normal(size=(e, d, f)) * 0.05,
               "wg": rng.normal(size=(e, d, f)) * 0.05,
               "wo": rng.normal(size=(e, f, d)) * 0.05}
    experts = {k: v.astype(np.float32) for k, v in experts.items()}
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    pt = {k: torch.from_numpy(v) for k, v in experts.items()}
    ours = ops.expert_ffn(pt, torch.from_numpy(x)).numpy()
    jexp = {k: jnp.asarray(v) for k, v in experts.items()}
    for exp in (jops.expert_ffn(jexp, jnp.asarray(x)),
                jffn(jexp, jnp.asarray(x))):
        np.testing.assert_allclose(ours, np.asarray(exp), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(
        ours, expert_ffn(pt, torch.from_numpy(x)).numpy(), rtol=1e-4,
        atol=1e-5)
    assert ops.LAUNCHES["expert_gemm"] == 0


@pytest.mark.parametrize("case", ["mixed_devices", "dtype", "mixed_dtype",
                                  "rank", "experts", "depth", "contiguous",
                                  "empty"])
def test_expert_gemm_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w = map(torch.from_numpy, gemm_np(2, 16, 32, 24, seed=0))
    args = {"mixed_devices": (x, w.to("meta")),
            "dtype": (x.half(), w.half()),
            "mixed_dtype": (x, w.bfloat16()),
            "rank": (x[0], w[0]),
            "experts": (x, w[:1].contiguous()),
            "depth": (x, w[:, :16].contiguous()),
            "contiguous": (x.transpose(1, 2).contiguous().transpose(1, 2),
                           w),
            "empty": (x[:, :0], w)}[case]
    with pytest.raises((TypeError, ValueError)):
        ops.expert_gemm(*args)
    assert ops.LAUNCHES["expert_gemm"] == 0


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_ssd_chunked_routes_match_reference(jax_ref, backend):
    """The model's chunked scan (``models/ssm.ssd_chunked``) on either
    route == the JAX package's ``xla`` and ``pallas`` routes."""
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as ref_chunked
    from repro_torch.models.ssm import ssd_chunked
    b, s, h, p, n, chunk = 2, 256, 2, 32, 16, 64
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.2).astype(np.float32)
    a_head = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    y, st = ssd_chunked(*map(torch.from_numpy, (x, dt, a_head, bm, cm)),
                        chunk=chunk, backend=backend)
    for route in ("xla", "pallas"):
        y_r, s_r = ref_chunked(*map(jnp.asarray, (x, dt, a_head, bm, cm)),
                               chunk=chunk, backend=route)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r),
                                   rtol=SSD_TOL, atol=SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(s_r),
                                   rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("case", ["mixed_devices", "dtype", "mixed_dtype",
                                  "heads", "seq_len", "head_dim", "rank",
                                  "contiguous", "shape"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = map(torch.from_numpy, flash_np(1, 256, 4, 2, 64, seed=0))
    args = {"mixed_devices": (q, k, v.to("meta")),
            "dtype": (q.half(), k.half(), v.half()),
            "mixed_dtype": (q, k.bfloat16(), v),
            "heads": (torch.zeros(1, 256, 4, 64), torch.zeros(1, 256, 3, 64),
                      torch.zeros(1, 256, 3, 64)),
            # an empty sequence (a ragged last tile is taken, below)
            "seq_len": (q[:, :0].contiguous(), k[:, :0].contiguous(),
                        v[:, :0].contiguous()),
            "head_dim": (torch.zeros(1, 128, 2, 264),
                         torch.zeros(1, 128, 2, 264),
                         torch.zeros(1, 128, 2, 264)),
            "rank": (q[0], k[0], v[0]),
            "contiguous": (q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v),
            "shape": (q, k, v[:, :, :1].contiguous())}[case]
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(*args)
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("case", ["initial_state", "mixed_devices", "dtype",
                                  "shape", "contiguous", "chunk", "state"])
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(case):
    xs, a, bm, cm = map(torch.from_numpy, ssd_np(1, 2, 64, 2, 32, 16, 0))
    big = torch.zeros(1, 1, 256, 2, 8)
    args = {"initial_state": (xs, a, bm, cm, torch.zeros(1, 2, 32, 16)),
            "mixed_devices": (xs, a, bm, cm.to("meta")),
            "dtype": (xs.double(), a, bm, cm),
            "shape": (xs, a[..., :1].contiguous(), bm, cm),
            "contiguous": (xs, a, bm.transpose(2, 3).contiguous()
                           .transpose(2, 3), cm),
            "chunk": (big, torch.zeros(1, 1, 256, 2),
                      torch.zeros(1, 1, 256, 4), torch.zeros(1, 1, 256, 4)),
            "state": (xs, a, torch.zeros(1, 2, 64, 256),
                      torch.zeros(1, 2, 64, 256))}[case]
    with pytest.raises((TypeError, ValueError)):
        ops.ssd_scan(*args)
    assert ops.LAUNCHES["ssd_scan"] == 0


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


# ---------------------------------------------------------------------------
# int8 over a tree: the layout of the flat buffers and the tree wrappers
# ---------------------------------------------------------------------------

LAYOUT_SIZES = [1, 3, 15, 16, 17, 8193]


def flat_views(sizes, offset, seed=0):
    """Leaves as K1's unflatten hands them back: views of one flat
    float32 vector, the first at element ``offset``."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(
        rng.normal(size=offset + sum(sizes)).astype(np.float32))
    out, off = [], offset
    for n in sizes:
        out.append(flat[off: off + n])
        off += n
    return out


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_int8_layout_covers_every_element_once(offset):
    leaves = flat_views(LAYOUT_SIZES, offset)
    lay = kq.layout_of(leaves)
    covered = np.zeros(lay.total, np.int64)
    for x, off, head, n in zip(leaves, lay.offsets.tolist(),
                               lay.heads.tolist(), lay.numels.tolist()):
        assert n == x.numel()
        covered[off: off + n] += 1
        # the segment is congruent, mod 4, to its source's misalignment,
        # and source, int8 and float32 buffers align at element ``head``
        # (a 128-byte line of both flat buffers)
        assert (off - (x.data_ptr() % 16) // 4) % 4 == 0
        assert 0 <= head < 4 and (off + head) % 128 == 0
        assert (x.data_ptr() + 4 * head) % 16 == 0
        assert head + kq.TILE * kq.tiles_of(n, head) >= n
    assert covered.max() == 1 and covered.sum() == sum(LAYOUT_SIZES)
    assert lay.total == int(lay.offsets[-1] + lay.numels[-1])
    assert lay.total < sum(LAYOUT_SIZES) + 128 * len(LAYOUT_SIZES)
    tiles = [kq.tiles_of(n, h) for n, h in zip(lay.numels, lay.heads)]
    assert lay.chunks == [(0, len(LAYOUT_SIZES), sum(tiles))]
    np.testing.assert_array_equal(lay.first_tiles[0],
                                  np.cumsum([0] + tiles[:-1]))
    assert kq.layout_of(leaves) is lay            # cached by structure


def test_int8_layout_chunks_a_tree_over_capacity():
    n = 2 * kq.CAPACITY + 3
    leaves = flat_views([1 + i % 40 for i in range(n)], 1)
    lay = kq.layout_of(leaves)
    assert [(a, b) for a, b, _ in lay.chunks] == [
        (0, kq.CAPACITY), (kq.CAPACITY, 2 * kq.CAPACITY),
        (2 * kq.CAPACITY, n)]
    src = np.array([x.data_ptr() for x in leaves], np.uint64)
    dst = lay.offsets_u64 + np.uint64(1 << 20)
    tables = lay.tables(src, dst)
    assert len(tables) == 3
    assert kq._ONE.size == kq._table_bytes(1) == 40    # LeafTable<1>
    for (a, b, tiles), ft, table in zip(lay.chunks, lay.first_tiles,
                                        tables):
        k = b - a
        assert table.nbytes == kq._table_bytes(kq.CAPACITY) == 8200
        col = lambda name, m=k: kq._column(table, kq.CAPACITY, name, m)
        np.testing.assert_array_equal(col("src"), src[a:b])
        np.testing.assert_array_equal(col("dst"), dst[a:b])
        np.testing.assert_array_equal(col("n"), lay.numels[a:b])
        np.testing.assert_array_equal(col("head"), lay.heads[a:b])
        np.testing.assert_array_equal(col("first_tile"), ft)
        assert col("count", 1)[0] == k
        assert tiles == int(ft[-1]) + kq.tiles_of(int(lay.numels[b - 1]),
                                                  int(lay.heads[b - 1]))
    q, scales, lay2 = ops.quantize_int8_leaves(leaves)
    outs = ops.dequantize_int8_leaves(q, scales, lay2)
    assert lay2 is lay and len(outs) == n
    for x, o in zip(leaves, outs):
        s = ref.int8_scale(x)
        assert torch.equal(o, ref.dequantize_int8(ref.quantize_int8(x, s), s))


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_int8_tree_route_matches_per_leaf_route(offset):
    leaves = flat_views(LAYOUT_SIZES + [12, 7], offset, seed=offset)
    leaves[-2] = leaves[-2].view(3, 4)              # leaves keep shapes
    leaves[-1].zero_()                              # an all-zero leaf
    q, scales, lay = ops.quantize_int8_leaves(leaves)
    outs = ops.dequantize_int8_leaves(q, scales, lay)
    assert q.dtype == torch.int8 and q.shape == (lay.total,)
    assert scales.dtype == torch.float32 and scales.shape == (len(leaves),)
    for x, s, off, o in zip(leaves, scales, lay.offsets.tolist(), outs):
        s_leaf = ref.int8_scale(x)
        q_leaf = ref.quantize_int8(x.reshape(-1), s_leaf)
        assert torch.equal(s.view(torch.int32), s_leaf.view(torch.int32))
        assert torch.equal(q[off: off + x.numel()], q_leaf)
        assert o.shape == x.shape and o.dtype == torch.float32
        assert torch.equal(o.reshape(-1).view(torch.int32),
                           ref.dequantize_int8(q_leaf, s_leaf).view(
                               torch.int32))
    assert not outs[-1].any()
    assert torch.equal(ops.int8_scales(leaves).view(torch.int32),
                       scales.view(torch.int32))
    # given scales: ties and clipping on a power-of-two grid
    given = torch.full((len(leaves),), 2.0 ** -6)
    q2, s2, _ = ops.quantize_int8_leaves(leaves, given)
    assert s2 is given
    for x, off in zip(leaves, lay.offsets.tolist()):
        assert torch.equal(q2[off: off + x.numel()],
                           ref.quantize_int8(x.reshape(-1), given[0]))
    assert all(n == 0 for n in ops.LAUNCHES.values())    # CPU: no kernel


@pytest.mark.parametrize("case", ["not_a_list", "no_leaves", "dtype",
                                  "contiguous", "empty_leaf",
                                  "mixed_devices", "misaligned",
                                  "scales_dtype", "scales_shape"])
def test_int8_tree_quantize_rejects_what_the_kernels_do_not_take(case):
    """``quantize_int8_leaves`` and, for the leaves' own faults, the scale
    pass ``int8_scales``."""
    x = torch.ones(4, 5)
    odd = torch.frombuffer(bytearray(68), dtype=torch.float32, offset=1,
                           count=16)             # 1 byte past a boundary
    leaves, scales = {
        "not_a_list": (x, None),
        "no_leaves": ([], None),
        "dtype": ([x, x.double()], None),
        "contiguous": ([x, x.t()], None),
        "empty_leaf": ([x, x[:0]], None),
        "mixed_devices": ([x, x.to("meta")], None),
        "misaligned": ([x, odd], None),
        "scales_dtype": ([x, x], torch.ones(2, dtype=torch.float64)),
        "scales_shape": ([x, x], torch.ones(3)),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        ops.quantize_int8_leaves(leaves, scales)
    if scales is None:
        with pytest.raises((TypeError, ValueError)):
            ops.int8_scales(leaves)
    assert ops.LAUNCHES["int8_scale"] == ops.LAUNCHES["quantize_int8"] == 0


@pytest.mark.parametrize("case", ["layout", "q_dtype", "q_shape",
                                  "q_misaligned", "scales_dtype",
                                  "scales_shape", "mixed_devices"])
def test_int8_tree_dequantize_rejects_what_the_kernels_do_not_take(case):
    q, scales, lay = ops.quantize_int8_leaves([torch.ones(5),
                                               torch.ones(3, 3)])
    shifted = torch.zeros(lay.total + 1, dtype=torch.int8)[1:]
    args = {"layout": (q, scales, None),
            "q_dtype": (q.int(), scales, lay),
            "q_shape": (q[:-1], scales, lay),
            "q_misaligned": (shifted, scales, lay),
            "scales_dtype": (q, scales.double(), lay),
            "scales_shape": (q, scales[:1], lay),
            "mixed_devices": (q, scales.to("meta"), lay)}[case]
    with pytest.raises((TypeError, ValueError)):
        ops.dequantize_int8_leaves(*args)
    assert ops.LAUNCHES["dequantize_int8"] == 0


@pytest.mark.parametrize("dtype,d,aligned,expected", [
    (torch.bfloat16, 64, True, "tensor_core"),
    (torch.bfloat16, 80, True, "tensor_core"),
    (torch.bfloat16, 128, True, "tensor_core"),
    (torch.bfloat16, 256, True, "tensor_core"),
    (torch.bfloat16, 36, True, "cuda_core"),       # heads not 16-byte apart
    (torch.bfloat16, 64, False, "cuda_core"),      # TMA needs 16-byte bases
    (torch.float32, 64, True, "fp32_tma"),         # float32 products, TMA
    (torch.float32, 80, True, "fp32_tma"),
    (torch.float32, 128, True, "fp32_tma"),
    (torch.float32, 256, True, "fp32_tma"),
    (torch.float32, 36, True, "fp32_tma"),         # 144-byte heads
    (torch.float32, 30, True, "cuda_core"),        # heads not 16-byte apart
    (torch.float32, 64, False, "cuda_core")])      # TMA needs 16-byte bases
def test_flash_variant_is_chosen_by_dtype_and_head_dim(dtype, d, aligned,
                                                       expected):
    assert flash.variant(dtype, d, aligned) == expected


@pytest.mark.parametrize("dtype,d,f,aligned,expected", [
    (torch.bfloat16, 1024, 512, True, "tensor_core"),   # granite's wi, wg
    (torch.bfloat16, 512, 1024, True, "tensor_core"),   # granite's wo
    (torch.bfloat16, 200, 72, True, "tensor_core"),     # D, F not of 64
    (torch.bfloat16, 8, 8, True, "tensor_core"),
    (torch.bfloat16, 1024, 512, False, "mma_sync"),     # TMA: 16-byte bases
    (torch.bfloat16, 100, 512, True, "mma_sync"),       # x rows not 16 B
    (torch.bfloat16, 1024, 70, True, "mma_sync"),       # w, out rows
    (torch.bfloat16, 5, 7, True, "mma_sync"),
    (torch.float32, 1024, 512, True, "fp32_tma"),       # float32 products
    (torch.float32, 512, 1024, True, "fp32_tma"),
    (torch.float32, 200, 72, True, "fp32_tma"),         # D, F not of 32
    (torch.float32, 4, 4, True, "fp32_tma"),
    (torch.float32, 1024, 512, False, "cuda_core"),     # TMA: 16-byte bases
    (torch.float32, 100, 70, True, "cuda_core"),        # w, out rows
    (torch.float32, 30, 512, True, "cuda_core"),        # x rows
    (torch.float32, 5, 7, False, "cuda_core")])
def test_expert_gemm_variant_is_chosen_by_dtype_shape_and_alignment(
        dtype, d, f, aligned, expected):
    assert egemm.variant(dtype, d, f, aligned) == expected


def test_library_path_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` gives every kernel a new build directory,
    so no stale library is loaded; unchanged sources keep theirs."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = [p.stem for p in sorted(csrc.glob("*.cu"))]
    before = {n: build.library_path(n) for n in names}
    assert build.library_path("flash_attention") == before["flash_attention"]
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_attention") != after["flash_attention"]


def test_split_p_keeps_the_float32_product():
    """The tensor-core K3 multiplies P (float32 softmax weights) by V as
    two bf16 products, P_hi = bf16(p) and P_lo = bf16(p - P_hi), into one
    float32 sum.  Emulated here at qwen's head dim (64) over 1024 keys:
    within 2^-14 of the largest output of the float32 product, where one
    bf16 P (rounded once more than the TPU kernel's float32 p) is not."""
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=(64, 1024)) * 3)
    p = torch.exp(scores - scores.max(dim=1, keepdim=True).values).float()
    v = torch.from_numpy(rng.normal(size=(1024, 64))).float()
    v = v.bfloat16().float()                # V arrives in bf16
    exact = p.double() @ v.double()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    split = hi @ v + lo @ v                 # float32 sums of exact products
    scale = float(exact.abs().max())
    assert float((split.double() - exact).abs().max()) <= 2 ** -14 * scale
    assert float(((hi @ v).double() - exact).abs().max()) > 2 ** -14 * scale


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
@pytest.mark.parametrize("m,p", [(1, 1000), (2, 8193), (8, 1 << 20)])
def test_cuda_kernel_in_place_matches_out_of_place(cuda, m, p):
    """K1's in-place variant: bit for bit the out-of-place result,
    written into prev's storage, allocating nothing; both counted in
    ``LAUNCHES`` and apart by variant."""
    from repro_torch.kernels import fill_aggregate as kfa
    cl, mk, w, prev = (torch.from_numpy(a).to(cuda)
                       for a in rand_inputs(m, p, seed=p + 1))
    want = ops.fill_aggregate(cl, mk, w, prev)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["fill_aggregate"]
    variants = dict(kfa.VARIANT_LAUNCHES)
    ptr = prev.data_ptr()
    allocated = torch.cuda.memory_allocated(cuda)
    out = ops.fill_aggregate(cl, mk, w, prev, donate_prev=True)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == allocated
    assert out is prev and out.data_ptr() == ptr
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert ops.LAUNCHES["fill_aggregate"] == launches + 1
    assert kfa.VARIANT_LAUNCHES == {
        **variants, "in_place": variants["in_place"] + 1}


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


def int8_tree_case(case, device):
    """(leaves on ``device``, given scales or None) of one tree check;
    the leaves are views of one flat vector, as K1 hands them back."""
    rng = np.random.default_rng(17)
    step = np.float32(2.0 ** -6)
    if case.startswith("views"):
        sizes, offset = LAYOUT_SIZES + [100_003], int(case[-1])
    elif case == "over_capacity":
        sizes, offset = rng.integers(1, 3000, 600).tolist(), 1
    else:
        sizes, offset = [1, 3, 33, 4100, 70_001], 2
    flat = rng.normal(size=offset + sum(sizes)).astype(np.float32)
    starts = offset + np.cumsum([0] + sizes[:-1])
    given = None
    if case == "ties_and_clipping":      # |k| up to 140 clips at 127
        flat = ((rng.integers(-140, 140, flat.size) + 0.5) * step
                ).astype(np.float32)
        given = torch.full((len(sizes),), step, device=device)
    elif case == "own_scale_ties":       # max|x| = 127 step: scale = step
        flat = ((rng.integers(-127, 127, flat.size) + 0.5) * step
                ).astype(np.float32)
        flat[offset::5] = 0.0
        flat[starts] = 127 * step
    elif case == "zero_and_one_element":
        flat[starts[1]: starts[3]] = 0.0    # the 3- and 33-element leaves
    dev_flat = torch.from_numpy(flat).to(device)
    return [dev_flat[a: a + n] for a, n in zip(starts.tolist(), sizes)], \
        given


INT8_TREE_CASES = ["views_1", "views_2", "views_3", "over_capacity",
                   "ties_and_clipping", "own_scale_ties",
                   "zero_and_one_element"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_TREE_CASES)
def test_cuda_int8_tree_kernels_match_plain_version(cuda, case):
    leaves, given = int8_tree_case(case, cuda)
    before = dict(ops.LAUNCHES)
    q, scales, layout = ops.quantize_int8_leaves(leaves, given)
    outs = ops.dequantize_int8_leaves(q, scales, layout)
    torch.cuda.synchronize()
    chunks = len(layout.chunks)
    assert chunks == (3 if case == "over_capacity" else 1)
    # 3 launches a chunk: the scale pass (unless given), K2a, K2b
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "quantize_int8": chunks,
        "dequantize_int8": chunks,
        "int8_scale": 0 if given is not None else chunks}
    q_max = 0
    for i, (x, off, o) in enumerate(zip(leaves, layout.offsets.tolist(),
                                        outs)):
        s = ref.int8_scale(x) if given is None else given[i]
        q_leaf = ref.quantize_int8(x, s)
        assert torch.equal(scales[i].view(torch.int32), s.view(torch.int32))
        assert torch.equal(q[off: off + x.numel()], q_leaf)
        assert torch.equal(o.view(torch.int32),
                           ref.dequantize_int8(q_leaf, s).view(torch.int32))
        q_max = max(q_max, int(q_leaf.int().abs().max()))
    if case == "ties_and_clipping":
        assert q_max == 127
    if case == "own_scale_ties":
        assert all(float(s) == 2.0 ** -6 for s in scales)
    if case == "zero_and_one_element":
        assert leaves[0].numel() == 1
        assert not outs[1].any() and not outs[2].any()


@pytest.mark.cuda
def test_cuda_int8_tree_kernels_repeat_bit_for_bit(cuda):
    leaves, _ = int8_tree_case("over_capacity", cuda)
    first = ops.quantize_int8_leaves(leaves)
    again = ops.quantize_int8_leaves(leaves)
    outs = [ops.dequantize_int8_leaves(*r) for r in (first, again)]
    torch.cuda.synchronize()
    assert torch.equal(first[1].view(torch.int32), again[1].view(torch.int32))
    for x, off in zip(leaves, first[2].offsets.tolist()):
        seg = slice(off, off + x.numel())
        assert torch.equal(first[0][seg], again[0][seg])
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d", FLASH_SHAPES + [
    (2, 100, 4, 2, 64),          # one ragged tile
    (1, 300, 4, 2, 64),          # a ragged last tile past 128
    (1, 256, 4, 4, 80),          # zamba2's head dim
    (2, 1000, 4, 4, 80),         # zamba2's prompt length
    (1, 128, 2, 1, 256),         # the largest head dim
    (4, 1024, 16, 16, 64),       # qwen1.5-0.5b's prefill
    (4, 1024, 16, 8, 64),        # granite-moe-1b-a400m's prefill (GQA)
    (1, 256, 4, 2, 36),          # D % 8 != 0: the CUDA-core kernel in bf16
    (1, 256, 4, 2, 30),          # D % 4 != 0: and in float32
    (2, 1000, 2, 2, 128),        # the dense shelf's head dim, ragged S
    (1, 1, 2, 1, 64)])           # one query, one key
@pytest.mark.parametrize("causal,window", MASKS + [(True, 256), (False, 64)])
def test_cuda_flash_attention_matches_plain_version(cuda, dtype, b, s, h, kh,
                                                    d, causal, window):
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in flash_np(b, s, h, kh, d, seed=s))
    before = ops.LAUNCHES["flash_attention"]
    variants = dict(flash.VARIANT_LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    which = flash.variant(q.dtype, d)
    assert {n: flash.VARIANT_LAUNCHES[n] - variants[n] for n in variants} \
        == {**dict.fromkeys(variants, 0), which: 1}
    assert out.dtype == q.dtype and out.shape == q.shape
    rtol, atol = KERNEL_FLASH_TOL[dtype]
    torch.testing.assert_close(
        out.float(), ref.flash_attention(q, k, v, causal=causal,
                                         window=window).float(),
        rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d", [(4, 1024, 16, 8, 64),
                                         (1, 256, 4, 2, 128)])
def test_cuda_flash_attention_tensor_core_repeats_bit_for_bit(cuda, b, s, h,
                                                              kh, d):
    """The tensor-core kernel sums in a fixed order (no atomics): the same
    bf16 call twice gives the same bits."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in flash_np(b, s, h, kh, d, seed=7))
    before = flash.VARIANT_LAUNCHES["tensor_core"]
    first = ops.flash_attention(q, k, v, window=256)
    second = ops.flash_attention(q, k, v, window=256)
    torch.cuda.synchronize()
    assert flash.VARIANT_LAUNCHES["tensor_core"] == before + 2
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d", [(4, 1024, 16, 8, 64),
                                         (1, 300, 4, 2, 80),
                                         (1, 256, 4, 2, 128),
                                         (1, 128, 2, 1, 256)])
def test_cuda_flash_attention_fp32_repeats_bit_for_bit(cuda, b, s, h, kh,
                                                       d):
    """The TMA-fed float32 kernel sums in a fixed order (no atomics): the
    same float32 call twice gives the same bits, at each of its four
    variants."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in flash_np(b, s, h, kh, d, seed=7))
    before = flash.VARIANT_LAUNCHES["fp32_tma"]
    first = ops.flash_attention(q, k, v, window=256)
    second = ops.flash_attention(q, k, v, window=256)
    torch.cuda.synchronize()
    assert flash.VARIANT_LAUNCHES["fp32_tma"] == before + 2
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def offset_view(a, device):
    """A contiguous copy of numpy array ``a`` on ``device`` that starts one
    element past a 16-byte boundary (a view into a larger buffer)."""
    buf = torch.zeros(a.size + 1, dtype=torch.float32, device=device)
    t = buf[1:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", MASKS)
def test_cuda_flash_attention_misaligned_fp32_runs_cuda_core(cuda, causal,
                                                             window):
    """float32 q, k, v that start 4 bytes past a 16-byte boundary take the
    CUDA-core kernel, which matches too."""
    q, k, v = (offset_view(a, cuda)
               for a in flash_np(1, 300, 4, 2, 64, seed=3))
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    variants = dict(flash.VARIANT_LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: flash.VARIANT_LAUNCHES[n] - variants[n] for n in variants} \
        == {**dict.fromkeys(variants, 0), "cuda_core": 1}
    rtol, atol = KERNEL_FLASH_TOL["float32"]
    torch.testing.assert_close(
        out, ref.flash_attention(q, k, v, causal=causal, window=window),
        rtol=rtol, atol=atol)


# K4 on the card: (shape, decay); the sweep's shapes at decay 0.1, then
# the edge cases of its stages
CUDA_SSD_CASES = [(shape, 0.1) for shape in SSD_SHAPES] + [
    ((1, 2, 128, 2, 80, 64), 0.1),      # two P tiles (zamba2's head dim)
    ((4, 8, 128, 48, 64, 128), 0.1),    # mamba2-780m's prefill
    ((2, 1, 128, 48, 64, 128), 0.1),    # one chunk: no state enters
    ((1, 32, 128, 48, 64, 128), 0.1),   # 4096 tokens at B = 1
    ((1, 2, 128, 4, 64, 64), 0.0),      # no decay (a = 0)
    ((2, 8, 128, 4, 80, 128), 60.0)]    # a about -50 a step


def cuda_ssd_args(shape, decay, device):
    return [torch.from_numpy(arr).to(device)
            for arr in ssd_np(*shape, seed=shape[2], decay=decay)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,decay", CUDA_SSD_CASES)
def test_cuda_ssd_scan_matches_plain_version(cuda, shape, decay):
    args = cuda_ssd_args(shape, decay, cuda)
    before = ops.LAUNCHES["ssd_scan"]
    y, st = ops.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    y_r, s_r = ref.ssd_scan(*args)
    torch.testing.assert_close(y, y_r, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(st, s_r, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_cuda_ssd_scan_no_decay_matches_float64(cuda):
    """Without decay at 4 chunks and N 128, |y| reaches the thousands and
    the kernel and the plain float32 recurrence, summing in other orders,
    differ by more than SSD_TOL: there the kernel is held to a float64
    recurrence within SSD_TOL."""
    args = cuda_ssd_args((1, 4, 128, 4, 64, 128), 0.0, cuda)
    xs, a, bm, cm = (t.double() for t in args)
    b, nc, q, h, p = xs.shape
    s64 = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float64,
                      device=cuda)
    ys = []
    for t in range(nc * q):
        c, i = divmod(t, q)
        s64 = (s64 * torch.exp(a[:, c, i])[:, :, None, None]
               + torch.einsum("bhp,bn->bhpn", xs[:, c, i], bm[:, c, i]))
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, c, i], s64))
    y64 = torch.stack(ys, dim=1).reshape(b, nc, q, h, p)
    y, st = ops.ssd_scan(*args)
    torch.testing.assert_close(y.double(), y64, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(st.double(), s64, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_cuda_ssd_scan_repeats_bit_for_bit(cuda):
    """No float atomics: the same call twice gives the same bits."""
    args = cuda_ssd_args((4, 8, 128, 48, 64, 128), 0.1, cuda)
    y1, s1 = ops.ssd_scan(*args)
    y2, s2 = ops.ssd_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


@pytest.mark.cuda
def test_cuda_ssd_scan_counts_a_call_and_its_stage_launches(cuda):
    """One call: ops.LAUNCHES["ssd_scan"] + 1, and one launch of each
    stage kernel."""
    args = cuda_ssd_args((1, 2, 64, 2, 32, 16), 0.1, cuda)
    calls = ops.LAUNCHES["ssd_scan"]
    stages = dict(kssd.STAGE_LAUNCHES)
    ops.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == calls + 1
    assert {k: kssd.STAGE_LAUNCHES[k] - stages[k] for k in stages} == \
        dict.fromkeys(kssd.STAGES, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES + [
    (2, 1256, 200, 72),          # ragged C of a 4 x 1000-token prefill
    (32, 1280, 1024, 512),       # granite-moe-1b-a400m's prefill, wi/wg
    (32, 1280, 512, 1024),       # the same, wo
    (32, 8, 1024, 512),          # decode
    (1, 64, 64, 128),            # one tile, N = 128: the B operand's LBO
    (1, 128, 64, 256),           # two column tiles of one expert
    (2, 130, 8, 264),            # one contraction step, ragged everything
    (3, 129, 36, 260),           # float32: ragged at multiples of 4
    (2, 64, 100, 70),            # rows TMA cannot describe (w, out)
    (1, 1, 1, 1), (2, 3, 5, 7)])  # one element; odd everything
def test_cuda_expert_gemm_matches_plain_version(cuda, dtype, e, c, d, f):
    tdt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(cuda, tdt)
            for a in gemm_np(e, c, d, f, seed=c))
    before = ops.LAUNCHES["expert_gemm"]
    variants = dict(egemm.VARIANT_LAUNCHES)
    out = ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["expert_gemm"] == before + 1
    which = egemm.variant(tdt, d, f)
    assert {n: egemm.VARIANT_LAUNCHES[n] - variants[n] for n in variants} \
        == {**dict.fromkeys(variants, 0), which: 1}
    assert out.dtype == tdt and out.shape == (e, c, f)
    assert_gemm_close(out, ref.expert_gemm(x, w), dtype)


def assert_gemm_close(out, plain, dtype):
    """Kernel against plain version, both divided by the plain output's
    largest magnitude."""
    plain = plain.float()
    scale = float(plain.abs().max()) + 1e-6
    rtol, atol = KERNEL_GEMM_TOL[dtype]
    torch.testing.assert_close(out.float() / scale, plain / scale, rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(32, 1280, 1024, 512),
                                     (2, 100, 200, 72)])
def test_cuda_expert_gemm_tensor_core_repeats_bit_for_bit(cuda, e, c, d, f):
    """The tensor-core kernel sums in a fixed order (no atomics): the same
    bf16 call twice gives the same bits."""
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in gemm_np(e, c, d, f, seed=5))
    before = egemm.VARIANT_LAUNCHES["tensor_core"]
    first = ops.expert_gemm(x, w)
    second = ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert egemm.VARIANT_LAUNCHES["tensor_core"] == before + 2
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(32, 1280, 1024, 512),
                                     (32, 1280, 512, 1024),
                                     (2, 100, 200, 72)])
def test_cuda_expert_gemm_fp32_repeats_bit_for_bit(cuda, e, c, d, f):
    """The TMA-fed float32 kernel sums in a fixed order (no atomics): the
    same float32 call twice gives the same bits."""
    x, w = (torch.from_numpy(a).to(cuda) for a in gemm_np(e, c, d, f, seed=5))
    before = egemm.VARIANT_LAUNCHES["fp32_tma"]
    first = ops.expert_gemm(x, w)
    second = ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert egemm.VARIANT_LAUNCHES["fp32_tma"] == before + 2
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(2, 100, 200, 72),
                                     (32, 1280, 1024, 512)])
def test_cuda_expert_gemm_misaligned_fp32_runs_cuda_core(cuda, e, c, d, f):
    """float32 x and w that start 4 bytes past a 16-byte boundary take the
    CUDA-core kernel, which matches too."""
    x, w = (offset_view(a, cuda) for a in gemm_np(e, c, d, f, seed=9))
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    variants = dict(egemm.VARIANT_LAUNCHES)
    out = ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert {n: egemm.VARIANT_LAUNCHES[n] - variants[n] for n in variants} \
        == {**dict.fromkeys(variants, 0), "cuda_core": 1}
    assert_gemm_close(out, ref.expert_gemm(x, w), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(2, 100, 200, 72),
                                     (4, 256, 256, 384)])
def test_cuda_expert_gemm_misaligned_bf16_runs_mma_sync(cuda, e, c, d, f):
    """x and w that start 2 bytes past a 16-byte boundary (views into
    a larger buffer) take the mma.sync kernel, which matches too."""
    xs, ws = gemm_np(e, c, d, f, seed=9)
    bufs = [torch.zeros(a.size + 1, dtype=torch.bfloat16, device=cuda)
            for a in (xs, ws)]
    x, w = (b[1:].view(a.shape) for b, a in zip(bufs, (xs, ws)))
    x.copy_(torch.from_numpy(xs))
    w.copy_(torch.from_numpy(ws))
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    variants = dict(egemm.VARIANT_LAUNCHES)
    out = ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert {n: egemm.VARIANT_LAUNCHES[n] - variants[n] for n in variants} \
        == {**dict.fromkeys(variants, 0), "mma_sync": 1}
    assert_gemm_close(out, ref.expert_gemm(x, w), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_expert_ffn_matches_torch_route(cuda, dtype):
    """``ops.expert_ffn`` (three K5 launches) against the einsum module
    at granite's expert shape: in bfloat16 the routes may differ by one
    rounding of each of the three products."""
    from repro_torch.models.moe import expert_ffn
    tdt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    e, c, d, f = 32, 256, 1024, 512
    experts = {"wi": torch.randn(e, d, f, device=cuda, generator=g) * 0.03,
               "wg": torch.randn(e, d, f, device=cuda, generator=g) * 0.03,
               "wo": torch.randn(e, f, d, device=cuda, generator=g) * 0.04}
    experts = {k: v.to(tdt) for k, v in experts.items()}
    x = torch.randn(e, c, d, device=cuda, generator=g).to(tdt)
    before = ops.LAUNCHES["expert_gemm"]
    out = ops.expert_ffn(experts, x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["expert_gemm"] == before + 3
    exp = expert_ffn(experts, x).float()
    scale = float(exp.abs().max())
    rtol, atol = KERNEL_GEMM_TOL[dtype]
    torch.testing.assert_close(out.float() / scale, exp / scale,
                               rtol=3 * rtol, atol=3 * atol)
