"""repro_torch's dry run (``configs/base.py``'s input-shape table,
``launch/specs.py``, ``launch/roofline.py``, ``launch/dryrun.py``) against
the JAX package on the CPU, and its counts against hand counts.

The JAX package enters through ``jax.eval_shape`` only (once per arch, in
a module fixture; nothing is compiled) and through its plain modules:
``repro.launch.dryrun`` itself is never imported, since it forces 512
host devices when it is; its ``DEFAULT_MICROBATCH`` is read from its
source.  Held against the JAX package: ``SHAPES``, ``ARCH_IDS`` and
``get_config`` of the module names, ``effective_window`` and
``cache_len``, the shapes and dtypes of ``input_specs``,
``abstract_params`` and ``abstract_cache`` for every arch x shape (the
port's per-layer lists are the JAX package's stacked leading axis), and
``roofline_terms``' arithmetic, scaled by the ratio of the constants.

The port's own: the counter's FLOPs against a hand count of a 2-layer
dense prefill; full depth against the JAX method's extrapolation from
depths (4, 8) (equal: the meta run counts every layer, so no depth pair
is needed); two microbatches scaled against all of them counted;
``collective_bytes`` against hand counts on (2, 2) and (2, 1) meshes;
the live-storage peak of a known sequence; the kernel route's meta
launches per layer and output shapes against the torch route's; no meta
branch reached by a CPU tensor; the MoE's expert count against
``torch.bincount``.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro_torch.configs import ARCH_ALIASES, ARCH_IDS, SHAPES, \
    InputShape, get_config, get_shape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, roofline as rl, specs  # noqa: E402
from repro_torch.launch.mesh import Mesh, \
    make_production_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ONE = Mesh((1, 1), ("data", "model"))
TINY_TRAIN = InputShape("tiny_train", "train", 16, 4)
TINY_PREFILL = InputShape("tiny_prefill", "prefill", 16, 4)
TINY_DECODE = InputShape("tiny_decode", "decode", 16, 4)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's params and decode caches of every full config,
    by ``jax.eval_shape`` (no compile), one call per arch."""
    from repro.configs import get_config as ref_get_config
    from repro.launch import specs as jspecs
    from repro.models import transformer as jtr

    out = {}
    for mod in ARCH_IDS:
        jcfg = ref_get_config(mod)

        def init(jcfg=jcfg):
            p = jtr.init_params(jax.random.PRNGKey(0), jcfg)
            enc = jcfg.num_prefix if jcfg.family == "audio" else 0
            caches = {n: jtr.init_cache(p, jcfg, s.global_batch,
                                        jspecs.cache_len(jcfg, s),
                                        enc_len=enc)
                      for n, s in SHAPES.items() if s.kind == "decode"}
            return p, caches

        out[mod] = jax.eval_shape(init)
    # the first meta ops of a process load torch's meta kernels (about
    # 2 s): here, not in a case
    specs.abstract_params(get_config("qwen1.5-0.5b", smoke=True))
    return out


def assert_same_tree(jtree, tree, path="", stacked=0):
    """The port's tree against the JAX package's shapes and dtypes: a
    list level of the port is one leading stacked axis of the JAX
    leaves."""
    if isinstance(tree, list):
        for item in tree:
            assert_same_tree(jtree, item, path, stacked + 1)
        return
    if isinstance(tree, dict):
        assert sorted(tree) == sorted(jtree), path
        for k in tree:
            assert_same_tree(jtree[k], tree[k], f"{path}/{k}", stacked)
        return
    if isinstance(tree, int):            # the decode cache's host int t
        assert path == "/t" and tree == 0 and jtree.shape == (), path
        return
    assert tuple(jtree.shape[stacked:]) == tuple(tree.shape), path
    assert str(jtree.dtype) == str(tree.dtype).replace("torch.", ""), path
    assert tree.device.type == "meta", path


# ---------------------------------------------------------------------------
# the input-shape table and the specs, against the JAX package
# ---------------------------------------------------------------------------

def test_shape_table_matches_reference():
    from repro.configs import ARCH_IDS as ref_ids, SHAPES as ref_shapes, \
        get_shape as ref_get_shape
    assert ARCH_IDS == ref_ids
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in ref_shapes.items()}
    for n in SHAPES:
        assert dataclasses.asdict(get_shape(n)) == \
            dataclasses.asdict(ref_get_shape(n))
    assert set(ARCH_IDS) == set(ARCH_ALIASES.values()) - {"cifar_supernet"}


@pytest.mark.parametrize("mod", ARCH_IDS)
def test_module_names_resolve_as_the_reference(mod):
    from repro.configs import get_config as ref_get_config
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(mod, smoke=smoke)) == \
            dataclasses.asdict(ref_get_config(mod, smoke=smoke))
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config(mod + "_x")


@pytest.mark.parametrize("mod", ARCH_IDS)
def test_windows_and_input_specs_match_reference(mod):
    from repro.configs import get_config as ref_get_config
    from repro.launch import specs as jspecs
    cfg, jcfg = get_config(mod), ref_get_config(mod)
    for shape in SHAPES.values():
        assert specs.effective_window(cfg, shape) == \
            jspecs.effective_window(jcfg, shape)
        assert specs.cache_len(cfg, shape) == jspecs.cache_len(jcfg, shape)
        got = specs.input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, shape)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (shape.name, k)
            assert str(t.dtype)[6:] == str(want[k].dtype), (shape.name, k)
            assert t.device.type == "meta"


@pytest.mark.parametrize("mod", ARCH_IDS)
def test_abstract_params_and_caches_match_reference(ref, mod):
    cfg = get_config(mod)
    jparams, jcaches = ref[mod]
    params = specs.abstract_params(cfg)
    assert_same_tree(jparams, params)
    for name, jcache in jcaches.items():
        assert_same_tree(jcache, specs.abstract_cache(cfg, SHAPES[name],
                                                      params))


def test_default_microbatch_matches_reference():
    """Read from the JAX module's source: importing it would force 512
    host devices."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "DEFAULT_MICROBATCH":
            assert ast.literal_eval(node.value) == dryrun.DEFAULT_MICROBATCH
            return
    raise AssertionError("DEFAULT_MICROBATCH not found")


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e11, 1e9), (1e12, 8e11, 0.0), (3e13, 2e10, 5e11),
    (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference_scaled(flops, nbytes, coll):
    """The JAX package's terms at its v5e constants are the port's at the
    H100's once FLOPs and bytes are scaled by the ratio of the peaks;
    the collective term takes the link count and rate as parameters."""
    from repro.launch import roofline as jrl
    want = jrl.roofline_terms(flops, nbytes, coll)
    got = rl.roofline_terms(flops * rl.BF16_FLOPS / jrl.PEAK_FLOPS,
                            nbytes * rl.HBM_BYTES_PER_S / jrl.HBM_BW, coll,
                            links=4, link_bytes_per_s=jrl.ICI_BW)
    for k in ("compute_s", "memory_s", "collective_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0)
    assert got["dominant"] == want["dominant"]
    assert rl.COLLECTIVE_KINDS == jrl.COLLECTIVE_KINDS


# ---------------------------------------------------------------------------
# the port's counts
# ---------------------------------------------------------------------------

def test_counter_flops_match_a_hand_count():
    """qwen's smoke config (2 dense layers, QKV bias) prefilled on the
    torch route: the products of every layer and the unembedding of the
    last position."""
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    b, s = TINY_PREFILL.global_batch, TINY_PREFILL.seq_len
    d, h, kh, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.hd, cfg.d_ff
    t = b * s
    per_layer = (2 * t * d * h * hd + 2 * 2 * t * d * kh * hd     # q, k, v
                 + 2 * t * h * hd * d                              # o
                 + 2 * 2 * b * h * s * s * hd                      # qk, pv
                 + 3 * 2 * t * d * f)                              # mlp
    want = cfg.num_layers * per_layer + 2 * b * d * cfg.vocab_size
    got = dryrun.count_step(cfg, TINY_PREFILL, ONE)
    assert got["flops"] == want
    assert got["launches"] == {}


def _depth(cfg, n):
    return cfg.replace(num_layers=n)


def test_full_depth_equals_the_depth_pair_extrapolation():
    """The JAX package's method (counts at depths 4 and 8, a per-layer
    slope, extrapolated) gives the count at depth 12 exactly: the meta
    run sees every layer, so it needs no pair."""
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    c = {n: dryrun.count_step(_depth(cfg, n), TINY_PREFILL, ONE)
         for n in (4, 8, 12)}
    for key in ("flops", "bytes"):
        slope = (c[8][key] - c[4][key]) / 4
        assert c[8][key] + slope * 4 == c[12][key], key


def test_two_microbatches_scaled_equal_all_counted():
    """A step of three microbatches counted from two, against all three
    counted (granite's smoke MoE: the routing's ops are in every
    microbatch)."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        num_layers=1)
    shape = InputShape("t", "train", 8, 3)
    scaled = dryrun.count_step(cfg, shape, ONE, microbatch=3)
    full = dryrun.count_step(cfg, shape, ONE, microbatch=3,
                             scale_microbatches=False)
    assert (scaled["microbatches"], full["microbatches"]) == (2, 3)
    for key in ("flops", "bytes", "arguments", "peak", "outputs",
                "launches"):
        assert scaled[key] == full[key], key


@pytest.mark.parametrize("mesh", [ONE, Mesh((2, 2), ("data", "model"))])
@pytest.mark.parametrize("shape", [TINY_TRAIN, TINY_PREFILL, TINY_DECODE])
def test_arguments_are_the_specs_sum(mesh, shape):
    """The counter's held bytes, each storage weighted by its share,
    equal the per-device sum that the specs give."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    got = dryrun.count_step(cfg, shape, mesh, roofline=False)
    assert got["arguments"] == dryrun.argument_bytes_from_specs(cfg, shape,
                                                               mesh)


def test_collective_bytes_hand_counts():
    """qwen's smoke config in float32 (embedding 512 x 128, two layers
    of seven FSDP-split products, 128 x 128 and 128 x 256, three QKV
    biases split over model, two norms; the final norm), 4 x 16 tokens,
    remat, one microbatch."""
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    table, sq, wide = 512 * 128 * 4, 128 * 128 * 4, 128 * 256 * 4
    # (2, 2): each leaf gathered over data at its model half, twice in
    # training; the same bytes reduce-scattered once; norms (512 B) and
    # biases (256 B a model half) all-reduced over data; 5 products'
    # (32 x 128) float32 outputs all-reduced over model, 3 times each
    mesh = Mesh((2, 2), ("data", "model"))
    split = table // 2 + 2 * (4 * sq // 2 + 3 * wide // 2)
    got = rl.collective_bytes(cfg, TINY_TRAIN, mesh)
    assert got["all-gather"] == 2 * split == 1_572_864
    assert got["reduce-scatter"] == split == 786_432
    act = 32 * 128 * 4
    assert got["all-reduce"] == 512 + 2 * (2 * 512 + 3 * 256) + \
        5 * 3 * act == 249_856
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert got["ops"] == 30 + 15 + 11 + 15
    assert got["total"] == 1_572_864 + 786_432 + 249_856
    assert got["by_axis"]["model"] == 5 * 3 * act
    pre = rl.collective_bytes(cfg, TINY_PREFILL, mesh)
    assert (pre["all-gather"], pre["all-reduce"], pre["ops"]) == \
        (split, 5 * act, 20)
    # (2, 1): whole leaves gathered over data; nothing over model
    mesh = Mesh((2, 1), ("data", "model"))
    whole = table + 2 * (4 * sq + 3 * wide)
    got = rl.collective_bytes(cfg, TINY_TRAIN, mesh)
    assert got["all-gather"] == 2 * whole == 3_145_728
    assert got["reduce-scatter"] == whole
    assert got["all-reduce"] == 512 + 2 * (2 * 512 + 3 * 512) == 5632
    assert got["ops"] == 56 and got["by_axis"]["model"] == 0
    # (1, 1): none
    assert rl.collective_bytes(cfg, TINY_TRAIN, ONE)["total"] == 0


def test_collective_bytes_moe_all_to_all():
    """granite's smoke MoE (4 experts, top 2) prefilled on (2, 2): each
    layer exchanges its (E, capacity, d) buffer twice, the capacity of
    the 16 tokens of a model column (16 x 2 x 1.25 / 4 = 10, rounded up
    to 16 slots)."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    assert moe.capacity(16, 4, 2, cfg.capacity_factor) == 16
    got = rl.collective_bytes(cfg, TINY_PREFILL, Mesh((2, 2),
                                                      ("data", "model")))
    assert got["all-to-all"] == 2 * 2 * 4 * 16 * 128 * 4


def test_counter_peak_of_a_known_sequence():
    m = torch.device("meta")
    c = rl.StepCounter()
    a = torch.empty(1000, device=m)                 # 4000 B, held
    assert c.hold(a) == 4000
    with c:
        b = a * 2                                   # +4000
        v = b.view(10, 100)                         # a view: nothing
        del b
        e = v + 1                                   # +4000: 12000 live
        del v
        f = e.sum()                                 # b freed: 8004
        del e, f
        g = torch.empty(2000, device=m)             # 12000 again
    assert c.peak_bytes == 12000
    # bytes: a*2 reads and writes 4000 each, +1 the same, sum reads 4000
    # and writes 4, empty moves nothing
    assert c.bytes == 8000 + 8000 + 4004 and c.flops == 0
    del g


@pytest.mark.parametrize("arch,per_layer", [
    ("qwen1.5-0.5b", {"flash_attention": 1}),
    ("mamba2-780m", {"ssd_scan": 1}),
    ("granite-moe-1b-a400m", {"flash_attention": 1, "expert_gemm": 3})])
def test_kernel_route_on_meta(arch, per_layer):
    """The kernel route's meta branches: one count per launch the card
    would make, the kernels' own FLOPs added, and the output shape of
    the torch route."""
    cfg = get_config(arch, smoke=True)
    shape = InputShape("p", "prefill", 64, 2)
    runs = {}
    for backend in ("kernel", "torch"):
        args = dryrun.step_args(cfg, shape, 2)
        with rl.StepCounter() as c:
            out = dryrun.build_step(cfg, shape, backend=backend)(args)
        runs[backend] = (tuple(out.shape), out.dtype, c)
    assert runs["kernel"][:2] == runs["torch"][:2] == \
        ((2, 1, cfg.vocab_size), torch.float32)
    c = runs["kernel"][2]
    assert c.launches == {k: n * cfg.num_layers
                          for k, n in per_layer.items()}
    assert c.kernel_flops > 0 and runs["torch"][2].launches == {}


def test_cpu_tensors_take_no_meta_branch(monkeypatch):
    """A CPU tensor computes the plain version and counts nothing."""
    def refuse(*a, **k):
        raise AssertionError("meta branch reached")
    monkeypatch.setattr(rl, "count_kernel", refuse)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 16), generator=g)
    xs = torch.randn((1, 2, 4, 2, 8), generator=g)
    a = -torch.rand((1, 2, 4, 2), generator=g)
    bm = torch.randn((1, 2, 4, 4), generator=g)
    x = torch.randn((2, 4, 8), generator=g)
    w = torch.randn((2, 8, 6), generator=g)
    with rl.StepCounter() as c:
        assert ops.flash_attention(q, q, q).device.type == "cpu"
        assert ops.ssd_scan(xs, a, bm, bm)[0].device.type == "cpu"
        assert ops.expert_gemm(x, w).device.type == "cpu"
    assert c.launches == {} and c.kernel_flops == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_expert_count_equals_bincount(seed):
    """``route``'s fixed-size count gives ``torch.bincount``'s integers,
    so ``aux`` is what bincount made it, bit for bit, also where an
    expert is never chosen (positive tokens, a router column of -1e4)."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (cfg.d_model, cfg.num_experts)).astype(np.float32)
    w[:, -1] = -1e4 if seed else w[:, -1]
    x = torch.from_numpy(rng.random((50, cfg.d_model), dtype=np.float32))
    r = moe.route({"router": {"w": torch.from_numpy(w)}}, x, cfg)
    flat = r["expert"].reshape(-1)
    counts = torch.bincount(flat, minlength=cfg.num_experts)
    if seed:
        assert counts[-1] == 0
    probs = torch.softmax(x.float() @ torch.from_numpy(w), dim=-1)
    ce = counts.float() / flat.numel()
    want = cfg.num_experts * torch.sum(probs.mean(dim=0) * ce)
    assert torch.equal(r["aux"], want)


def test_dry_run_record_of_a_full_config():
    """qwen1.5-0.5b's decode_32k on the production mesh: the JAX
    package's keys (``depth_pair`` aside) and ``fits``, every number
    finite; the arguments are the specs' per-device sum."""
    rec = dryrun.dry_run("qwen1p5_0p5b", "decode_32k", verbose=False)
    for key in ("argument_size_in_bytes", "temp_size_in_bytes",
                "output_size_in_bytes", "flops_per_dev", "bytes_per_dev",
                "collective_bytes_per_dev", "collectives",
                "model_flops_global", "useful_flops_ratio", "compute_s",
                "memory_s", "collective_s", "dominant", "compile_s",
                "fits"):
        assert key in rec, key
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["fits"] and rec["dominant"] in ("compute", "memory",
                                               "collective")
    assert all(np.isfinite(v) for v in rec.values()
               if isinstance(v, float))
    assert rec["argument_size_in_bytes"] == dryrun.argument_bytes_from_specs(
        get_config("qwen1.5-0.5b"), get_shape("decode_32k"),
        make_production_mesh())
