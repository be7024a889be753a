"""repro_torch.ckpt against the JAX package's ``repro.ckpt``.

Mirrors the four checkpoint cases of ``tests/test_optim_ckpt.py`` on
tensors (a roundtrip with bf16 and an int32 scalar, the newest step, an
empty directory, a shape mismatch), then holds the two packages to one
file format: the same nested numpy tree saved by each gives npz files
with equal keys and bit-equal arrays, and each loads the other's.  The
port's CNN master is a flat dict of dotted names, whose dots the key
rule strips: its keys stay distinct, one per leaf, and it round-trips
bit for bit.  No JAX engine run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.ckpt import load_pytree, restore_latest, \
    save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cnn_supernet_api  # noqa: E402


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    tree = {"layers": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.tensor([1.5, -2.25, 3.0],
                                         dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    path = save_pytree(str(tmp_path / "ckpt"), tree, step=7)
    assert path.endswith("step_00000007.npz")
    with np.load(path) as data:
        assert data["layers/b"].dtype == np.float32   # bf16 saved as f32
    template = {"layers": {k: torch.zeros_like(v)
                           for k, v in tree["layers"].items()},
                "step": torch.zeros((), dtype=torch.int32)}
    restored = load_pytree(path, template)
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_restore_latest_picks_newest(tmp_path):
    tree = {"w": torch.zeros(3)}
    d = str(tmp_path / "ckpts")
    save_pytree(d, {"w": torch.ones(3)}, step=1)
    save_pytree(d, {"w": torch.full((3,), 2.0)}, step=2)
    restored, step = restore_latest(d, tree)
    assert step == 2
    assert torch.equal(restored["w"], torch.full((3,), 2.0))


def test_restore_latest_empty(tmp_path):
    restored, step = restore_latest(str(tmp_path / "nope"),
                                    {"w": torch.zeros(1)})
    assert restored is None and step == -1
    (tmp_path / "empty").mkdir()
    assert restore_latest(str(tmp_path / "empty"),
                          {"w": torch.zeros(1)}) == (None, -1)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = save_pytree(str(tmp_path / "c"), {"w": torch.zeros((2, 2))},
                       step=0)
    with pytest.raises(ValueError):
        load_pytree(path, {"w": torch.zeros((3, 3))})


def nested_tree():
    rng = np.random.default_rng(0)
    return {"stem": {"conv.w": rng.standard_normal((3, 3, 2, 4),
                                                  dtype=np.float32)},
            "blocks": [{"w": rng.standard_normal((4,), dtype=np.float32),
                        "count": np.arange(3, dtype=np.int32)},
                       {"w": rng.standard_normal((2, 2)).astype(np.float32),
                        "flag": np.asarray([True, False])}],
            "head": (np.float64(0.5), rng.integers(0, 9, (5,)))}


@pytest.fixture(scope="module")
def ref_ckpt():
    """The JAX package's checkpoints, imported here so that a machine
    without JAX (the card's) still runs the card-only case."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.ckpt import load_pytree, save_pytree
    return jax, jnp, save_pytree, load_pytree


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_match_reference(tmp_path, ref_ckpt, writer):
    """Each package's file of the same nested tree: equal keys, arrays bit
    for bit, and the other package loads it."""
    jax, jnp, ref_save, ref_load = ref_ckpt
    tree = nested_tree()
    ours = save_pytree(str(tmp_path / "port.npz"), tree)
    ref = ref_save(str(tmp_path / "ref.npz"), tree)
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            ["stem/convw", "blocks/0/w", "blocks/0/count", "blocks/1/w",
             "blocks/1/flag", "head/0", "head/1"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
    path = ours if writer == "port" else ref
    template = jax.tree.map(np.zeros_like, tree)
    by_ref = ref_load(path, jax.tree.map(jnp.asarray, template))
    by_port = load_pytree(path, jax.tree.map(torch.from_numpy, jax.tree.map(
        np.asarray, template)))
    for want, r, p in zip(jax.tree.leaves(tree), jax.tree.leaves(by_ref),
                          leaves(by_port)):
        assert np.array_equal(np.asarray(r), np.asarray(want, r.dtype))
        assert np.array_equal(p.numpy(), np.asarray(want))


def test_cnn_master_roundtrip(tmp_path):
    """The smoke CNN master (flat state-dict names): one key per leaf,
    back bit for bit on the template's device."""
    api = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    master = api.init(torch.Generator().manual_seed(0))
    path = save_pytree(str(tmp_path / "m"), master, step=3)
    with np.load(path) as data:
        # block indices are followed by a branch name, never a digit, so
        # stripping the dots keeps the names apart
        assert sorted(data.files) == sorted(k.replace(".", "")
                                            for k in master)
        assert len(data.files) == len(master)
        assert "blocks0residualc1" in data.files
    restored, step = restore_latest(str(tmp_path / "m"),
                                    {k: torch.zeros_like(v)
                                     for k, v in master.items()})
    assert step == 3 and list(restored) == list(master)
    for k, v in master.items():
        assert restored[k].device == v.device and torch.equal(restored[k], v)


def test_colliding_keys_raise(tmp_path):
    """Two names that differ only in dots would share one key: refused,
    not overwritten."""
    with pytest.raises(ValueError, match="ab"):
        save_pytree(str(tmp_path / "c.npz"),
                    {"a.b": torch.zeros(1), "ab": torch.ones(1)})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_restore_onto_cuda_template(cuda, tmp_path):
    tree = {"w": torch.randn(4, 3), "b": torch.randn(3).to(torch.bfloat16)}
    save_pytree(str(tmp_path / "g"), tree, step=0)
    restored, _ = restore_latest(str(tmp_path / "g"),
                                 {k: torch.zeros_like(v, device=cuda)
                                  for k, v in tree.items()})
    for k, v in tree.items():
        assert restored[k].device.type == "cuda"
        assert torch.equal(restored[k].cpu(), v)
