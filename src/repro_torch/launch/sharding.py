"""Sharding policy: megatron tensor parallel + FSDP hybrid, as specs.

Rules are path-based over the parameter tree; every rule degrades to
replication when a dimension is not divisible by its mesh axis (an odd
vocabulary such as whisper's 51866 cannot shard over model = 16, so the
embedding flips to sharding d_model instead).

A spec is a tuple with one entry per dim of the leaf: an axis name, a
tuple of axis names or None (replicated), entry for entry the JAX
package's ``PartitionSpec``.  Layout (2D logical mesh: data ~ fsdp axis,
model ~ tensor axis):

  embed (V, d)           -> (model, fsdp)  [or (None, fsdp) if V % model]
  attn wq/wk/wv (d, Hh)  -> (fsdp, model);  wo (Hh, d) -> (model, fsdp)
  mlp wi/wg (d, f)       -> (fsdp, model);  wo (f, d)  -> (model, fsdp)
  moe experts (E, d, f)  -> (model = expert parallel, fsdp, None)
  ssm in_proj (d, x)     -> (fsdp, model);  out_proj   -> (model, fsdp)
  norms / scalars        -> replicated

The port keeps per-layer leaves in a list of dicts where the JAX package
stacks them on ``(L, ...)`` (``repro_torch/convert.py``), so a layer
leaf's spec here is the JAX package's without its leading stacked
``None``s; the rules right-align on the trailing dims, so dropping those
dims changes no other entry.  Where the JAX package's
``param_shardings`` gives a ``NamedSharding`` per leaf, the port's gives
a ``LeafSharding``: the leaf's spec, its shape and the shape one device
holds; the dry run (``launch/dryrun.py``) sums the per-device bytes
from these.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

from repro_torch.launch.mesh import Mesh, data_axes, mesh_axis_size

Spec = Tuple[Any, ...]


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    return mesh_axis_size(mesh, tuple(axis) if isinstance(axis, list)
                          else axis)


def _fits(mesh: Mesh, dim: int, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _entry(axis):
    """One spec entry as ``PartitionSpec`` keeps it: a tuple of one axis
    name is that name."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def _guarded(mesh: Mesh, shape: Sequence[int], spec: Sequence) -> Spec:
    """Replicate any dim that does not divide its assigned axis."""
    return tuple(_entry(axis) if (axis is not None
                                  and _fits(mesh, dim, axis))
                 else None for dim, axis in zip(shape, spec))


def param_spec(mesh: Mesh, path: str, shape: Sequence[int]) -> Spec:
    """The spec of one parameter leaf, identified by its '/' path."""
    fsdp = data_axes(mesh)          # ("pod", "data") or ("data",)
    ndim = len(shape)

    def base(spec2d):
        """Right-align a trailing-dims spec; leading dims replicate."""
        pad = [None] * (ndim - len(spec2d))
        return _guarded(mesh, shape, pad + list(spec2d))

    name = path.split("/")[-1]
    if "embed" in path and name == "table":
        if _fits(mesh, shape[0], "model"):
            return base(["model", fsdp])
        # odd vocabularies (whisper 51866, granite 49155, ...): the JAX
        # package replicates these tables (all under 300 MB)
        return base([None, fsdp])
    if "experts" in path:
        if name in ("wi", "wg"):
            return base(["model", fsdp, None])
        if name == "wo":
            return base(["model", None, fsdp])
    if "router" in path:
        return base([None, None])
    if name == "w":
        parent = path.split("/")[-2]
        if parent in ("wq", "wk", "wv", "wi", "wg", "in_proj", "proj"):
            return base([fsdp, "model"])
        if parent in ("wo", "out_proj"):
            return base(["model", fsdp])
        if parent.startswith(("z_proj", "x_proj", "b_proj", "c_proj",
                              "dt_proj")):
            return base([fsdp, "model"])
        if parent.startswith("conv"):
            return base([None, "model"])
        if parent == "fc":
            return base([None, None])
    if name == "b":
        parent = path.split("/")[-2]
        if parent in ("wq", "wk", "wv", "wi", "wg", "in_proj") or \
                parent.startswith(("conv", "z_proj", "x_proj", "b_proj",
                                   "c_proj", "dt_proj")):
            return base(["model"])
        return base([None])
    # conv_w, A_log, dt_bias, D, norms, scalars -> replicated
    return (None,) * ndim


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's (meta tensors too), anything with a
    ``.shape``, and () for a host scalar (the decode cache's ``t``)."""
    if isinstance(leaf, (int, float)):
        return ()
    return tuple(leaf.shape)


def param_specs(mesh: Mesh, params) -> Any:
    """The tree of specs matching ``params`` (dicts and lists of leaves
    that carry a ``.shape``: meta tensors place nothing)."""
    return _map_with_path(
        lambda p, leaf: param_spec(mesh, p, _shape(leaf)), params)


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """One leaf as a mesh holds it: its ``spec``, its ``shape``, the
    ``local_shape`` of each device's block (each dim over the product of
    its axes' sizes; the specs split only dims that those divide) and
    the whole leaf's ``nbytes`` (0 for a host scalar)."""

    spec: Spec
    shape: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    nbytes: int

    def divisor(self, mesh: Mesh, axes=None) -> int:
        """The number of blocks the spec cuts the leaf into, counting
        only the axes in ``axes`` when it is given."""
        names = [a for entry in self.spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry)]
        return math.prod(mesh.shape[a] for a in names
                         if axes is None or a in axes)

    @property
    def local_nbytes(self) -> int:
        n = math.prod(self.shape)
        return self.nbytes // n * math.prod(self.local_shape) if n else 0


def leaf_sharding(mesh: Mesh, spec: Spec, leaf) -> LeafSharding:
    shape = _shape(leaf)
    local = tuple(dim // _axis_size(mesh, axis)
                  for dim, axis in zip(shape, spec))
    nbytes = 0 if isinstance(leaf, (int, float)) else \
        leaf.numel() * leaf.element_size()
    return LeafSharding(tuple(spec), shape, local, nbytes)


def param_shardings(mesh: Mesh, params) -> Any:
    """The tree of ``LeafSharding``s matching ``params``."""
    return _map_with_path(
        lambda p, leaf: leaf_sharding(mesh, param_spec(mesh, p,
                                                       _shape(leaf)), leaf),
        params)


def flat_shardings(tree, path=()) -> Dict[str, LeafSharding]:
    """``{'/' path: LeafSharding}`` of a tree of them."""
    if isinstance(tree, LeafSharding):
        return {"/".join(path): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, LeafSharding] = {}
    for k, v in items:
        out.update(flat_shardings(v, path + (str(k),)))
    return out


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------

def batch_spec(mesh: Mesh, batch_size: int, ndim: int) -> Spec:
    """Shard the leading batch dim over the data axes when divisible.

    Also what ``engine/mesh_backend.py`` splits the engine's
    population-stacked arrays (leading axis: the padded population) by."""
    fsdp = data_axes(mesh)
    lead = fsdp if batch_size % _axis_size(mesh, fsdp) == 0 else None
    return (_entry(lead),) + (None,) * (ndim - 1)


def cache_spec(mesh: Mesh, path: str, shape: Sequence[int],
               batch: int) -> Spec:
    """KV/SSM cache sharding: batch over data when divisible, the head
    dim over model (else the cache sequence dim); SSM state heads over
    model."""
    fsdp = data_axes(mesh)
    name = path.split("/")[-1]
    bdim = fsdp if batch % _axis_size(mesh, fsdp) == 0 else None
    ndim = len(shape)
    if name in ("k", "v", "cross_k", "cross_v"):
        # (..., B, C, Kh, hd).  Head dim over 'model' keeps the ring
        # write local to a shard; the cache length otherwise
        if _fits(mesh, shape[-1], "model"):
            spec = [None] * (ndim - 4) + [bdim, None, None, "model"]
        else:
            spec = [None] * (ndim - 4) + [bdim, "model", None, None]
        return _guarded(mesh, shape, spec)
    if name == "state":
        # (..., B, H, P, N)
        spec = [None] * (ndim - 4) + [bdim, "model", None, None]
        return _guarded(mesh, shape, spec)
    if name.startswith("conv"):
        # (..., B, K-1, C)
        spec = [None] * (ndim - 3) + [bdim, None, "model"]
        return _guarded(mesh, shape, spec)
    return (None,) * ndim


def cache_specs(mesh: Mesh, cache, batch: int) -> Any:
    """The tree of specs matching a decode ``cache``; the host int ``t``
    gets the empty spec of a scalar."""
    return _map_with_path(
        lambda p, leaf: cache_spec(mesh, p, _shape(leaf), batch), cache)


def cache_shardings(mesh: Mesh, cache, batch: int) -> Any:
    """The tree of ``LeafSharding``s matching a decode ``cache``."""
    return _map_with_path(
        lambda p, leaf: leaf_sharding(mesh, cache_spec(mesh, p, _shape(leaf),
                                                       batch), leaf), cache)
