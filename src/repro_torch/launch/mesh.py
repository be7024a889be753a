"""Device meshes of one process, and their collectives.

A ``Mesh`` is a grid of ``torch.device``s with named axes, ``("data",
"model")`` or ``("pod", "data", "model")``, as the JAX package's
``jax.sharding.Mesh``: one controller drives every device of it, never a
process per device.  So the collectives are plain tensor operations in
that one process (``psum``, ``all_gather``, ``all_to_all`` below); on a
one-device mesh each is the identity and copies nothing.

A mesh may name one device more than once: ``make_host_mesh(devices=
["cpu"] * 8)`` is an 8-way ``data`` axis on the CPU, which is how the
tests grow a mesh where the JAX package forces 8 host devices
(``--xla_force_host_platform_device_count``).

Functions, never module-level meshes: importing this module touches no
device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A grid of devices (``devices``: a numpy object array of
    ``torch.device`` with the mesh's shape) with one name per axis.
    ``shape`` maps each axis name to its size, in axis order; ``size`` is
    the number of grid points.  ``devices`` is None for an abstract mesh
    (shape and names only: what the sharding specs read; it places
    nothing)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.devices = None
        if devices is not None:
            flat = [torch.device(d) for d in devices]
            if len(flat) != self.size:
                raise ValueError(f"{len(flat)} devices for a mesh of "
                                 f"{self.size}")
            grid = np.empty(self.size, dtype=object)
            grid[:] = flat
            self.devices = grid.reshape(tuple(self.shape.values()))

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def axis_devices(self, axes) -> list:
        """The devices along ``axes`` (one name or a tuple of names), in
        row-major order over those axes, every other axis at index 0: the
        device of each shard when an array is split over ``axes`` and
        replicated over the rest."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        index = tuple(slice(None) if a in axes else 0
                      for a in self.axis_names)
        return list(self.devices[index].reshape(-1))

    def __repr__(self) -> str:
        where = "abstract" if self.devices is None else \
            sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, {where})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout as an abstract mesh: ``(16, 16)`` over
    ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` with ``multi_pod``.  It names no device: the sharding
    specs read its shape."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """An ``(n, 1)`` mesh over ``("data", "model")``: every visible CUDA
    device when ``devices`` is None, else the listed devices in order
    (they may repeat).  Raises ``RuntimeError`` when ``devices`` is None
    and no CUDA device is visible: there is no fallback to the CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_host_mesh: no CUDA device is visible; "
                               "pass devices=['cpu'] for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if not devices:
        raise ValueError("make_host_mesh: no devices")
    return Mesh((len(devices), 1), ("data", "model"), devices)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the global batch, or the engine's population axis, is
    sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fsdp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the parameters' 'replicated' dim is FSDP-sharded over."""
    return data_axes(mesh)


def mesh_axis_size(mesh: Mesh, axes) -> int:
    """Total device count along ``axes`` (one name or a tuple of names)."""
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# Collectives of one process: a value "on the mesh" is a list with one
# entry per device, in device order; trees are dicts and lists of tensors
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def replicate(tree, device: torch.device):
    """``tree`` with every tensor on ``device`` (the tensor itself where
    it is there already)."""
    return _tree_map(lambda x: x.to(device), tree)


def psum(parts: Sequence):
    """The sum of the per-device trees ``parts``, on the first one's
    device, added in device order; one part is returned as it is."""
    acc = parts[0]
    for part in parts[1:]:
        acc = _tree_map(lambda a, b: a + b.to(a.device), acc, part)
    return acc


def all_gather(parts: Sequence, dim: int = 0):
    """The per-device trees ``parts`` concatenated along ``dim``, on the
    first one's device; one part is returned as it is."""
    if len(parts) == 1:
        return parts[0]

    def cat(*xs):
        return torch.cat([x.to(xs[0].device) for x in xs], dim=dim)

    return _tree_map(cat, *parts)


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> list:
    """The tiled all-to-all of M per-device tensors: device i receives
    block i of every device's ``split_dim`` (M equal blocks), concatenated
    along ``concat_dim`` in device order, on its own device.  One device
    keeps its tensor."""
    m = len(xs)
    if m == 1:
        return list(xs)
    blocks = [x.chunk(m, dim=split_dim) for x in xs]
    return [torch.cat([blocks[j][i].to(xs[i].device) for j in range(m)],
                      dim=concat_dim) for i in range(m)]
