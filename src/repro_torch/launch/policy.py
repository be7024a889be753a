"""Distribution policy: the mesh the models run under.

The model code is mesh-agnostic; a launcher registers the active mesh
here (``set_mesh``), and the layers with a mesh-specific formulation read
it: the MoE's expert-parallel path (``models/moe.py``) and the decode
attention that rounds its probabilities to V's dtype
(``models/attention.py``).  With no mesh registered every layer runs its
single-device formulation.  Reset it with ``set_mesh(None)``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.launch.mesh import Mesh, data_axes, mesh_axis_size

_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def data_axis_size(mesh: Mesh) -> int:
    """Devices along the data axes (``pod`` and ``data``) the mesh has."""
    return mesh_axis_size(mesh, [a for a in data_axes(mesh)
                                 if a in mesh.axis_names])
