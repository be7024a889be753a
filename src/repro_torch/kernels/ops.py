"""Public wrappers of the port's hand-written kernels.

Each wrapper checks its inputs and raises on anything the kernel does not
take.  For tensors on the CPU it computes the plain version in ``ref``;
for CUDA tensors it launches the kernel or raises — it never falls back.
``LAUNCHES`` counts kernel launches per wrapper (and nothing else), so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES = {"fill_aggregate": 0}


def _common_device(name: str, *tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on mixed devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def fill_aggregate(clients: torch.Tensor, masks: torch.Tensor,
                   weights: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """clients, masks: (m, P); weights: (m,); prev: (P,), float32 and
    contiguous -> (P,) float32 (paper Algorithm 3 on a flat vector)."""
    dev = _common_device("fill_aggregate", clients, masks, weights, prev)
    for nm, t in (("clients", clients), ("masks", masks),
                  ("weights", weights), ("prev", prev)):
        if t.dtype != torch.float32:
            raise TypeError(f"fill_aggregate: {nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fill_aggregate: {nm} must be contiguous")
    if clients.dim() != 2 or prev.dim() != 1 or weights.dim() != 1:
        raise ValueError("fill_aggregate: need clients (m, P), weights (m,), "
                         f"prev (P,); got {tuple(clients.shape)}, "
                         f"{tuple(weights.shape)}, {tuple(prev.shape)}")
    m, p = clients.shape
    if (masks.shape != clients.shape or weights.shape[0] != m
            or prev.shape[0] != p):
        raise ValueError("fill_aggregate: shape mismatch: clients "
                         f"{tuple(clients.shape)}, masks {tuple(masks.shape)}, "
                         f"weights {tuple(weights.shape)}, prev {tuple(prev.shape)}")
    if m < 1 or p < 1:
        raise ValueError(f"fill_aggregate: empty input (m={m}, P={p})")
    if dev.type == "cpu":
        return ref.fill_aggregate(clients, masks, weights, prev)
    from repro_torch.kernels import fill_aggregate as _fa
    out = _fa.launch(clients, masks, weights, prev)
    LAUNCHES["fill_aggregate"] += 1
    return out
