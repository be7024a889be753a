"""Carry CIFAR CNN weights between the JAX package's layout and the port's.

The JAX package nests its parameters as ``{"stem", "fc": {"w", "b"},
"blocks": [{branch: {leaf: array}}]}`` with HWIO convolutions
(depthwise ``(K, K, 1, C)``); the port keeps a flat ``dict[str, Tensor]``
under ``state_dict`` names with OIHW convolutions (depthwise
``(C, 1, K, K)``).  ``fc.w`` is ``(C, 10)`` in both, and the ``"_"``
placeholder leaf carries over.  Leaves are matched by path, never by
position; the port's order is the module's (leaves of a branch, and
``fc.b`` before ``fc.w``, in name order).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.cnn import BRANCH_NAMES

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _to_port(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(_HWIO_TO_OIHW)
    return torch.tensor(a)


def _to_ref(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(_OIHW_TO_HWIO)
    return np.ascontiguousarray(a)


def params_from_reference(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's CNN parameter tree (leaves as numpy arrays) ->
    the port's ordered ``dict[str, Tensor]`` on the CPU."""
    out = {"stem": _to_port(tree["stem"])}
    for i, blk in enumerate(tree["blocks"]):
        for nm in BRANCH_NAMES:
            for leaf in sorted(blk[nm]):
                out[f"blocks.{i}.{nm}.{leaf}"] = _to_port(blk[nm][leaf])
    out["fc.b"] = _to_port(tree["fc"]["b"])
    out["fc.w"] = _to_port(tree["fc"]["w"])
    return out


def params_to_reference(params: Dict[str, torch.Tensor]):
    """Inverse of ``params_from_reference``: numpy arrays in the JAX
    package's layout and nesting."""
    tree = {"stem": None, "fc": {}, "blocks": []}
    for k, t in params.items():
        parts = k.split(".")
        if parts[0] == "stem":
            tree["stem"] = _to_ref(t)
        elif parts[0] == "fc":
            tree["fc"][parts[1]] = _to_ref(t)
        else:
            i, nm, leaf = int(parts[1]), parts[2], parts[3]
            while len(tree["blocks"]) <= i:
                tree["blocks"].append({b: {} for b in BRANCH_NAMES})
            tree["blocks"][i][nm][leaf] = _to_ref(t)
    return tree
