"""Plain PyTorch versions of the port's hand-written kernels.

They restate the math in the most straightforward form.  The kernel
wrappers in ``ops`` take them for tensors on the CPU, the tests hold
them against the JAX package's oracles, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch


def fill_aggregate(clients, masks, weights, prev):
    """clients, masks: (m, P); weights: (m,); prev: (P,) -> (P,) in
    prev's dtype: ``sum_k w_k * (mask_k * c_k + (1 - mask_k) * prev)``."""
    cl = clients.float()
    mk = masks.float()
    filled = mk * cl + (1 - mk) * prev.float()[None, :]
    return torch.einsum("m,mp->p", weights.float(), filled).to(prev.dtype)
