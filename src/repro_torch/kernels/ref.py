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


def quantize_int8(x, scale):
    """x: (P,) float; scale: 0-d or (1,) float32 -> (P,) int8 on the
    symmetric 255-level grid: ``x / scale`` rounded half to even, clipped
    to [-127, 127].  A true division, as the JAX package's: a multiply by
    ``1 / scale`` moves some results across a rounding tie.  (PyTorch
    itself divides by a reciprocal when the divisor is a CPU scalar and
    the dividend a CUDA tensor, so ``scale`` must lie beside ``x``.)"""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def dequantize_int8(q, scale):
    """q: (P,) int8; scale: 0-d or (1,) float32 -> (P,) float32
    (``q * scale``)."""
    return q.float() * scale
