"""Plain PyTorch versions of the port's hand-written kernels.

They restate the math in the most straightforward form.  The kernel
wrappers in ``ops`` take them for tensors on the CPU, the tests hold
them against the JAX package's oracles, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def fill_aggregate(clients, masks, weights, prev):
    """clients, masks: (m, P); weights: (m,); prev: (P,) -> (P,) in
    prev's dtype: ``sum_k w_k * (mask_k * c_k + (1 - mask_k) * prev)``."""
    cl = clients.float()
    mk = masks.float()
    filled = mk * cl + (1 - mk) * prev.float()[None, :]
    return torch.einsum("m,mp->p", weights.float(), filled).to(prev.dtype)


def fill_aggregate_(clients, masks, weights, prev):
    """``fill_aggregate`` written over ``prev``, which is returned (the
    in-place variant; the same bits)."""
    return prev.copy_(fill_aggregate(clients, masks, weights, prev))


def expert_gemm(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype: the
    per-expert product ``x[e] @ w[e]`` on float32 copies, rounded once."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


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


# The JAX package writes the scale as ``max / 127``, and XLA compiles a
# division by a constant into a multiply by its float32 reciprocal; the
# port multiplies explicitly so that the scales agree bit for bit.
_INV_QMAX = float(np.float32(1.0) / np.float32(127.0))


def int8_scale(x):
    """Per-tensor symmetric scale ``max|x| / 127`` as a 0-d float32 on
    x's device (floored so an all-zero tensor round-trips to zeros
    instead of dividing by 0)."""
    return torch.clamp_min(x.float().abs().amax(), 1e-12) * _INV_QMAX


def int8_scales(leaves):
    """The scale pass over a tree: ``int8_scale`` of each leaf -> (N,)
    float32."""
    return torch.stack([int8_scale(x) for x in leaves])


def quantize_int8_leaves(leaves, layout, scales=None):
    """Each leaf quantized with its scale (``int8_scales`` where none
    are given) into its segment of one flat int8 buffer of
    ``layout.total`` elements (the gaps are zero) -> (q_flat, scales)."""
    if scales is None:
        scales = int8_scales(leaves)
    q_flat = torch.zeros(layout.total, dtype=torch.int8,
                         device=leaves[0].device)
    for x, s, off in zip(leaves, scales, layout.offsets.tolist()):
        q_flat[off: off + x.numel()] = quantize_int8(x.reshape(-1), s)
    return q_flat, scales


def dequantize_int8_leaves(q_flat, scales, layout):
    """Each leaf's segment of ``q_flat`` times its scale, into the same
    segment of one flat float32 buffer -> the leaves, as views of it
    with their shapes."""
    out = torch.zeros(layout.total, dtype=torch.float32,
                      device=q_flat.device)
    for s, n, off in zip(scales, layout.numels.tolist(),
                         layout.offsets.tolist()):
        out[off: off + n] = dequantize_int8(q_flat[off: off + n], s)
    return layout.views(out)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, D); k, v: (B, S, Kh, D) -> (B, S, H, D) in q's dtype:
    softmax(q kᵀ / √D) v in float32, K/V repeated to the H query heads,
    keys masked to ``k <= q`` (causal) and ``k > q - window`` (window),
    masked scores set to -1e30."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    if kh != h:
        k = torch.repeat_interleave(k, h // kh, dim=2)
        v = torch.repeat_interleave(v, h // kh, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window:
        mask = mask & (ki > qi - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def ssd_scan(xs, a, bm, cm):
    """The sequential (non-chunked) SSD recurrence, the ground truth.

    xs: (B, NC, Q, H, P) inputs pre-scaled by dt; a: (B, NC, Q, H)
    log-decay; bm, cm: (B, NC, Q, N).  Per step t, from a zero state,
    ``S = S * exp(a_t) + x_t ⊗ b_t`` and ``y_t = S · c_t``.  Returns
    (y (B, NC, Q, H, P), final state (B, H, P, N)), both float32.
    """
    b, nc, q, h, p = xs.shape
    n = bm.shape[-1]
    x_f = xs.reshape(b, nc * q, h, p).float()
    a_f = a.reshape(b, nc * q, h).float()
    b_f = bm.reshape(b, nc * q, n).float()
    c_f = cm.reshape(b, nc * q, n).float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(nc * q):
        state = (state * torch.exp(a_f[:, t])[:, :, None, None]
                 + torch.einsum("bhp,bn->bhpn", x_f[:, t], b_f[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", c_f[:, t], state))
    y = torch.stack(ys, dim=1).reshape(b, nc, q, h, p)
    return y, state
