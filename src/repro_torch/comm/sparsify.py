"""Top-k payload codec: magnitude sparsification.

Each floating leaf keeps its ``k = max(1, round(ratio * size))``
largest-magnitude entries and zeroes the rest.  Ties resolve by
position, lower flat index first, as ``lax.top_k`` resolves them in the
JAX package: the entries are ranked by a stable descending sort
(``torch.topk`` leaves the order of ties unspecified).  The wire carries
one (int32 flat index, float32 value) pair per kept entry —
``TOPK_ENTRY_BYTES`` each — i.e. ``8 * ratio`` bytes per parameter.

Top-k is a *biased* compressor (it systematically drops small
coordinates), so on the uplink it is composed with the server-side
error-feedback residual in ``repro_torch.comm.error_feedback``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm.codec import TOPK_ENTRY_BYTES, PayloadCodec, \
    tree_map_float


def leaf_k(size: int, ratio: float) -> int:
    """Entries kept for a ``size``-element tensor (always at least 1)."""
    return max(1, min(size, int(round(ratio * size))))


def _roundtrip(tree, ratio: float):
    def leaf(x):
        xf = x.reshape(-1).float()
        k = leaf_k(xf.numel(), ratio)
        idx = torch.sort(xf.abs(), descending=True, stable=True).indices[:k]
        out = torch.zeros_like(xf)
        out[idx] = xf[idx]
        return out.view(x.shape).to(x.dtype)

    return tree_map_float(leaf, tree)


@dataclasses.dataclass(frozen=True)
class TopKCodec(PayloadCodec):
    """Keep the ``ratio`` largest-magnitude entries per tensor."""

    name: str = "topk"
    ratio: float = 0.1

    def wire_bytes(self, n_params: int) -> float:
        return TOPK_ENTRY_BYTES * leaf_k(max(n_params, 1), self.ratio)

    def roundtrip(self, tree):
        return _roundtrip(tree, self.ratio)
