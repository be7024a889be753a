"""Int8 payload codec: per-tensor symmetric quantization.

Every floating leaf is quantized independently with one float32 scale
``max|x| / 127``; values land on the 255-level symmetric grid
``{-127..127} * scale`` (so ``x == 0`` maps to exactly 0 and the maximum
round-trip error is ``scale / 2``).  Wire cost is 1 byte per parameter
plus ``SCALE_BYTES`` per payload (one amortized scale: the tensor count
of a payload is not recoverable from a parameter count alone).

``backend="kernel"`` runs the elementwise quantize/dequantize through
the wrappers of the hand-written CUDA kernels (``repro_torch.kernels.ops``:
one launch of each per leaf on the card, the plain version for a tree on
the CPU); ``"torch"`` runs the plain versions (``repro_torch.kernels.ref``)
on any device.  The scale never leaves the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.codec import SCALE_BYTES, PayloadCodec, \
    tree_map_float

QMAX = 127.0
# The JAX package writes the scale as ``max / 127``, and XLA compiles a
# division by a constant into a multiply by its float32 reciprocal; the
# port multiplies explicitly so that the scales agree bit for bit.
_INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))


def leaf_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric scale ``max|x| / 127`` as a 0-d float32 on
    x's device (floored so an all-zero tensor round-trips to zeros
    instead of dividing by 0)."""
    return torch.clamp_min(x.float().abs().amax(), 1e-12) * _INV_QMAX


def _roundtrip(tree, quantize, dequantize):
    def leaf(x):
        xf = x.reshape(-1).float().contiguous()
        scale = leaf_scale(xf)
        q = quantize(xf, scale)
        return dequantize(q, scale).view(x.shape).to(x.dtype)

    return tree_map_float(leaf, tree)


@dataclasses.dataclass(frozen=True)
class Int8Codec(PayloadCodec):
    """Per-tensor symmetric int8 quantization (1 B/param on the wire)."""

    name: str = "int8"
    backend: str = "kernel"     # 'kernel' | 'torch' quantize/dequantize route

    def wire_bytes(self, n_params: int) -> float:
        return 1.0 * n_params + SCALE_BYTES

    def roundtrip(self, tree):
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            return _roundtrip(tree, ops.quantize_int8, ops.dequantize_int8)
        from repro_torch.kernels import ref
        return _roundtrip(tree, ref.quantize_int8, ref.dequantize_int8)
