"""Int8 payload codec: per-tensor symmetric quantization.

Every floating leaf is quantized independently with one float32 scale
``max|x| / 127``; values land on the 255-level symmetric grid
``{-127..127} * scale`` (so ``x == 0`` maps to exactly 0 and the maximum
round-trip error is ``scale / 2``).  Wire cost is 1 byte per parameter
plus ``SCALE_BYTES`` per payload (one amortized scale: the tensor count
of a payload is not recoverable from a parameter count alone).

``backend="kernel"`` runs the whole tree through the wrappers of the
hand-written CUDA kernels (``repro_torch.kernels.ops``): one launch each
of the scale pass, K2a and K2b per 256 leaves on the card, the plain
version over the same flat layout on the CPU; the reconstructed leaves
are views of one flat buffer.  ``"torch"`` runs the plain versions
(``repro_torch.kernels.ref``) leaf by leaf on any device.  The scales
never leave the device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.comm.codec import SCALE_BYTES, PayloadCodec, \
    tree_map_float
from repro_torch.kernels.ref import int8_scale as leaf_scale


def _roundtrip(tree, quantize, dequantize):
    def leaf(x):
        xf = x.reshape(-1).float().contiguous()
        scale = leaf_scale(xf)
        q = quantize(xf, scale)
        return dequantize(q, scale).view(x.shape).to(x.dtype)

    return tree_map_float(leaf, tree)


def _roundtrip_tree(tree):
    from repro_torch.kernels import ops

    keys = [k for k, x in tree.items() if x.is_floating_point()]
    if not keys:
        return dict(tree)
    q, scales, layout = ops.quantize_int8_leaves(
        [tree[k].float().contiguous() for k in keys])
    out = dict(tree)
    for k, y in zip(keys, ops.dequantize_int8_leaves(q, scales, layout)):
        out[k] = y.to(tree[k].dtype)
    return out


@dataclasses.dataclass(frozen=True)
class Int8Codec(PayloadCodec):
    """Per-tensor symmetric int8 quantization (1 B/param on the wire)."""

    name: str = "int8"
    backend: str = "kernel"     # 'kernel' | 'torch' quantize/dequantize route

    def wire_bytes(self, n_params: int) -> float:
        return 1.0 * n_params + SCALE_BYTES

    def roundtrip(self, tree):
        if self.backend == "kernel":
            return _roundtrip_tree(tree)
        from repro_torch.kernels import ref
        return _roundtrip(tree, ref.quantize_int8, ref.dequantize_int8)
