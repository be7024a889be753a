"""Payload codecs: what one parameter payload costs on the wire, and what
the receiver reconstructs.

A ``PayloadCodec`` answers two questions:

  * ``wire_bytes(n_params)`` — bytes one encoded payload of ``n_params``
    parameters occupies on the wire (``CommStats`` wire-byte accounting;
    deterministic and independent of the route and the device).
  * ``roundtrip(tree)``      — ``decode(encode(tree))`` on the tree's
    device: the *reconstruction* the receiver would see.  The runtime
    simulates federation on one host, so the wire format itself is never
    materialized — only its information loss (and its byte cost) are.

Codecs are pure and stateless; server-side error-feedback state lives in
``repro_torch.comm.error_feedback`` and the engine wiring in
``repro_torch.comm.backend``.  Specs are strings validated at
``RunConfig`` construction time:

    "none"                      fp32 passthrough (4 B/param)
    "cast" | "cast:bf16"        bfloat16 cast (2 B/param)
    "cast:fp16"                 float16 cast (2 B/param)
    "int8" | "int8:kernel"      per-tensor symmetric int8 quantization
    "int8:torch"                (1 B/param + 4 B scale per payload;
                                ":kernel", the default, quantizes and
                                dequantizes with the hand-written CUDA
                                kernels, ":torch" in plain PyTorch — the
                                routes of ``RunConfig.aggregate_backend``)
    "topk" | "topk:<ratio>"     magnitude top-k sparsification (8 B per
                                kept (index, value) pair; default ratio
                                0.1)

Parameter trees are ``dict[str, Tensor]``.  Only floating-point leaves
are transformed; integer/bool leaves (none in the current master trees)
pass through untouched and are charged fp32 wire bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]

CODEC_NAMES = ("none", "cast", "int8", "topk")
INT8_ROUTES = ("torch", "kernel")

SCALE_BYTES = 4         # one float32 scale per quantized tensor
TOPK_ENTRY_BYTES = 8    # int32 flat index + float32 value per kept entry


def tree_map_float(fn: Callable[[torch.Tensor], torch.Tensor],
                   tree: Params) -> Params:
    """Apply ``fn`` to floating leaves, pass the rest through."""
    return {k: fn(x) if x.is_floating_point() else x
            for k, x in tree.items()}


@dataclasses.dataclass(frozen=True)
class PayloadCodec:
    """Base codec: fp32 passthrough (``"none"``).  Frozen dataclasses, so
    codecs compare by configuration."""

    name: str = "none"

    def wire_bytes(self, n_params: int) -> float:
        """Wire size of one encoded payload of ``n_params`` parameters."""
        return 4.0 * n_params

    def roundtrip(self, tree: Params) -> Params:
        """``decode(encode(tree))`` — the receiver's reconstruction."""
        return tree

    @property
    def is_identity(self) -> bool:
        return type(self) is PayloadCodec


@dataclasses.dataclass(frozen=True)
class CastCodec(PayloadCodec):
    """Downcast to a 16-bit float on the wire (2 B/param), upcast back."""

    name: str = "cast"
    dtype: str = "bf16"     # "bf16" | "fp16"

    def wire_bytes(self, n_params: int) -> float:
        return 2.0 * n_params

    def roundtrip(self, tree: Params) -> Params:
        wire = torch.bfloat16 if self.dtype == "bf16" else torch.float16
        return tree_map_float(lambda x: x.to(wire).to(x.dtype), tree)


def make_codec(spec: str) -> PayloadCodec:
    """Build a codec from its string spec; raise ``ValueError`` (with the
    available names) on anything unknown — called by
    ``RunConfig.__post_init__`` so bad specs fail at config time."""
    from repro_torch.comm.quantize import Int8Codec
    from repro_torch.comm.sparsify import TopKCodec

    if not isinstance(spec, str):
        raise ValueError(f"codec spec must be a string, got {spec!r}")
    head, _, arg = spec.partition(":")
    if head == "none" and not arg:
        return PayloadCodec()
    if head == "cast":
        if arg in ("", "bf16", "fp16"):
            return CastCodec(dtype=arg or "bf16")
        raise ValueError(
            f"unknown cast dtype {arg!r} in codec spec {spec!r}; "
            f"available: ['bf16', 'fp16']")
    if head == "int8":
        if arg in ("",) + INT8_ROUTES:
            return Int8Codec(backend=arg or "kernel")
        raise ValueError(
            f"unknown int8 route {arg!r} in codec spec {spec!r}; "
            f"available: {list(INT8_ROUTES)}")
    if head == "topk":
        if not arg:
            return TopKCodec()
        try:
            ratio = float(arg)
        except ValueError:
            ratio = -1.0
        if not 0.0 < ratio <= 1.0:
            raise ValueError(
                f"topk ratio must be in (0, 1], got {arg!r} "
                f"in codec spec {spec!r}")
        return TopKCodec(ratio=ratio)
    raise ValueError(
        f"unknown payload codec {spec!r}; available: {list(CODEC_NAMES)}")
