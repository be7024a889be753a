"""repro_torch.comm: payload codecs for the federated wire.

What one sub-model payload costs on the wire (``PayloadCodec.wire_bytes``
-> ``CommStats`` wire-byte accounting) and what the receiver
reconstructs (``PayloadCodec.roundtrip``), composed with server-side
error feedback (``ErrorFeedback``) and applied around the execution
backend by ``CodecBackend``.  Select codecs per direction with
``RunConfig(uplink_codec=..., downlink_codec=...)``; specs are validated
at config time via ``make_codec``.
"""
from repro_torch.comm.backend import CodecBackend
from repro_torch.comm.codec import (
    CODEC_NAMES, CastCodec, PayloadCodec, make_codec,
)
from repro_torch.comm.error_feedback import ErrorFeedback
from repro_torch.comm.quantize import Int8Codec
from repro_torch.comm.sparsify import TopKCodec

__all__ = [
    "CODEC_NAMES", "CastCodec", "CodecBackend", "ErrorFeedback",
    "Int8Codec", "PayloadCodec", "TopKCodec", "make_codec",
]
