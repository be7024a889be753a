"""Binding of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``launch`` takes tensors that ``ops.flash_attention`` has already
checked, allocates the output, launches on the current stream of the
tensors' device and raises on a launch error.  It does not synchronise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Kh, D); one dtype (float32 or
    bfloat16), contiguous, on one CUDA device -> (B, S, H, D)."""
    lib = _lib()
    b, s, h, d = q.shape
    kh = k.shape[2]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, h, kh, d, 1.0 / math.sqrt(d),
            int(causal), int(window), stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return out
