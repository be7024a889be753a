"""Binding of the int8 quantize/dequantize CUDA kernels
(``csrc/quantize_int8.cu``).

``quantize`` and ``dequantize`` take tensors that ``ops`` has already
checked, allocate the output, launch on the current stream of the
tensors' device and raise on a launch error.  They do not synchronise;
the scale stays on the device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("quantize_int8")
        for fn in (lib.quantize_int8_f32, lib.dequantize_int8_f32):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.quantize_int8_error_string.argtypes = [ctypes.c_int]
        lib.quantize_int8_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(fn_name: str, src: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    lib = _lib()
    with torch.cuda.device(src.device):
        out = torch.empty(src.shape, dtype=out_dtype, device=src.device)
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = getattr(lib, fn_name)(src.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), src.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           + lib.quantize_int8_error_string(rc).decode())
    return out


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: (P,) float32; scale: one float32, both contiguous on one CUDA
    device -> (P,) int8."""
    return _launch("quantize_int8_f32", x, scale, torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (P,) int8; scale: one float32, both contiguous on one CUDA
    device -> (P,) float32."""
    return _launch("dequantize_int8_f32", q, scale, torch.float32)
