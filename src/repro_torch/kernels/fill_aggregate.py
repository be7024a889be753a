"""Binding of the fill-aggregation CUDA kernel (``csrc/fill_aggregate.cu``).

``launch`` takes tensors that ``ops.fill_aggregate`` has already
checked, allocates the output, launches on the current stream of the
tensors' device and raises on a launch error.  It does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("fill_aggregate")
        lib.fill_aggregate_f32.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        lib.fill_aggregate_f32.restype = ctypes.c_int
        lib.fill_aggregate_error_string.argtypes = [ctypes.c_int]
        lib.fill_aggregate_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(clients: torch.Tensor, masks: torch.Tensor, weights: torch.Tensor,
           prev: torch.Tensor) -> torch.Tensor:
    """clients, masks: (m, P); weights: (m,); prev: (P,), all float32,
    contiguous, on one CUDA device -> (P,) float32."""
    lib = _lib()
    m, p = clients.shape
    with torch.cuda.device(prev.device):
        out = torch.empty_like(prev)
        stream = torch.cuda.current_stream(prev.device).cuda_stream
        rc = lib.fill_aggregate_f32(
            clients.data_ptr(), masks.data_ptr(), weights.data_ptr(),
            prev.data_ptr(), out.data_ptr(), m, p, stream)
    if rc != 0:
        raise RuntimeError("fill_aggregate kernel launch failed: "
                           + lib.fill_aggregate_error_string(rc).decode())
    return out
