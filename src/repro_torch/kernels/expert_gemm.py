"""Binding of the grouped expert GEMM CUDA kernel (``csrc/expert_gemm.cu``).

``launch`` takes tensors that ``ops.expert_gemm`` has already checked,
allocates the output, launches on the current stream of the tensors'
device and raises on a launch error.  It does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("expert_gemm")
        lib.expert_gemm_fwd.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.expert_gemm_fwd.restype = ctypes.c_int
        lib.expert_gemm_error_string.argtypes = [ctypes.c_int]
        lib.expert_gemm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F); one dtype (float32 or bfloat16),
    contiguous, on one CUDA device -> (E, C, F) in x's dtype."""
    lib = _lib()
    e, c, d = x.shape
    f = w.shape[2]
    with torch.cuda.device(x.device):
        out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.expert_gemm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 _DTYPES[x.dtype], e, c, d, f, stream)
    if rc != 0:
        raise RuntimeError("expert_gemm kernel launch failed: "
                           + lib.expert_gemm_error_string(rc).decode())
    return out
