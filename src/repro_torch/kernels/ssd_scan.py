"""Binding of the SSD chunk-scan CUDA kernel (``csrc/ssd_scan.cu``).

``launch`` takes tensors that ``ops.ssd_scan`` has already checked,
allocates the outputs, launches on the current stream of the tensors'
device and raises on a launch error.  It does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LIB = None
# the kernel's limits on the chunk length and the state size
MAX_CHUNK = 128
MAX_STATE = 128


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("ssd_scan")
        lib.ssd_scan_fwd.argtypes = ([ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(xs: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
           cm: torch.Tensor):
    """xs: (B, NC, Q, H, P); a: (B, NC, Q, H); bm, cm: (B, NC, Q, N); all
    float32, contiguous, on one CUDA device -> (y (B, NC, Q, H, P),
    state (B, H, P, N))."""
    lib = _lib()
    b, nc, q, h, p = xs.shape
    n = bm.shape[-1]
    with torch.cuda.device(xs.device):
        y = torch.empty_like(xs)
        state = torch.empty((b, h, p, n), dtype=torch.float32,
                            device=xs.device)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.ssd_scan_fwd(xs.data_ptr(), a.data_ptr(), bm.data_ptr(),
                              cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                              b, nc, q, h, p, n, stream)
    if rc != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(rc).decode())
    return y, state
