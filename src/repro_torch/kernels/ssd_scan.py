"""Binding of the SSD chunk-scan CUDA kernels (``csrc/ssd_scan.cu``).

``launch`` takes tensors that ``ops.ssd_scan`` has already checked,
allocates the outputs and the workspaces, launches the three stage
kernels (``STAGES``) on the current stream of the tensors' device and
raises on a launch error.  It does not synchronise.  ``STAGE_LAUNCHES``
counts the launches of each stage kernel, beside
``ops.LAUNCHES["ssd_scan"]``, which counts calls.  The state pass's first
blocks build C·Bᵀ and Cᵀ once per (batch, chunk) into (B, NC, Q, Q) and
(B, NC, N, Q) workspaces that the output stage reads for every head.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LIB = None
# the kernel's limits on the chunk length and the state size
MAX_CHUNK = 128
MAX_STATE = 128
# the stage kernels of one call, in launch order; their indices are the C
# library's stage numbers
STAGES = ("chunk_state", "state_pass", "chunk_out")
STAGE_LAUNCHES = dict.fromkeys(STAGES, 0)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("ssd_scan")
        lib.ssd_scan_fwd.argtypes = ([ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_attributes.argtypes = (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
        lib.ssd_scan_attributes.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ssd_scan {what} failed: "
                           + lib.ssd_scan_error_string(rc).decode())


def launch(xs: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
           cm: torch.Tensor):
    """xs: (B, NC, Q, H, P); a: (B, NC, Q, H); bm, cm: (B, NC, Q, N); all
    float32, contiguous, on one CUDA device -> (y (B, NC, Q, H, P),
    state (B, H, P, N))."""
    lib = _lib()
    b, nc, q, h, p = xs.shape
    n = bm.shape[-1]
    f32 = dict(dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        y = torch.empty_like(xs)
        state = torch.empty((b, h, p, n), **f32)
        states = torch.empty((b, nc, h, n, p), **f32)
        alast = torch.empty((b, nc, h), **f32)
        cbt = torch.empty((b, nc, q, q), **f32)
        ct = torch.empty((b, nc, n, q), **f32)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            xs.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), states.data_ptr(),
            alast.data_ptr(), cbt.data_ptr(), ct.data_ptr(), b, nc, q, h, p,
            n, stream)
    _check(lib, rc, "kernel launch")
    for name in STAGES:
        STAGE_LAUNCHES[name] += 1
    return y, state


def attributes() -> dict:
    """Registers a thread, local memory in bytes (spills) and shared
    memory in bytes (static and dynamic) of each stage kernel (builds the
    library if needed; needs a card)."""
    lib = _lib()
    out = {}
    for i, name in enumerate(STAGES):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _check(lib, lib.ssd_scan_attributes(
            i, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)),
            "attribute query")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "smem_bytes": smem.value}
    return out
