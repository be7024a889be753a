"""Binding of the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

Three kernels compute the same function.  ``variant`` picks one from the
dtype, the head dim and the pointers' alignment alone, never after an
error: bf16 with D a multiple of 8 and 16-byte aligned inputs (what TMA
can describe) runs the tensor-core kernel (``flash_attention_tc_fwd``:
wgmma on TMA-fed shared-memory tiles); float32 with D a multiple of 4
and aligned inputs the TMA-fed float32 kernel
(``flash_attention_f32_fwd``: both products as register-tiled FP32 FMAs
on shared-memory tiles, the exact float32 products of the TPU kernel);
any other input the CUDA-core kernel (``flash_attention_fwd``).

``launch`` takes tensors that ``ops.flash_attention`` has already
checked, allocates the output, launches on the current stream of the
tensors' device and raises on a launch error.  It does not synchronise.
``VARIANT_LAUNCHES`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANT_LAUNCHES = {"tensor_core": 0, "fp32_tma": 0, "cuda_core": 0}


def variant(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """The kernel that runs for inputs of ``dtype`` and head dim
    ``head_dim`` when every input starts on a 16-byte boundary
    (``aligned``) or not: "tensor_core" for aligned bf16 with ``head_dim
    % 8 == 0`` and "fp32_tma" for aligned float32 with ``head_dim % 4 ==
    0`` (strides between heads of a multiple of 16 bytes, which TMA can
    describe), else "cuda_core"."""
    if aligned and dtype == torch.bfloat16 and head_dim % 8 == 0:
        return "tensor_core"
    if aligned and dtype == torch.float32 and head_dim % 4 == 0:
        return "fp32_tma"
    return "cuda_core"


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_tc_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_tc_fwd.restype = ctypes.c_int
        lib.flash_attention_f32_fwd.argtypes = \
            lib.flash_attention_tc_fwd.argtypes
        lib.flash_attention_f32_fwd.restype = ctypes.c_int
        for fn in (lib.flash_attention_tc_attributes,
                   lib.flash_attention_f32_attributes):
            fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash_attention {what} failed: "
                           + lib.flash_attention_error_string(rc).decode())


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Kh, D); one dtype (float32 or
    bfloat16), contiguous, on one CUDA device -> (B, S, H, D)."""
    lib = _lib()
    b, s, h, d = q.shape
    kh = k.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    which = variant(q.dtype, d, aligned)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which != "cuda_core":
            fwd = (lib.flash_attention_tc_fwd if which == "tensor_core"
                   else lib.flash_attention_f32_fwd)
            rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, h, kh, d, 1.0 / math.sqrt(d),
                     int(causal), int(window), stream)
        else:
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, s, h, kh, d, 1.0 / math.sqrt(d),
                int(causal), int(window), stream)
    _check(lib, rc, f"{which} kernel launch")
    VARIANT_LAUNCHES[which] += 1
    return out


def tensor_core_attributes(head_dim: int) -> dict:
    """Registers a thread at launch, local memory in bytes (spills) and
    dynamic shared memory in bytes of the tensor-core kernel that
    ``head_dim`` runs (builds the library if needed; needs a card)."""
    return _attributes(_lib().flash_attention_tc_attributes, head_dim)


def fp32_attributes(head_dim: int) -> dict:
    """The same of the TMA-fed float32 kernel that ``head_dim`` runs."""
    return _attributes(_lib().flash_attention_f32_attributes, head_dim)


def _attributes(fn, head_dim: int) -> dict:
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(_lib(), fn(head_dim, ctypes.byref(regs), ctypes.byref(local),
                      ctypes.byref(smem)), "attribute query")
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}
