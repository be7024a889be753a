"""Binding of the grouped expert GEMM CUDA kernels (``csrc/expert_gemm.cu``).

Four kernels compute the same function.  ``variant`` picks one from the
dtype, D, F and the pointers' alignment alone, never after an error:
bf16 with D and F multiples of 8 and x, w and out 16-byte aligned (the
strides and bases TMA can describe) runs the tensor-core kernel
(``expert_gemm_tc_fwd``: wgmma on a TMA-fed shared-memory ring); any
other bf16 input the mma.sync kernel; float32 with D and F multiples of
4 and aligned pointers the TMA-fed float32 kernel
(``expert_gemm_f32_fwd``: FP32 FMAs on register tiles read from a TMA
ring, the exact float32 products of the TPU kernel); any other float32
input the CUDA-core kernel (``expert_gemm_fwd``).

``launch`` takes tensors that ``ops.expert_gemm`` has already checked,
allocates the output, launches on the current stream of the tensors'
device and raises on a launch error.  It does not synchronise.
``VARIANT_LAUNCHES`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANT_LAUNCHES = {"tensor_core": 0, "mma_sync": 0, "fp32_tma": 0,
                    "cuda_core": 0}


def variant(dtype: torch.dtype, d: int, f: int, aligned: bool = True) -> str:
    """The kernel that runs for inputs of ``dtype`` with contraction
    depth ``d`` and output width ``f`` when x, w and out start on 16-byte
    boundaries (``aligned``) or not: rows of a multiple of 16 bytes (what
    TMA can describe: ``d`` and ``f`` multiples of 8 in bf16, of 4 in
    float32) and aligned pointers run "tensor_core" (bf16) or "fp32_tma"
    (float32); any other input "mma_sync" (bf16) or "cuda_core"
    (float32)."""
    if dtype == torch.bfloat16:
        if d % 8 == 0 and f % 8 == 0 and aligned:
            return "tensor_core"
        return "mma_sync"
    if d % 4 == 0 and f % 4 == 0 and aligned:
        return "fp32_tma"
    return "cuda_core"


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("expert_gemm")
        lib.expert_gemm_fwd.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.expert_gemm_fwd.restype = ctypes.c_int
        lib.expert_gemm_tc_fwd.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
        lib.expert_gemm_tc_fwd.restype = ctypes.c_int
        lib.expert_gemm_f32_fwd.argtypes = lib.expert_gemm_tc_fwd.argtypes
        lib.expert_gemm_f32_fwd.restype = ctypes.c_int
        for fn in (lib.expert_gemm_tc_attributes,
                   lib.expert_gemm_f32_attributes):
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
            fn.restype = ctypes.c_int
        lib.expert_gemm_error_string.argtypes = [ctypes.c_int]
        lib.expert_gemm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"expert_gemm {what} failed: "
                           + lib.expert_gemm_error_string(rc).decode())


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F); one dtype (float32 or bfloat16),
    contiguous, on one CUDA device -> (E, C, F) in x's dtype."""
    lib = _lib()
    e, c, d = x.shape
    f = w.shape[2]
    with torch.cuda.device(x.device):
        out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
        which = variant(x.dtype, d, f, aligned)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if which in ("tensor_core", "fp32_tma"):
            fwd = (lib.expert_gemm_tc_fwd if which == "tensor_core"
                   else lib.expert_gemm_f32_fwd)
            rc = fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                     stream)
        else:
            rc = lib.expert_gemm_fwd(x.data_ptr(), w.data_ptr(),
                                     out.data_ptr(), _DTYPES[x.dtype], e, c,
                                     d, f, stream)
    _check(lib, rc, f"{which} kernel launch")
    VARIANT_LAUNCHES[which] += 1
    return out


def tensor_core_attributes() -> dict:
    """Registers a thread at launch, local memory in bytes (spills) and
    dynamic shared memory in bytes of the tensor-core kernel (builds the
    library if needed; needs a card)."""
    return _attributes(_lib().expert_gemm_tc_attributes)


def fp32_attributes() -> dict:
    """The same of the TMA-fed float32 kernel."""
    return _attributes(_lib().expert_gemm_f32_attributes)


def _attributes(fn) -> dict:
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(_lib(), fn(ctypes.byref(regs), ctypes.byref(local),
                      ctypes.byref(smem)), "attribute query")
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}
