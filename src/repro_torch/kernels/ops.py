"""Public wrappers of the port's hand-written kernels.

Each wrapper checks its inputs and raises on anything the kernel does not
take.  For tensors on the CPU it computes the plain version in ``ref``;
for CUDA tensors it launches the kernel or raises — it never falls back.
``LAUNCHES`` counts kernel launches per wrapper (and nothing else), so a
run can show that its main path went through the kernels.

K3, K4 and K5 are forward-only, as in the JAX package (its kernels have
no VJP): their wrappers raise, on the CPU as on the card, when a
gradient would be taken through them (``_forward_only``).  Their inputs
may also lie on the ``meta`` device (all of them: the dry run,
``launch/dryrun.py``): then the wrapper returns an empty output of the
kernel's shape and adds the kernel's own bytes and FLOPs
(``launch/roofline.py``'s ``*_cost``, the bounds ``chip_smoke.py`` holds
each kernel to) to the counters counting the step
(``roofline.count_kernel``), and launches nothing.
"""
from __future__ import annotations

import numpy as np
import torch

import torch.nn.functional as F

from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.launch import roofline

LAUNCHES = {"fill_aggregate": 0, "int8_scale": 0, "quantize_int8": 0,
            "dequantize_int8": 0, "flash_attention": 0, "ssd_scan": 0,
            "expert_gemm": 0}
# the routes of the language models' attention, SSD scan and expert FFN:
# the kernel (its plain version on the CPU), the plain einsum path, or
# attention over query blocks (``models/attention.py::_attend_chunked``;
# the SSD scan and the expert FFN take the einsum path there).  Nothing
# picks ``"chunked"`` on its own: it is never a default nor a fallback
BACKENDS = ("kernel", "torch", "chunked")


def check_backend(backend: str) -> None:
    """Raise on a route name the port does not take (the JAX package's
    ``"xla"``/``"pallas"`` are ``"torch"``/``"kernel"`` here)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port takes "
                         f"{list(BACKENDS)}")


def _common_device(name: str, *tensors: torch.Tensor,
                   meta: bool = False) -> torch.device:
    """The one device of ``tensors``: the CPU or a card, or (``meta``,
    the model kernels' wrappers) the meta device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on mixed devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in (("cpu", "cuda", "meta") if meta else ("cpu", "cuda")):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a call: the CUDA kernel's output
    carries no history, so a loss through it would silently get no
    gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel is forward-only, as in the JAX package, "
            "and takes no gradient; train on backend=\"torch\" or "
            "\"chunked\"")


def fill_aggregate(clients: torch.Tensor, masks: torch.Tensor,
                   weights: torch.Tensor, prev: torch.Tensor,
                   donate_prev: bool = False) -> torch.Tensor:
    """clients, masks: (m, P); weights: (m,); prev: (P,), float32 and
    contiguous -> (P,) float32 (paper Algorithm 3 on a flat vector).

    ``donate_prev`` writes the result into ``prev``'s storage and
    returns ``prev`` (the JAX package's ``input_output_aliases={3: 0}``):
    on the card the in-place kernel, which allocates nothing; on the CPU
    the plain version, copied over ``prev``.  Pass it only where the
    caller no longer needs ``prev``."""
    dev = _common_device("fill_aggregate", clients, masks, weights, prev)
    for nm, t in (("clients", clients), ("masks", masks),
                  ("weights", weights), ("prev", prev)):
        if t.dtype != torch.float32:
            raise TypeError(f"fill_aggregate: {nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fill_aggregate: {nm} must be contiguous")
    if clients.dim() != 2 or prev.dim() != 1 or weights.dim() != 1:
        raise ValueError("fill_aggregate: need clients (m, P), weights (m,), "
                         f"prev (P,); got {tuple(clients.shape)}, "
                         f"{tuple(weights.shape)}, {tuple(prev.shape)}")
    m, p = clients.shape
    if (masks.shape != clients.shape or weights.shape[0] != m
            or prev.shape[0] != p):
        raise ValueError("fill_aggregate: shape mismatch: clients "
                         f"{tuple(clients.shape)}, masks {tuple(masks.shape)}, "
                         f"weights {tuple(weights.shape)}, prev {tuple(prev.shape)}")
    if m < 1 or p < 1:
        raise ValueError(f"fill_aggregate: empty input (m={m}, P={p})")
    if dev.type == "cpu":
        if donate_prev:
            return ref.fill_aggregate_(clients, masks, weights, prev)
        return ref.fill_aggregate(clients, masks, weights, prev)
    from repro_torch.kernels import fill_aggregate as _fa
    out = _fa.launch(clients, masks, weights, prev,
                     out=prev if donate_prev else None)
    LAUNCHES["fill_aggregate"] += 1
    return out


def _check_int8_args(name: str, src: torch.Tensor, src_dtype: torch.dtype,
                     scale: torch.Tensor) -> torch.device:
    dev = _common_device(name, src, scale)
    if src.dtype != src_dtype:
        raise TypeError(f"{name}: input must be {src_dtype}, got {src.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name}: scale must be float32, got {scale.dtype}")
    if src.dim() != 1 or src.numel() < 1:
        raise ValueError(f"{name}: need a non-empty (P,) input, got shape "
                         f"{tuple(src.shape)}")
    if scale.numel() != 1 or scale.dim() > 1:
        raise ValueError(f"{name}: scale must be 0-d or (1,), got shape "
                         f"{tuple(scale.shape)}")
    if not src.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    return dev


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: (P,) float32, contiguous; scale: one float32 on x's device ->
    (P,) int8 on the symmetric grid (kernel K2a, one-leaf table)."""
    dev = _check_int8_args("quantize_int8", x, torch.float32, scale)
    if dev.type == "cpu":
        return ref.quantize_int8(x, scale)
    out = _q.quantize(x, scale)
    LAUNCHES["quantize_int8"] += 1
    return out


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (P,) int8, contiguous; scale: one float32 on q's device -> (P,)
    float32 ``q * scale`` (kernel K2b, one-leaf table)."""
    dev = _check_int8_args("dequantize_int8", q, torch.int8, scale)
    if dev.type == "cpu":
        return ref.dequantize_int8(q, scale)
    out = _q.dequantize(q, scale)
    LAUNCHES["dequantize_int8"] += 1
    return out


def _check_scales(name: str, scales: torch.Tensor, n: int) -> None:
    if scales.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32, got {scales.dtype}")
    if scales.shape != (n,) or not scales.is_contiguous():
        raise ValueError(f"{name}: scales must be a contiguous ({n},), got "
                         f"shape {tuple(scales.shape)}")


def _check_leaves(name: str, leaves) -> torch.device:
    if not isinstance(leaves, (list, tuple)) or not leaves:
        raise ValueError(f"{name}: need a non-empty list of tensors")
    dev = _common_device(name, *leaves)
    for i, x in enumerate(leaves):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: leaf {i} must be float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous() or x.numel() < 1:
            raise ValueError(f"{name}: leaf {i} must be contiguous and "
                             f"non-empty, got shape {tuple(x.shape)}")
    return dev


def _leaf_pointers(leaves) -> np.ndarray:
    return np.fromiter((x.data_ptr() for x in leaves), np.uint64,
                       len(leaves))


def _launch_chunks(name: str, layout, tables, scales: torch.Tensor) -> None:
    for i, table in enumerate(tables):
        _q.launch(name, layout, i, table, scales)
        LAUNCHES[name] += 1


def int8_scales(leaves) -> torch.Tensor:
    """leaves: a non-empty sequence of float32, contiguous, non-empty
    tensors of any shape on one device -> (N,) float32, each leaf's
    ``max|x| / 127`` as ``comm.quantize.leaf_scale`` computes it (the
    scale pass: one launch per ``CAPACITY`` leaves on the card)."""
    dev = _check_leaves("int8_scales", leaves)
    layout = _q.layout_of(leaves)
    if dev.type == "cpu":
        return ref.int8_scales(leaves)
    with torch.cuda.device(dev):
        scales = torch.empty(len(leaves), dtype=torch.float32, device=dev)
    src = _leaf_pointers(leaves)
    _launch_chunks("int8_scale", layout, layout.tables(src, src), scales)
    return scales


def quantize_int8_leaves(leaves, scales=None):
    """leaves: as ``int8_scales`` -> (q_flat, scales, layout): each leaf
    on the symmetric grid of its own scale, in its segment
    (``layout.offsets``) of one flat int8 buffer; scales (N,) float32,
    ``int8_scales(leaves)`` unless ``scales`` gives them.  On the card
    one launch of the scale pass (when it computes the scales) and one
    of K2a per ``CAPACITY`` leaves."""
    name = "quantize_int8_leaves"
    dev = _check_leaves(name, leaves)
    if scales is not None:
        _common_device(name, leaves[0], scales)
        _check_scales(name, scales, len(leaves))
    layout = _q.layout_of(leaves)
    if dev.type == "cpu":
        return (*ref.quantize_int8_leaves(leaves, layout, scales), layout)
    with torch.cuda.device(dev):
        q_flat = _q.aligned_empty(layout.total, torch.int8, dev)
        computed = scales is None
        if computed:
            scales = torch.empty(len(leaves), dtype=torch.float32,
                                 device=dev)
    tables = layout.tables(_leaf_pointers(leaves),
                           layout.offsets_u64 + np.uint64(q_flat.data_ptr()))
    if computed:
        _launch_chunks("int8_scale", layout, tables, scales)
    _launch_chunks("quantize_int8", layout, tables, scales)
    return q_flat, scales, layout


def dequantize_int8_leaves(q_flat: torch.Tensor, scales: torch.Tensor,
                           layout) -> list:
    """The inverse of ``quantize_int8_leaves``: q_flat (layout.total,)
    int8 starting on a 4-byte boundary, scales (N,) float32, on one
    device -> the N leaves ``q * scale`` as float32 views, with their
    shapes, of one fresh flat buffer (disjoint: writing one changes no
    other).  On the card one launch of K2b per ``CAPACITY`` leaves."""
    name = "dequantize_int8_leaves"
    if not isinstance(layout, _q.Int8Layout):
        raise TypeError(f"{name}: layout must come from quantize_int8_leaves")
    dev = _common_device(name, q_flat, scales)
    if q_flat.dtype != torch.int8:
        raise TypeError(f"{name}: q_flat must be int8, got {q_flat.dtype}")
    if (q_flat.shape != (layout.total,) or not q_flat.is_contiguous()
            or q_flat.data_ptr() % 4):
        raise ValueError(f"{name}: q_flat must be a contiguous "
                         f"({layout.total},) starting on a 4-byte "
                         f"boundary, got shape {tuple(q_flat.shape)}")
    _check_scales(name, scales, len(layout))
    if dev.type == "cpu":
        return ref.dequantize_int8_leaves(q_flat, scales, layout)
    with torch.cuda.device(dev):
        out = _q.aligned_empty(layout.total, torch.float32, dev)
    src = layout.offsets_u64 + np.uint64(q_flat.data_ptr())
    dst = 4 * layout.offsets_u64 + np.uint64(out.data_ptr())
    _launch_chunks("dequantize_int8", layout, layout.tables(src, dst), scales)
    return layout.views(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Kh, D), one dtype (float32 or
    bfloat16), contiguous -> (B, S, H, D) in q's dtype (kernel K3).

    Takes ``H % Kh == 0`` and D <= 256, as the TPU kernel, and any S:
    the TPU kernel asserts S up to 128 or a multiple of 128, where every
    CUDA kernel masks a ragged last tile (zamba2's prompts of 1000
    tokens).  Forward-only."""
    _forward_only("flash_attention", q, k, v)
    dev = _common_device("flash_attention", q, k, v, meta=True)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {nm} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {nm} must be (B, S, heads, "
                             f"D), got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {nm} must be contiguous")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if (v.shape != k.shape or k.shape[0] != b or k.shape[1] != s
            or k.shape[3] != d):
        raise ValueError("flash_attention: shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if min(b, s, h, kh, d) < 1 or h % kh:
        raise ValueError(f"flash_attention: need H % Kh == 0 and no empty "
                         f"axis, got H={h}, Kh={kh}, shape {tuple(q.shape)}")
    if d > 256:
        raise ValueError(f"flash_attention: head dim {d} > 256")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if dev.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if dev.type == "meta":
        roofline.count_kernel("flash_attention",
                              *roofline.flash_attention_cost(
                                  b, s, h, kh, d, q.element_size(), causal,
                                  window))
        return torch.empty_like(q)
    from repro_torch.kernels import flash_attention as _fl
    out = _fl.launch(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def ssd_scan(xs: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, initial_state=None):
    """xs: (B, NC, Q, H, P); a: (B, NC, Q, H); bm, cm: (B, NC, Q, N); all
    float32, contiguous -> (y (B, NC, Q, H, P), final state (B, H, P,
    N)), float32 (kernel K4: one call launches its stage kernels,
    ``kernels/ssd_scan.py``).  The state starts at zero: a non-None
    ``initial_state`` raises, as the TPU kernel asserts.  Q and N are at
    most 128.  Forward-only."""
    _forward_only("ssd_scan", xs, a, bm, cm)
    if initial_state is not None:
        raise ValueError("ssd_scan: the kernel starts from a zero state; "
                         "initial_state must be None")
    dev = _common_device("ssd_scan", xs, a, bm, cm, meta=True)
    for nm, t in (("xs", xs), ("a", a), ("bm", bm), ("cm", cm)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {nm} must be contiguous")
    if xs.dim() != 5:
        raise ValueError("ssd_scan: xs must be (B, NC, Q, H, P), got shape "
                         f"{tuple(xs.shape)}")
    b, nc, q, h, p = xs.shape
    n = bm.shape[-1] if bm.dim() == 4 else -1
    if (a.shape != (b, nc, q, h) or bm.shape != (b, nc, q, n)
            or cm.shape != bm.shape):
        raise ValueError(f"ssd_scan: shape mismatch: xs {tuple(xs.shape)}, "
                         f"a {tuple(a.shape)}, bm {tuple(bm.shape)}, cm "
                         f"{tuple(cm.shape)}")
    if min(b, nc, q, h, p, n) < 1:
        raise ValueError(f"ssd_scan: empty axis in xs {tuple(xs.shape)}, "
                         f"bm {tuple(bm.shape)}")
    from repro_torch.kernels import ssd_scan as _ssd
    if q > _ssd.MAX_CHUNK or n > _ssd.MAX_STATE:
        raise ValueError(f"ssd_scan: chunk length {q} or state size {n} "
                         f"above the kernel's {_ssd.MAX_CHUNK}")
    if dev.type == "cpu":
        return ref.ssd_scan(xs, a, bm, cm)
    if dev.type == "meta":
        roofline.count_kernel("ssd_scan",
                              *roofline.ssd_scan_cost(b, nc, q, h, p, n))
        return torch.empty_like(xs), xs.new_empty((b, h, p, n))
    y, state = _ssd.launch(xs, a, bm, cm)
    LAUNCHES["ssd_scan"] += 1
    return y, state


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F); one dtype (float32 or bfloat16),
    contiguous -> (E, C, F) in x's dtype: ``x[e] @ w[e]`` with float32
    sums, rounded once (kernel K5).  Any C, D and F >= 1.
    Forward-only."""
    _forward_only("expert_gemm", x, w)
    dev = _common_device("expert_gemm", x, w, meta=True)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("expert_gemm: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"expert_gemm: w is {w.dtype}, x is {x.dtype}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("expert_gemm: need x (E, C, D) and w (E, D, F), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    e, c, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"expert_gemm: shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if min(e, c, d, w.shape[2]) < 1:
        raise ValueError(f"expert_gemm: empty axis in x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    for nm, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"expert_gemm: {nm} must be contiguous")
    if dev.type == "cpu":
        return ref.expert_gemm(x, w)
    if dev.type == "meta":
        f = w.shape[2]
        roofline.count_kernel("expert_gemm", *roofline.expert_gemm_cost(
            e, c, d, f, x.element_size()))
        return x.new_empty((e, c, f))
    from repro_torch.kernels import expert_gemm as _eg
    out = _eg.launch(x, w)
    LAUNCHES["expert_gemm"] += 1
    return out


def expert_ffn(experts, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert FFN on dispatched slots through K5: x (E, C, d) ->
    (E, C, d), ``(silu(x wg) * (x wi)) wo`` per expert, each product
    rounded to x's dtype."""
    h = expert_gemm(x, experts["wi"])
    g = expert_gemm(x, experts["wg"])
    return expert_gemm(F.silu(g) * h, experts["wo"])
