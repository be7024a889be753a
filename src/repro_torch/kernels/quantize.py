"""Binding of the int8 kernels (``csrc/quantize_int8.cu``) and the layout
of a tree of leaves in one flat buffer.

``Int8Layout`` places each leaf's segment of the flat int8 buffer (and of
the flat float32 output) so that the source's float4s, the int8 buffer's
32-bit words and the float32 buffer's float4s all start at the same
element, the leaf's ``head``, and both flat buffers reach a 128-byte
line there: the segment's offset is congruent, mod 128, to minus the
head, and so, mod 4, to the source's misalignment (its address mod 16,
over 4).  The layout is pure Python and is built for CPU tensors too:
the plain versions in ``ref`` fill the same segments.  ``layout_of``
caches it by the leaves' shapes and misalignments.

The launch functions take tensors that ``ops`` has already checked,
launch on the current stream of the tensors' device and raise on a
launch error.  They do not synchronise; the scales stay on the device.
A launch carries a leaf table (source and destination pointers, element
counts, first tiles and heads) by value: ``CAPACITY`` leaves per tree
launch, one for the per-vector entry points.
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

TILE = 4096         # elements per block: 256 threads x 16
CAPACITY = 256      # leaves per tree launch
LINE = 128          # bytes of a cache line, where a warp's accesses start

_LIB = None
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}
_LAYOUTS: Dict[tuple, "Int8Layout"] = {}
_MAX_LAYOUTS = 64


def tiles_of(n: int, head: int) -> int:
    """Blocks of one leaf of ``n`` elements whose vectors start at
    element ``head``: the head rides on the first tile."""
    return max(1, math.ceil(max(n - head, 0) / TILE))


def _table_fields(cap: int) -> Dict[str, Tuple[int, np.dtype]]:
    """Byte offset and type of each column of ``LeafTable<cap>``."""
    return {"src": (0, np.uint64), "dst": (8 * cap, np.uint64),
            "n": (16 * cap, np.int64), "first_tile": (24 * cap, np.int32),
            "head": (28 * cap, np.int32), "count": (32 * cap, np.int32)}


def _table_bytes(cap: int) -> int:
    return -(-(32 * cap + 4) // 8) * 8


def _column(table: np.ndarray, cap: int, name: str, k: int) -> np.ndarray:
    off, dt = _table_fields(cap)[name]
    return table[off: off + k * np.dtype(dt).itemsize].view(dt)


def _table(cap: int, numels, heads, first_tiles) -> np.ndarray:
    """A leaf table with its counts, heads and first tiles filled and
    its pointers zero, as raw bytes."""
    k = len(numels)
    table = np.zeros(_table_bytes(cap), np.uint8)
    _column(table, cap, "n", k)[:] = numels
    _column(table, cap, "first_tile", k)[:] = first_tiles
    _column(table, cap, "head", k)[:] = heads
    _column(table, cap, "count", 1)[0] = k
    return table


class Int8Layout:
    """Where each leaf of a tree lies in the flat int8 / float32 buffers.

    ``offsets[i]`` is leaf i's first element in the flat buffers, which
    start on a 128-byte line; the segments are disjoint, in leaf order,
    with gaps of at most 127 elements that hold no data.  ``heads[i]``
    (< 4) is the first element of leaf i that lies on a 16-byte boundary
    in the source, and ``offsets[i] + heads[i]`` is a multiple of 128:
    a line of both flat buffers (whole lines for every warp's stores).  ``chunks`` cuts the
    leaves into runs of at most ``CAPACITY``: (start, stop, tiles).
    """

    def __init__(self, shapes: Sequence[torch.Size], misalign: Sequence[int]):
        self.shapes = [torch.Size(s) for s in shapes]
        self.numels = np.array([math.prod(s) for s in self.shapes], np.int64)
        # a float32 source 4m bytes past a 16-byte boundary is aligned
        # from element (4 - m) % 4 on
        self.heads = (-np.asarray(misalign, np.int64)) % 4
        offsets, end = [], 0
        for n, h in zip(self.numels.tolist(), self.heads.tolist()):
            off = end + (-(end + h)) % LINE
            offsets.append(off)
            end = off + n
        self.offsets = np.array(offsets, np.int64)
        self.offsets_u64 = self.offsets.astype(np.uint64)
        self.total = end
        self.strides = [_contiguous_strides(s) for s in self.shapes]
        self.chunks, self.first_tiles = [], []
        for start in range(0, len(self.shapes), CAPACITY):
            stop = min(start + CAPACITY, len(self.shapes))
            tiles = [tiles_of(n, h) for n, h in
                     zip(self.numels[start:stop].tolist(),
                         self.heads[start:stop].tolist())]
            self.first_tiles.append(np.cumsum([0] + tiles[:-1]))
            self.chunks.append((start, stop, sum(tiles)))
        self._tables = [
            _table(CAPACITY, self.numels[a:b], self.heads[a:b], ft)
            for (a, b, _), ft in zip(self.chunks, self.first_tiles)]

    def __len__(self) -> int:
        return len(self.shapes)

    def tables(self, src: np.ndarray, dst: np.ndarray) -> List[np.ndarray]:
        """One leaf table per chunk, with per-leaf source and
        destination addresses ``src`` and ``dst`` (uint64)."""
        out = []
        for (a, b, _), template in zip(self.chunks, self._tables):
            table = template.copy()
            _column(table, CAPACITY, "src", b - a)[:] = src[a:b]
            _column(table, CAPACITY, "dst", b - a)[:] = dst[a:b]
            out.append(table)
        return out

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's segment of ``flat`` with the leaf's shape."""
        base = flat.storage_offset()
        return [flat.as_strided(shape, stride, base + off)
                for shape, stride, off in
                zip(self.shapes, self.strides, self.offsets.tolist())]


def _contiguous_strides(shape: torch.Size) -> Tuple[int, ...]:
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def layout_of(leaves: Sequence[torch.Tensor]) -> Int8Layout:
    """The layout of ``leaves`` (float32, contiguous, any 4-byte
    boundary), cached by their shapes and misalignments."""
    ptrs = [x.data_ptr() for x in leaves]
    if any(p % 4 for p in ptrs):
        raise ValueError("int8 leaves: a float32 leaf does not start on a "
                         "4-byte boundary")
    misalign = tuple((p % 16) // 4 for p in ptrs)
    key = (tuple(tuple(x.shape) for x in leaves), misalign)
    layout = _LAYOUTS.get(key)
    if layout is None:
        if len(_LAYOUTS) >= _MAX_LAYOUTS:
            _LAYOUTS.clear()
        layout = _LAYOUTS[key] = Int8Layout([x.shape for x in leaves],
                                            misalign)
    return layout


def aligned_empty(numel: int, dtype: torch.dtype, device, first: int = 0
                  ) -> torch.Tensor:
    """A fresh (numel,) tensor whose element ``first`` starts a 128-byte
    line (a view into a buffer up to 127 bytes longer)."""
    per_line = LINE // dtype.itemsize
    buf = torch.empty(numel + per_line - 1, dtype=dtype, device=device)
    shift = (-(buf.data_ptr() // dtype.itemsize + first)) % per_line
    return buf[shift: shift + numel]


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("quantize_int8")
        lib.int8_table_bytes.argtypes = [ctypes.c_int]
        lib.int8_table_bytes.restype = ctypes.c_int64
        for cap in (1, CAPACITY):
            if lib.int8_table_bytes(cap) != _table_bytes(cap):
                raise RuntimeError("quantize_int8: the leaf table's layout "
                                   "differs between the source and Python")
        if lib.int8_tile() != TILE or lib.int8_capacity() != CAPACITY:
            raise RuntimeError("quantize_int8: tile or capacity differs "
                               "between the source and Python")
        # (table, workspace, scales, tiles, stream)
        lib.int8_scale_f32.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        # (table, capacity, scales, tiles, stream)
        for fn in (lib.quantize_int8_f32, lib.dequantize_int8_f32):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.int8_scale_f32, lib.quantize_int8_f32,
                   lib.dequantize_int8_f32):
            fn.restype = ctypes.c_int
        lib.quantize_int8_error_string.argtypes = [ctypes.c_int]
        lib.quantize_int8_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _lib().quantize_int8_error_string(rc).decode())


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _workspace(device: torch.device) -> torch.Tensor:
    """The scale pass's per-leaf words on this device and stream: zeroed
    once here, and left zero by every launch."""
    key = (device.index, _stream(device))
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = _WORKSPACE[key] = torch.zeros(2 * CAPACITY, dtype=torch.int32,
                                           device=device)
    return ws


def launch(name: str, layout: Int8Layout, chunk: int, table: np.ndarray,
           scales: torch.Tensor) -> None:
    """One launch of kernel ``name`` (``"int8_scale"``, writing the
    chunk's scales, or ``"quantize_int8"`` / ``"dequantize_int8"``,
    reading them) over chunk ``chunk`` of ``layout``; ``ops`` counts it."""
    a, _, tiles = layout.chunks[chunk]
    dev = scales.device
    with torch.cuda.device(dev):
        extra = (_workspace(dev).data_ptr() if name == "int8_scale"
                 else CAPACITY)
        _check(getattr(_lib(), f"{name}_f32")(
            table.ctypes.data, extra, scales.data_ptr() + 4 * a, tiles,
            _stream(dev)), name)


# -- per-vector launches (a one-entry table) --------------------------------

# LeafTable<1>: src, dst, n, first_tile, head, count, padding
_ONE = struct.Struct("<QQqiii4x")


def _one(src: torch.Tensor, dst: torch.Tensor, head: int) -> bytes:
    return _ONE.pack(src.data_ptr(), dst.data_ptr(), src.numel(), 0, head, 1)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: (P,) float32; scale: one float32, both contiguous on one CUDA
    device -> (P,) int8."""
    if x.data_ptr() % 4:
        raise ValueError("quantize_int8: x does not start on a 4-byte "
                         "boundary")
    head = (-(x.data_ptr() // 4)) % 4
    with torch.cuda.device(x.device):
        q = aligned_empty(x.numel(), torch.int8, x.device, head)
        _check(_lib().quantize_int8_f32(
            _one(x, q, head), 1, scale.data_ptr(),
            tiles_of(x.numel(), head), _stream(x.device)), "quantize_int8")
    return q


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (P,) int8; scale: one float32, both contiguous on one CUDA
    device -> (P,) float32."""
    head = (-q.data_ptr()) % 4
    with torch.cuda.device(q.device):
        out = aligned_empty(q.numel(), torch.float32, q.device, head)
        _check(_lib().dequantize_int8_f32(
            _one(q, out, head), 1, scale.data_ptr(),
            tiles_of(q.numel(), head), _stream(q.device)),
            "dequantize_int8")
    return out
