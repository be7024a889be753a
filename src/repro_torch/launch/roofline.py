"""Roofline terms of a step on the NVIDIA H100, and the counts they read.

Constants of one H100 SXM (NVIDIA H100 Tensor Core GPU data sheet):
989 TFLOP/s of dense bf16 on the tensor cores, 67 TFLOP/s of float32
without them, 3.35 TB/s of HBM3 bandwidth and 80 GB of it.  Links: NVLink
4 gives each GPU 900 GB/s, both directions together (450 GB/s each way),
to the other seven GPUs of its node (NVIDIA DGX H100 user guide: eight
GPUs joined by NVSwitch); a mesh axis whose devices span more than one
node crosses the node's network, one ConnectX-7 NDR port of 400 Gb/s
(50 GB/s each way) per GPU (same guide).

Three counts feed the terms:

* the kernels' own work (``flash_attention_cost``, ``ssd_scan_cost``,
  ``expert_gemm_cost``): what ``chip_smoke.py``'s kernel table bounds
  each kernel by, and what the kernel wrappers' meta branches add to a
  ``StepCounter``;
* ``StepCounter``: one call on meta tensors, counted op by op -- FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``, plus the kernels'),
  bytes read and written by every op that is not a view or an alias, and
  the peak of live storage bytes (the whole step's, and a per-device
  share of it);
* ``collective_bytes``: the bytes each device sends through every
  collective that the sharding specs (``launch/sharding.py``) imply,
  reckoned from the config, since there is no compiled program to read.

Functions and classes only: importing this module touches no device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOPS = 989e12          # dense bf16 tensor cores, H100 SXM data sheet
FP32_FLOPS = 67e12           # float32 without tensor cores, same sheet
HBM_BYTES_PER_S = 3.35e12    # HBM3, same sheet
HBM_BYTES = 80e9             # the card's memory, same sheet
NVLINK_BYTES_PER_S = 450e9   # NVLink 4: 900 GB/s per GPU, both directions
NETWORK_BYTES_PER_S = 50e9   # one ConnectX-7 NDR 400 Gb/s port per GPU
GPUS_PER_NODE = 8            # NVSwitch node (DGX H100)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


# ---------------------------------------------------------------------------
# Bounds of one kernel call
# ---------------------------------------------------------------------------

def bound(nbytes: float, flops: float, peak: float) -> dict:
    """The least time for moving ``nbytes`` and doing ``flops`` at
    ``peak``: the larger of the two, and which one it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def flash_pairs(s: int, window: int, causal: bool = True) -> int:
    """Unmasked (query, key) pairs of one head of length ``s``: causal
    (within ``window``), or every pair (bidirectional, whose window is
    not counted)."""
    if not causal:
        return s * s
    if not window:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_attention_cost(b: int, s: int, h: int, kh: int, d: int,
                         itemsize: int, causal: bool = True,
                         window: int = 0) -> Tuple[int, int]:
    """(bytes, FLOPs) of one K3 call on (B, S, H, D) queries and (B, S,
    Kh, D) keys and values: q, k, v read and the output written once; 4 D
    FLOPs (q.k and p.v) per unmasked (query, key) pair and head."""
    nbytes = itemsize * (2 * b * s * h * d + 2 * b * s * kh * d)
    return nbytes, 4 * d * b * h * flash_pairs(s, window, causal)


def ssd_scan_cost(b: int, nc: int, q: int, h: int, p: int,
                  n: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one K4 call on (B, NC, Q, H, P) inputs and a
    state of N, float32: inputs read and outputs written once; C Bᵀ over
    the causal triangle once per (batch, chunk), and per (batch, head,
    chunk) the triangle of ((C Bᵀ) ∘ L) X, C Sᵀ and the state update."""
    nbytes = 4 * (2 * b * nc * q * h * p + b * nc * q * h
                  + 2 * b * nc * q * n + b * h * p * n)
    tri = q * (q + 1) // 2
    flops = (b * nc * 2 * tri * n
             + b * nc * h * (2 * tri * p + 2 * q * n * p + 2 * q * p * n
                             + 2 * p * n))
    return nbytes, flops


def expert_gemm_cost(e: int, c: int, d: int, f: int,
                     itemsize: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one K5 call, (E, C, D) @ (E, D, F): x and w read
    and the output written once; 2 E C D F FLOPs."""
    return itemsize * (e * c * d + e * d * f + e * c * f), 2 * e * c * d * f


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_collective_bytes: float, links: int = 1,
                   link_bytes_per_s: float = NVLINK_BYTES_PER_S
                   ) -> Dict[str, float]:
    """Three roofline terms in seconds (per step, per device): FLOPs at
    the dense bf16 peak (every FLOP at the card's fastest rate, so a
    lower bound in any dtype), bytes at the HBM rate, collective bytes
    over ``links`` links of ``link_bytes_per_s`` each."""
    compute = per_device_flops / BF16_FLOPS
    memory = per_device_bytes / HBM_BYTES_PER_S
    collective = per_device_collective_bytes / (link_bytes_per_s * links)
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant}


# ---------------------------------------------------------------------------
# Counting one call on meta tensors
# ---------------------------------------------------------------------------

# ops that move no bytes: allocations, aliases that the schema does not
# mark as views, and reads of a host scalar
_FREE_OPS = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::_unsafe_view",
    "aten::lift_fresh", "aten::_local_scalar_dense", "aten::resize_",
    "aten::set_",
})
# in-place ops that overwrite their first argument without reading it
_OVERWRITE_OPS = frozenset({"aten::copy_", "aten::fill_", "aten::zero_",
                            "aten::normal_", "aten::uniform_"})

_ACTIVE = []          # the StepCounters counting now, innermost last


def tensor_leaves(tree) -> list:
    """The tensors among the leaves of a tree of dicts, lists and
    tuples."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the memory a tensor covers: its elements, or fewer where
    strides repeat them (an expanded view reads each element once)."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((size - 1) * abs(stride)
                   for size, stride in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def count_kernel(name: str, nbytes: int, flops: int) -> None:
    """Add one launch of kernel ``name``, with its bytes and FLOPs, to
    every counter counting now (the kernel wrappers' meta branches call
    this; nothing else does)."""
    for c in _ACTIVE:
        c.launches[name] = c.launches.get(name, 0) + 1
        c.kernel_flops += flops
        c.bytes += nbytes


class _Traffic(TorchDispatchMode):
    """Bytes moved and live storage, op by op, into a ``StepCounter``."""

    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        name = func._schema.name
        if c.work and name not in _FREE_OPS and not _is_view(func):
            skip = set()
            if name in _OVERWRITE_OPS and args:
                skip.add(id(args[0]))
            if "out" in kwargs:
                skip.update(id(t) for t in tensor_leaves(kwargs["out"]))
            c.bytes += sum(_span_bytes(t)
                           for t in tensor_leaves((args, kwargs))
                           if id(t) not in skip)
            c.bytes += sum(_span_bytes(t) for t in tensor_leaves(out))
        for t in tensor_leaves(out):
            c._allocated(t)
        return out


class StepCounter:
    """Counts one call on meta tensors: ``with StepCounter() as c:
    out = step(*args)``, after ``c.hold(args)``.

    ``flops``: FlopCounterMode's count (matrix products, convolutions,
    attention) plus the kernels' own (``count_kernel``).  ``bytes``: the
    bytes read and written by every op that is not a view or an alias
    (its inputs read once, its outputs written once; an op that
    overwrites a tensor does not read it; allocations move nothing) and
    by every kernel.  ``peak_bytes``: the most storage live at once,
    the held arguments included.  ``peak_bytes_dev``: the same with each
    storage weighted by ``share(tensor)``, the part of it one device
    holds (1 by default).  ``launches``: kernel launches by name.

    Live storage is followed by weak references to each storage the
    step makes: a storage counts from the op that makes it until its
    last tensor is gone (a view keeps it, as autograd's saved tensors
    do).  Frees are found lazily: the running total, which can only
    overstate what is live, is swept for dead storages whenever it
    passes the peak, so the peak is exact.  ``work=False`` leaves FLOPs
    and bytes uncounted, for a cheaper run that only wants the peak."""

    def __init__(self, share: Optional[Callable[[torch.Tensor], float]]
                 = None, work: bool = True):
        self.share = share or (lambda t: 1.0)
        self.work = work
        self.kernel_flops = 0
        self.bytes = 0
        self.launches: Dict[str, int] = {}
        self._live: Dict[int, tuple] = {}
        self._total = self._total_dev = 0.0
        self.peak_bytes = self.peak_bytes_dev = 0.0
        self._flop_mode = None
        self._traffic = None

    @property
    def flops(self) -> int:
        base = self._flop_mode.get_total_flops() if self._flop_mode else 0
        return base + self.kernel_flops

    def hold(self, tree, share: Optional[float] = None) -> float:
        """Count the storages of the tensors in ``tree`` as live (the
        step's arguments), each weighted by ``share`` (else
        ``share(tensor)``); returns their bytes, each storage once."""
        before = self._total
        for t in tensor_leaves(tree):
            self._allocated(t, share)
        self._peak()
        return self._total - before

    def _allocated(self, t: torch.Tensor, share=None) -> None:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        old = self._live.get(ref.cdata)
        if old is not None and not old[0].expired():
            return
        n = st.nbytes()
        w = n * (self.share(t) if share is None else share)
        self._live[ref.cdata] = (ref, n, w)
        self._total += n
        self._total_dev += w
        if self._total > self.peak_bytes or \
                self._total_dev > self.peak_bytes_dev:
            self._peak()

    def _peak(self) -> None:
        for key in [k for k, v in self._live.items() if v[0].expired()]:
            _, n, w = self._live.pop(key)
            self._total -= n
            self._total_dev -= w
        self.peak_bytes = max(self.peak_bytes, self._total)
        self.peak_bytes_dev = max(self.peak_bytes_dev, self._total_dev)

    def __enter__(self) -> "StepCounter":
        if self.work:
            self._flop_mode = FlopCounterMode(display=False)
            self._flop_mode.__enter__()
        self._traffic = _Traffic(self)
        self._traffic.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self._traffic.__exit__(*exc)
        if self._flop_mode is not None:
            self._flop_mode.__exit__(*exc)
        self._peak()


# ---------------------------------------------------------------------------
# Collectives implied by the sharding specs
# ---------------------------------------------------------------------------

def _axis_link_bytes_per_s(mesh, axes) -> float:
    """The rate of one device's link along ``axes``: NVLink when the
    devices along them sit in one node (devices numbered row-major over
    the mesh, the last axis fastest, ``GPUS_PER_NODE`` a node), else the
    node's network."""
    names = mesh.axis_names
    sizes = [mesh.shape[a] for a in names]
    first = min(names.index(a) for a in axes)
    span = math.prod(sizes[first:])
    return NVLINK_BYTES_PER_S if span <= GPUS_PER_NODE \
        else NETWORK_BYTES_PER_S


def collective_bytes(cfg, shape, mesh, *, remat: bool = True,
                     microbatch: int = 1) -> Dict[str, float]:
    """Per-device bytes of every collective one step of ``cfg`` at
    ``shape`` needs on ``mesh``, by kind, as the JAX package's
    ``parse_collectives`` sums them from a compiled program (the larger
    of an op's operand and result, per device): one entry per kind of
    ``COLLECTIVE_KINDS``, ``total``, ``ops`` (the number of collective
    calls), ``seconds`` (each axis's bytes over its link,
    ``_axis_link_bytes_per_s``) and ``by_axis`` (bytes over the data
    axes and over ``model``).

    The rules, from the specs of ``launch/sharding.py`` over
    ``specs.abstract_params(cfg)``; D is the size of the data axes, M of
    ``model``; T the tokens of one data shard's microbatch (its rows:
    the global batch over D when D divides it, else the whole batch;
    times the sequence, plus the VLM's prefix; one token in decode; the
    audio encoder's leaves see its frames instead):

    * FSDP: every leaf whose spec splits a dim over the data axes is
      all-gathered over them before use: its bytes over the leaf's
      model split, once per forward pass; a training step gathers it
      again for the backward pass under remat, every microbatch;
    * gradients: in training, each such leaf's gradient is
      reduce-scattered over the data axes (the same bytes), and a leaf
      that no data axis splits is all-reduced over them (D > 1), every
      microbatch;
    * tensor parallelism: every product whose weight is split over
      ``model`` on the dim it sums over (attention's and the MLP's
      ``wo``, the SSM's ``out_proj``, the shared expert's ``wo``) and
      the embedding lookup of a table split over ``model`` all-reduce
      their (T, d) output over ``model`` (M > 1) at each application
      (the hybrid's shared block at each application point);
    * the MoE (M > 1 dividing the experts): two all-to-alls of the (E,
      capacity, d) dispatch buffer per layer, the capacity of T / M
      tokens (``models/moe.py::capacity``);
    * in training the activation collectives (the last two) run in the
      forward pass, in the backward pass (their transposes), and once
      more under remat; a supernet's layers run their first branch (the
      dry run's key, ``dryrun.supernet_key``), whose products alone
      count here, while every branch's leaves are gathered.

    They model the specs, not a compiler: no collective that a compiler
    would add or remove is in them, and the cross entropy's reductions
    over a vocabulary split (T floats each) are left out."""
    from repro_torch.launch import sharding, specs
    from repro_torch.launch.mesh import data_axes, mesh_axis_size
    from repro_torch.models.moe import capacity

    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
    ops = 0
    by_axis = {"data": 0.0, "model": 0.0}
    dax = data_axes(mesh)
    d_size = mesh_axis_size(mesh, dax)
    m_size = mesh.shape.get("model", 1)
    train = shape.kind == "train"
    mb = max(microbatch, 1) if train else 1
    rows = shape.global_batch // d_size \
        if shape.global_batch % d_size == 0 else shape.global_batch
    rows //= mb
    if shape.kind == "decode":
        seq = 1
    else:
        seq = shape.seq_len + (cfg.num_prefix if cfg.family == "vlm" else 0)
    t_dec = rows * seq
    t_enc = rows * cfg.num_prefix
    item = torch.empty((), dtype=cfg.torch_dtype).element_size()
    gathers = (1 + int(remat)) * mb if train else 1
    acts = (2 + int(remat)) * mb if train else 1

    def add(kind, nbytes, times, axis):
        nonlocal ops
        if times and nbytes:
            out[kind] += nbytes * times
            by_axis[axis] += nbytes * times
            ops += times

    shards = sharding.param_shardings(mesh, specs.abstract_params(cfg))
    for path, sh in sharding.flat_shardings(shards).items():
        model_div = sh.divisor(mesh, ("model",))
        data_div = sh.divisor(mesh, dax)
        nbytes = sh.nbytes / model_div
        if data_div > 1:
            add("all-gather", nbytes, gathers, "data")
            if train:
                add("reduce-scatter", nbytes, mb, "data")
        elif train and d_size > 1:
            add("all-reduce", nbytes, mb, "data")
        parts = path.split("/")
        if m_size == 1 or (cfg.supernet and parts[0] == "layers"
                           and parts[2] != "0"):
            continue
        if parts[-1] == "table" and sh.spec[0] == "model":
            add("all-reduce", t_dec * cfg.d_model * item, acts, "model")
        if parts[-1] == "w" and parts[-2] in ("wo", "out_proj") and \
                "experts" not in parts and sh.spec[0] == "model":
            tokens = t_enc if parts[0] == "encoder" else t_dec
            uses = (cfg.num_layers // cfg.attn_every
                    if parts[0] == "shared" else 1)
            add("all-reduce", tokens * sh.shape[-1] * item, acts * uses,
                "model")
        if parts[-1] == "wi" and "experts" in parts and \
                cfg.num_experts % m_size == 0:
            cap = capacity(-(-t_dec // m_size), cfg.num_experts, cfg.top_k,
                           cfg.capacity_factor)
            add("all-to-all", cfg.num_experts * cap * cfg.d_model * item,
                2 * acts, "model")
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    out["ops"] = float(ops)
    out["by_axis"] = by_axis
    out["seconds"] = sum(
        by_axis[a] / _axis_link_bytes_per_s(mesh, axes)
        for a, axes in (("data", dax), ("model", ("model",))) if by_axis[a])
    return out
