"""GShard/Switch-style top-k MoE with capacity-bounded gather dispatch.

The port of the JAX package's gather formulation
(``repro/models/moe.py::_moe_apply_gather``): route every token to its
top-k experts, rank each (token, choice) within its expert with one
stable sort, keep the first ``capacity`` of each expert, gather the kept
tokens into an (E, capacity, d) buffer, run the grouped SwiGLU expert FFN
on it and combine the outputs with the renormalised gates.  The dispatch
equals the JAX package's exactly (the same stable order, the same
slots).  ``backend="kernel"`` runs the expert FFN's three products on
the grouped GEMM kernel K5 (``kernels.ops.expert_ffn``; its plain
version on the CPU), ``"torch"`` and ``"chunked"`` (an attention route)
on ``torch.einsum``; routing is the same code on all.  The supernet's bottleneck branch (``ff_mask``)
narrows the expert hidden dim by a mask between the products; there the
JAX package runs its three einsums whatever the backend, and so does the
port: that branch launches no K5 on either route.

Under a registered mesh (``launch.policy.set_mesh``) whose ``model``
axis divides the experts and whose data axes divide the batch,
``moe_apply`` takes the expert-parallel path instead, the JAX package's
``_moe_apply_shard_map``: each of the D x M token slices is routed on its
own, with a capacity of its own, its dispatch buffers exchanged by two
``all_to_all``s over ``model``, the expert products run as einsums
(never K5, on any backend, as the JAX package never calls its
``expert_gemm`` there), and ``aux`` is the mean over the slices.  Its
capacity drops differ from the whole batch's, so on a mesh with more
than one slice ``y`` differs from the gather path's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import policy
from repro_torch.launch.mesh import Mesh, all_gather, all_to_all, \
    data_axes, mesh_axis_size, psum, replicate
from repro_torch.models.layers import mlp, mlp_init, uniform_init

Params = Dict[str, Dict[str, torch.Tensor]]


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Router ``(d, E)``, experts ``wi``/``wg`` ``(E, d, F)`` and ``wo``
    ``(E, F, d)``, and the shared expert's MLP where the config has one;
    U(-1/√fan_in, 1/√fan_in) as the JAX package (not its random bits)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": {"w": uniform_init(gen, (d, e), scale, dt)},
        "experts": {
            "wi": uniform_init(gen, (e, d, f), scale, dt),
            "wg": uniform_init(gen, (e, d, f), scale, dt),
            "wo": uniform_init(gen, (e, f, d), 1.0 / math.sqrt(f), dt),
        },
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, d, cfg.d_ff, dt)
    return p


def capacity(tokens: int, num_experts: int, top_k: int,
             factor: float) -> int:
    """Slots per expert: ``tokens * top_k * factor / num_experts`` rounded
    up to a multiple of 8, at least 8."""
    c = int(math.ceil(tokens * top_k * factor / num_experts))
    return max(8, -(-c // 8) * 8)


def expert_ffn(experts, x: torch.Tensor,
               ff_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped SwiGLU over (E, C, d) slots -> (E, C, d), on einsum.
    ``ff_mask`` (F,) zeroes the hidden units outside it before the down
    projection (the supernet's bottleneck)."""
    h = torch.einsum("ecd,edf->ecf", x, experts["wi"])
    g = torch.einsum("ecd,edf->ecf", x, experts["wg"])
    h = F.silu(g) * h
    if ff_mask is not None:
        h = h * ff_mask.to(h.dtype)
    return torch.einsum("ecf,efd->ecd", h, experts["wo"])


def route(p, x2: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Routing of ``x2`` (T, d) tokens by the float32 router: ``gate``
    (T, k) renormalised and ``expert`` (T, k) from the top k of its
    softmax, the Switch load-balance loss ``aux``, and ``slot`` (T * k,):
    choice ``t * k + j`` goes to slot ``expert * cap + rank`` where
    ``rank`` counts the earlier choices of the same expert, or to the
    overflow slot ``E * cap`` once its expert holds ``cap``."""
    t = x2.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(t, e, k, cfg.capacity_factor)
    logits = x2.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=0)
    flat = expert.reshape(-1)
    # choices per expert: a fixed-size count (bincount's integers, with
    # no host sync and a meta form), out of place as the rest
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device).scatter_add(
        0, flat, torch.ones_like(flat))
    ce = counts.float() / (t * k)
    aux = e * torch.sum(me * ce)

    # rank every choice within its expert by one stable sort over the t*k
    # choices (never the (t, E) one-hot cumsum)
    order = torch.argsort(flat, stable=True)
    sorted_expert = flat[order]
    starts = torch.searchsorted(
        sorted_expert, torch.arange(e, dtype=flat.dtype, device=flat.device))
    rank_sorted = (torch.arange(t * k, device=flat.device)
                   - starts[sorted_expert])
    # out of place throughout, so that torch.func.vmap can batch it
    rank = torch.empty_like(rank_sorted).scatter(0, order, rank_sorted)
    slot = torch.where(rank < cap, flat * cap + rank,
                       torch.full_like(rank, e * cap))
    return {"gate": gate, "expert": expert, "aux": aux, "slot": slot,
            "cap": cap}


def dispatch(x2: torch.Tensor, slot: torch.Tensor, cfg: ModelConfig,
             cap: int) -> torch.Tensor:
    """The (E, cap, d) expert input: each kept choice's token in its
    slot, zeros in the slots no choice took."""
    t, d = x2.shape
    e, k = cfg.num_experts, cfg.top_k
    token = torch.arange(t, device=x2.device).repeat_interleave(k)
    # one row past the slots takes every dropped choice (several writes
    # at once; the row is cut off and never read)
    slot_token = torch.zeros(e * cap + 1, dtype=torch.long,
                             device=x2.device).scatter(0, slot, token)
    slot_used = torch.zeros(e * cap + 1, dtype=x2.dtype,
                            device=x2.device).scatter(
        0, slot, torch.ones(slot.shape, dtype=x2.dtype, device=x2.device))
    expert_in = x2[slot_token[:e * cap]] * slot_used[:e * cap, None]
    return expert_in.reshape(e, cap, d)


def _combine(out: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
             k: int) -> torch.Tensor:
    """The (T, d) output of T tokens from the (E * cap, d) expert
    outputs: each token's k kept choices weighted by their gates, added
    in choice order (in bf16 the order is the sum); a dropped choice
    reads the zero row past the slots."""
    d = out.shape[1]
    out = torch.cat([out, torch.zeros((1, d), dtype=out.dtype,
                                      device=out.device)])
    slot_tk = slot.reshape(-1, k)
    y = torch.zeros((slot_tk.shape[0], d), dtype=out.dtype,
                    device=out.device)
    for j in range(k):
        y = y + out[slot_tk[:, j]] * gate[:, j, None]
    return y


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              ff_mask: Optional[torch.Tensor] = None,
              backend: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss (float32)).
    ``ff_mask`` (F,) optionally narrows the expert hidden dim.  Takes the
    expert-parallel path when a registered mesh's ``model`` axis divides
    the experts and its data axes divide B."""
    kops.check_backend(backend)
    mesh = policy.get_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        if (cfg.num_experts % mesh.shape["model"] == 0
                and x.shape[0] % policy.data_axis_size(mesh) == 0):
            return _moe_apply_expert_parallel(p, x, cfg, mesh,
                                              ff_mask=ff_mask)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    x2 = x.reshape(b * s, d)
    r = route(p, x2, cfg)
    cap = r["cap"]
    expert_in = dispatch(x2, r["slot"], cfg, cap)
    if ff_mask is not None:
        out = expert_ffn(p["experts"], expert_in, ff_mask)
    else:
        ffn = kops.expert_ffn if backend == "kernel" else expert_ffn
        out = ffn(p["experts"], expert_in)
    y2 = _combine(out.reshape(e * cap, d), r["slot"], r["gate"].to(x.dtype),
                  k)
    if "shared" in p:
        y2 = y2 + mlp(p["shared"], x2)
    return y2.reshape(b, s, d), r["aux"]


def _moe_apply_expert_parallel(p, x: torch.Tensor, cfg: ModelConfig,
                               mesh: Mesh, *,
                               ff_mask: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the mesh's ``model`` axis (M columns) and
    D data shards, with explicit all-to-alls (GShard).

    Data shard i takes B / D requests; its tokens are padded to a multiple
    of M and column j routes the j-th slice of them with a capacity of its
    own (``route``/``dispatch`` on that slice).  The (E, cap, d) dispatch
    buffers are exchanged over ``model`` so that column j holds its E / M
    experts' slots from every peer; the three products run as einsums on
    those experts' weights, ``ff_mask`` between them; the outputs go back
    by the reverse exchange, each column combines its tokens' k choices
    in order, and the columns' slices are put back together in token
    order.  ``aux`` is the mean over the D * M slices.  The shared
    expert, where the config has one, is added on the whole input
    afterwards.  Plain PyTorch: differentiable, and no kernel launches."""
    if mesh.abstract:
        raise ValueError(f"the expert-parallel MoE needs a mesh of devices, "
                         f"not the abstract {mesh}")
    dax = tuple(a for a in data_axes(mesh) if a in mesh.axis_names)
    m = mesh.shape["model"]
    d_size = mesh_axis_size(mesh, dax)
    e, k = cfg.num_experts, cfg.top_k
    b, s, d = x.shape
    bl = b // d_size
    t_loc = bl * s
    t_slice = -(-t_loc // m)              # tokens routed per column
    t_pad = t_slice * m
    el = e // m
    # grid[i][j]: data shard i (the data axes flattened), column j
    order = [mesh.axis_names.index(a) for a in dax + ("model",)]
    grid = np.transpose(mesh.devices, order).reshape(d_size, m)
    # column j's E / M experts (whole: the JAX package gathers them over
    # the data axes from their FSDP shards; one process holds them whole)
    weights = [{n: w[j * el:(j + 1) * el] for n, w in p["experts"].items()}
               for j in range(m)]
    ys, auxes = [], []
    for i in range(d_size):
        x2 = x[i * bl:(i + 1) * bl].reshape(t_loc, d)
        if t_pad != t_loc:
            x2 = F.pad(x2, (0, 0, 0, t_pad - t_loc))
        routes, bufs = [], []
        for j in range(m):
            xs = x2[j * t_slice:(j + 1) * t_slice].to(grid[i][j])
            r = route({"router": replicate(p["router"], xs.device)}, xs,
                      cfg)
            routes.append(r)
            bufs.append(dispatch(xs, r["slot"], cfg, r["cap"]))
        # experts <-> tokens: column j gets (E / M, M * cap, d)
        ei = all_to_all(bufs, split_dim=0, concat_dim=1)
        eo = [expert_ffn(replicate(weights[j], ei[j].device), ei[j],
                         None if ff_mask is None
                         else ff_mask.to(ei[j].device))
              for j in range(m)]
        eo = all_to_all(eo, split_dim=1, concat_dim=0)   # (E, cap, d)
        # each column combines its own tokens; the JAX package's psum over
        # model of the zero-padded slices adds exact zeros: a concatenation
        cols = [_combine(eo[j].reshape(-1, d), r["slot"],
                         r["gate"].to(x.dtype), k)
                for j, r in enumerate(routes)]
        ys.append(all_gather(cols)[:t_loc].reshape(bl, s, d))
        auxes.extend(r["aux"] for r in routes)
    y = all_gather(ys, dim=0).to(x.device)
    aux = psum([a.reshape(1) for a in auxes])[0].to(x.device) / (d_size * m)
    if "shared" in p:
        y = y + mlp(p["shared"], x.reshape(b * s, d)).reshape(b, s, d)
    return y, aux
