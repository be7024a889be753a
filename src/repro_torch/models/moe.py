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

Not ported here: the ``shard_map`` expert-parallel path (ROADMAP queue
1: mesh and launch); on one card there is no mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
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
    ce = torch.bincount(flat, minlength=e).float() / (t * k)
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


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              ff_mask: Optional[torch.Tensor] = None,
              backend: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss (float32)).
    ``ff_mask`` (F,) optionally narrows the expert hidden dim."""
    kops.check_backend(backend)
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
    out = out.reshape(e * cap, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=out.dtype,
                                      device=out.device)])
    slot_tk = r["slot"].reshape(b * s, k)
    gate = r["gate"].to(x.dtype)
    y2 = torch.zeros_like(x2)
    for j in range(k):            # in order: in bf16 the order is the sum
        y2 = y2 + out[slot_tk[:, j]] * gate[:, j, None]
    if "shared" in p:
        y2 = y2 + mlp(p["shared"], x2)
    return y2.reshape(b, s, d), r["aux"]
