"""Fill-aggregation (paper Algorithm 3).

Clients upload sub-models; the server reconstructs full master models by
*filling* the branches a client did not train with the previous master's
weights, then weighted-averages the reconstructions:

    theta(t) = sum_k w_k * ( mask_k * theta_k + (1 - mask_k) * theta(t-1) )

``mask_k`` marks the leaves client k actually trained, derived from its
choice key.  Non-choice-block leaves (stem, head) have mask 1 — they are
trained by every client and plain-FedAvg'd, exactly the ``theta_k^i not
in choice blocks`` case of Algorithm 3.

Parameters are ordered ``dict[str, Tensor]`` (``state_dict`` names).
Two routes compute the same function: ``"torch"`` leaf by leaf, summing
the uploads in upload order (the JAX package's ``"xla"`` route), and
``"kernel"`` on one flat (P,) vector through
``repro_torch.kernels.ops.fill_aggregate`` (its ``"pallas"`` route).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.cnn import BRANCH_NAMES

Params = Dict[str, torch.Tensor]


def cnn_trained_mask(params: Params, key: np.ndarray) -> Params:
    """Name -> 0-d float32 mask for the CIFAR CNN supernet: 1 outside the
    choice blocks, and inside block i 1 exactly on branch ``key[i]``."""
    dev = next(iter(params.values())).device
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    mask = {}
    for k in params:
        if k.startswith("blocks."):
            _, i, nm, _ = k.split(".")
            sel = int(key[int(i)]) == BRANCH_NAMES.index(nm)
            mask[k] = one if sel else zero
        else:
            mask[k] = one
    return mask


def _flat_f32(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten leaves into one (P,) float32 vector (kernel layout)."""
    return torch.cat([x.reshape(-1).float() for x in leaves])


def _flat_mask_f32(mask_leaves: Sequence[torch.Tensor],
                   leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten scalar mask leaves against their parameter leaves into one
    (P,) float32 vector."""
    return torch.cat([m.float().reshape(1).expand(x.numel())
                      for m, x in zip(mask_leaves, leaves)])


def _unflatten_like(flat: torch.Tensor, ref: Params) -> Params:
    """Inverse of ``_flat_f32``: slice a (P,) vector back into ``ref``'s
    names, shapes and dtypes (float32 leaves are views of ``flat``)."""
    out, off = {}, 0
    for k, x in ref.items():
        n = x.numel()
        out[k] = flat[off: off + n].view(x.shape).to(x.dtype)
        off += n
    return out


def fill_aggregate(prev_master: Params,
                   uploads: Sequence[Tuple[Params, Params, float]],
                   backend: str = "kernel") -> Params:
    """uploads: [(client_params, trained_mask, weight n_k/n)].  Weights are
    normalized here, in Python floats and then rounded to float32, so
    partial participation stays a proper average."""
    total = float(sum(w for _, _, w in uploads))
    dev = next(iter(prev_master.values())).device
    weights = torch.tensor([w / total for _, _, w in uploads],
                           dtype=torch.float32, device=dev)

    if backend == "kernel":
        from repro_torch.kernels import ops as kops
        names = list(prev_master)
        flat_prev = _flat_f32([prev_master[k] for k in names])
        cl = torch.stack([_flat_f32([cp[k] for k in names])
                          for cp, _, _ in uploads])
        mk = torch.stack([_flat_mask_f32([cm[k] for k in names],
                                         [cp[k] for k in names])
                          for cp, cm, _ in uploads])
        flat = kops.fill_aggregate(cl, mk, weights, flat_prev)
        return _unflatten_like(flat, prev_master)
    if backend != "torch":
        raise ValueError(f"unknown aggregate backend {backend!r}; "
                         "available: ['torch', 'kernel']")

    out = {}
    for k, prev in prev_master.items():
        p32 = prev.float()
        acc = torch.zeros_like(p32)
        for i, (cp, cm, _) in enumerate(uploads):
            m = cm[k].float()
            filled = m * cp[k].float() + (1 - m) * p32
            acc = acc + weights[i] * filled
        out[k] = acc.to(prev.dtype)
    return out


def fedavg(uploads: Sequence[Tuple[Params, float]]) -> Params:
    """Plain FedAvg (Algorithm 1 line 9) — the paper's baseline aggregator."""
    total = float(sum(w for _, w in uploads))
    first = uploads[0][0]
    dev = next(iter(first.values())).device
    weights = torch.tensor([w / total for _, w in uploads],
                           dtype=torch.float32, device=dev)
    out = {}
    for k, x0 in first.items():
        acc = torch.zeros_like(x0, dtype=torch.float32)
        for i, (p, _) in enumerate(uploads):
            acc = acc + weights[i] * p[k].float()
        out[k] = acc.to(x0.dtype)
    return out
