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
``fill_aggregate_stacked`` is the batched form for the ``vmap`` backend,
over uploads stacked on a leading axis; ``fill_partial`` is its one
reduction expression, which the fused fill shares.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

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


def supernet_trained_mask(params: Params, key: np.ndarray) -> Params:
    """Name -> 0-d float32 mask for the transformer supernets' flat master
    (``models.transformer.flat_params`` names): a leaf of branch b of
    layer l (``layers.{l}.{b}.…``) is trained iff ``key[l] == b + 1``
    (0 = identity trains nothing); everything outside ``layers`` is
    trained by every client.  Broadcast to its leaf, it is the JAX
    package's ``(L, 3, 1, …)`` mask."""
    dev = next(iter(params.values())).device
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    key = np.asarray(key)
    mask = {}
    for k in params:
        if k.startswith("layers."):
            _, l, b = k.split(".", 3)[:3]
            mask[k] = one if int(key[int(l)]) == int(b) + 1 else zero
        else:
            mask[k] = one
    return mask


def _flat_f32(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten leaves into one (P,) float32 vector (kernel layout)."""
    return torch.cat([x.reshape(-1).float() for x in leaves])


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
        # each upload flattened straight into its row of the (m, P)
        # matrices: at a 1.08 B-parameter master a stack of m flat rows
        # would hold every matrix twice
        shape = (len(uploads), flat_prev.numel())
        cl = torch.empty(shape, dtype=torch.float32, device=dev)
        mk = torch.empty(shape, dtype=torch.float32, device=dev)
        for i, (cp, cm, _) in enumerate(uploads):
            leaves = [cp[k] for k in names]
            torch.cat([x.reshape(-1) for x in leaves], out=cl[i])
            torch.cat([cm[k].float().reshape(1).expand(x.numel())
                       for k, x in zip(names, leaves)], out=mk[i])
        flat = kops.fill_aggregate(cl, mk, weights, flat_prev)
        del cl, mk
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


def fill_aggregate_stacked(prev_master: Params,
                           chunks: Sequence[Tuple[Params, np.ndarray,
                                                  np.ndarray]],
                           mask_fn: Callable,
                           backend: str = "kernel",
                           total: Optional[float] = None) -> Params:
    """Batched Algorithm 3 for the ``vmap`` execution backend.

    ``chunks`` holds stacked uploads: each entry is ``(stacked, keys,
    weights)`` where every leaf of ``stacked`` carries a leading (m,)
    upload axis (a leaf that a row did not train may be an ``expand``ed
    view of the master), ``keys`` is the host (m, num_blocks) int array
    and ``weights`` the host (m,) array.  The trained masks come from
    ``mask_fn`` row by row (``stacked_masks``).  ``fill_aggregate`` is
    its oracle.

    ``backend="kernel"`` flattens each chunk to the (m, P) client and
    mask matrices of the fill-aggregation kernel (its plain version on
    the CPU), ``"torch"`` sums leaf by leaf (``fill_partial``).  Weight
    normalization is global across chunks, so per-chunk partial sums
    compose exactly; callers whose chunk weights are ALREADY normalized
    pass ``total=1.0`` (the fused route): re-deriving it from the float
    sum would shift every weight by about one ulp, and that grows over
    generations of SGD."""
    if total is None:
        total = float(sum(float(np.sum(w)) for _, _, w in chunks))
    if backend == "kernel":
        return _fill_stacked_kernel(prev_master, chunks, mask_fn, total)
    if backend != "torch":
        raise ValueError(f"unknown aggregate backend {backend!r}; "
                         "available: ['torch', 'kernel']")
    dev = next(iter(prev_master.values())).device
    acc = None
    for stacked, keys, w in chunks:
        wnorm = torch.as_tensor(np.asarray(w, np.float32) / total,
                                device=dev)
        acc = fill_partial(prev_master, stacked,
                           stacked_masks(mask_fn, stacked, keys), wnorm, acc)
    return {k: acc[k].to(p.dtype) for k, p in prev_master.items()}


def _fill_stacked_kernel(prev_master: Params, chunks, mask_fn: Callable,
                         total: float) -> Params:
    """Kernel route of ``fill_aggregate_stacked`` (the JAX package's
    ``_fill_stacked_pallas``): flatten every chunk to the (m, P) client
    and mask matrices and sum the per-chunk partials (weights are
    globally normalized, so the kernel's ``sum_k w_k * filled_k``
    partials add up to Algorithm 3).  ``flat_prev`` is a fresh vector
    that nothing reads after the last chunk, so that chunk's launch
    writes in place into it (``donate_prev``)."""
    from repro_torch.kernels import ops as kops

    dev = next(iter(prev_master.values())).device
    flat_prev = _flat_f32(list(prev_master.values()))
    flat = None
    for i, (stacked, keys, w) in enumerate(chunks):
        wnorm = torch.as_tensor(np.asarray(w, np.float32) / total,
                                device=dev)
        cl, mk = _flatten_chunk(stacked, keys, mask_fn)
        part = kops.fill_aggregate(cl, mk, wnorm, flat_prev,
                                   donate_prev=(i == len(chunks) - 1))
        del cl, mk
        flat = part if flat is None else flat + part
    return _unflatten_like(flat, prev_master)


def stacked_masks(mask_fn: Callable, stacked: Params,
                  keys: np.ndarray) -> Params:
    """The JAX package's ``vmap(mask_fn)(stacked, keys)``: row i's mask
    from ``keys[i]``, stacked per leaf to (m, ...) float32."""
    rows = [mask_fn({k: v[i] for k, v in stacked.items()}, key)
            for i, key in enumerate(np.asarray(keys))]
    return {k: torch.stack([r[k].float() for r in rows]) for k in stacked}


def _flatten_chunk(stacked: Params, keys: np.ndarray, mask_fn: Callable):
    """(stacked leaves (m, ...), keys (m, nb)) -> (m, P) float32 client
    and mask matrices over the flattened parameter vector."""
    masks = stacked_masks(mask_fn, stacked, keys)
    m = len(keys)
    cl = torch.cat([x.reshape(m, -1).float() for x in stacked.values()],
                   dim=1)
    # a mask (m, 1, ...) expanded to the leaf's shape reshapes to an
    # (m, n) view with stride 0, so only the cat writes the matrix
    mk = torch.cat([mm.reshape(mm.shape + (1,) * (x.dim() - mm.dim()))
                    .expand(x.shape).reshape(m, -1)
                    for mm, x in zip(masks.values(), stacked.values())],
                   dim=1)
    return cl, mk


def fill_partial(prev_master: Params, stacked: Params, masks: Params,
                 wnorm: torch.Tensor, acc: Optional[Params] = None
                 ) -> Params:
    """The Algorithm 3 partial sum over one stack of uploads: per leaf,
    ``acc + sum_k w_k * (mask_k * client_k + (1 - mask_k) * prev)`` in
    float32, where every ``stacked``/``masks`` leaf carries a leading
    (m,) upload axis, ``wnorm`` is the (m,) globally-normalized weight
    vector (0-weight rows — padding, dropped clients — contribute
    exactly nothing) and ``acc`` the running sum of earlier stacks
    (zeros when None).

    This is THE reduction expression of the batched fill paths: the
    stacked aggregator's ``"torch"`` route and the fused fill both call
    it.  It adds the uploads one at a time, in order, onto the running
    sum, as ``fill_aggregate``'s torch route does, so the batched routes
    and the loop backend give the same float32 master whenever they see
    the same uploads and weights in the same order (on the full-width
    supernet a one-ulp difference in a master grows to about 1e-3 after
    one more generation of SGD)."""
    out = {}
    for k, prev in prev_master.items():
        cp, m = stacked[k], masks[k].float()
        m = m.reshape(m.shape + (1,) * (cp.dim() - m.dim()))
        filled = m * cp.float() + (1 - m) * prev.float()[None]
        run = torch.zeros_like(prev, dtype=torch.float32) \
            if acc is None else acc[k]
        for i in range(cp.shape[0]):
            run = run + wnorm[i] * filled[i]
        out[k] = run
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
