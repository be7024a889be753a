"""Federated client/server primitives (Algorithm 1 + the client side of
Algorithm 4): local SGD over pre-batched shards and weighted evaluation.

Shards arrive as tensors (num_batches, B, ...) on the parameters' device;
the choice key is a host int array.  Only the leaves of the selected
subnet (plus stem and head) get gradients; every other leaf comes back
as the same tensor, bit-unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from repro_torch.core.supernet import SupernetAPI
from repro_torch.optim import sgd_init, sgd_update

Params = Dict[str, torch.Tensor]


def client_update_fn(api: SupernetAPI, epochs: int = 1,
                     momentum: float = 0.5) -> Callable:
    """Client update: E epochs of minibatch SGD from the downloaded
    (weight-inherited) master, on the selected subnet (Algorithm 4 lines
    57-68).  Velocity starts at zero on every call."""

    def update(params: Params, key, xb, yb, lr: float) -> Params:
        vel = sgd_init(params)
        for _ in range(epochs):
            for x, y in zip(xb, yb):
                leaves = {k: v.detach().requires_grad_()
                          for k, v in params.items()}
                loss = api.loss(leaves, {"x": x, "y": y}, key)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
                grads = {k: g for k, g in zip(leaves, grads)
                         if g is not None}
                params, vel = sgd_update(params, grads, vel, lr, momentum)
        return params

    return update


def eval_count_fn(api: SupernetAPI) -> Callable:
    """Wrong-prediction count over a client's pre-batched test shard
    (a 0-d int64 tensor on the parameters' device)."""

    @torch.no_grad()
    def evaluate(params: Params, key, xb, yb) -> torch.Tensor:
        errs = torch.zeros((), dtype=torch.int64, device=xb.device)
        for x, y in zip(xb, yb):
            errs = errs + api.error_count(params, {"x": x, "y": y}, key)
        return errs

    return evaluate


def weighted_test_error(evaluate, params, key, clients: Sequence) -> float:
    """Paper Algorithm 4 line 49: weighted average of client test errors.
    ``clients`` are (xb, yb) test shards as tensors."""
    wrong = total = 0
    for xb, yb in clients:
        wrong += int(evaluate(params, key, xb, yb))
        total += xb.shape[0] * xb.shape[1]
    return wrong / max(total, 1)
