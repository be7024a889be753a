"""Federated client/server primitives (Algorithm 1 + the client side of
Algorithm 4): local SGD over pre-batched shards, weighted evaluation, and
plain FedAvg rounds for the fixed-model baseline.

Shards arrive as tensors (num_batches, B, ...) on the parameters' device;
the choice key is a host int array.  Only the leaves of the selected
subnet (plus stem and head) get gradients; every other leaf comes back
as the same tensor, bit-unchanged.
"""
from __future__ import annotations

from typing import Callable, ContextManager, Dict, Sequence

import torch

from repro_torch.core.aggregate import fedavg
from repro_torch.core.supernet import SupernetAPI
from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.optim import sgd_init, sgd_update

Params = Dict[str, torch.Tensor]


def client_update_fn(api: SupernetAPI, epochs: int = 1,
                     momentum: float = 0.5,
                     span: Callable[[str], ContextManager]
                     = NULL_TELEMETRY.span) -> Callable:
    """Client update: E epochs of minibatch SGD from the downloaded
    (weight-inherited) master, on the selected subnet (Algorithm 4 lines
    57-68).  Velocity starts at zero on every call.

    ``span(name)`` gives the telemetry span each optimizer step runs
    under (``"sgd_update"``); it is called at every step, so a backend
    passes a function that reads its telemetry then, which the engine
    attaches after the backend is built."""

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
                with span("sgd_update"):
                    params, vel = sgd_update(params, grads, vel, lr,
                                             momentum)
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


def fedavg_round(update, params: Params, key, clients: Sequence, lr
                 ) -> Params:
    """One FedAvg round of the fixed-model baseline (all clients train the
    same model; plain weighted averaging).  ``clients`` are
    ``ClientDataset``s; their host shards move to the parameters'
    device."""
    dev = next(iter(params.values())).device
    uploads = []
    for c in clients:
        xb, yb = (torch.as_tensor(a, device=dev) for a in c.train)
        p_k = update(params, key, xb, yb, lr)
        uploads.append((p_k, c.weight))
    return fedavg(uploads)
