"""The client optimizer and its learning-rate schedule.

SGD + momentum reproduces the paper's client optimizer (Table II: lr 0.1,
momentum 0.5, per-round decay 0.995).  Parameters are ordered
``dict[str, Tensor]``; a parameter absent from ``grads`` (a branch the
choice key did not select, which autograd gives no gradient) is returned
as the same tensor object, bit-unchanged.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def sgd_init(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def sgd_update(params: Params, grads: Params, vel: Params, lr: float,
               momentum: float = 0.5) -> Tuple[Params, Params]:
    """``v = momentum * v + g; p -= lr * v`` for every leaf in ``grads``."""
    vel = dict(vel)
    out = dict(params)
    for k, g in grads.items():
        vel[k] = momentum * vel[k] + g
        out[k] = params[k] - lr * vel[k]
    return out, vel


def round_decay(lr0: float, decay: float, t) -> np.float32:
    """Paper Table II: lr(t) = lr0 * decay^t per communication round,
    rounded to float32 as the JAX package rounds it."""
    return np.float32(lr0 * decay ** t)
