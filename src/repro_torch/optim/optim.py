"""Optimizers and learning-rate schedules.

SGD + momentum reproduces the paper's client optimizer (Table II: lr 0.1,
momentum 0.5, per-round decay 0.995); AdamW and ``cosine_decay`` serve
the LM training launcher (``launch/train.py``).  Parameters are ordered
``dict[str, Tensor]``.  ``sgd_update`` returns a parameter absent from
``grads`` (a branch the choice key did not select, which autograd gives
no gradient) as the same tensor object, bit-unchanged: within one client
update that equals a zero gradient, since the velocity starts at zero.
``adamw_update`` takes a gradient for every parameter; the launcher
gives an unselected branch a zero one, as ``jax.grad`` does.
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
    """``v = momentum * v + g; p -= lr * v`` for every leaf in ``grads``
    (v cast to p's dtype, as the JAX package casts it)."""
    vel = dict(vel)
    out = dict(params)
    for k, g in grads.items():
        vel[k] = momentum * vel[k] + g
        out[k] = params[k] - lr * vel[k].to(params[k].dtype)
    return out, vel


def adamw_init(params: Params) -> Dict[str, object]:
    """Zero float32 moments ``m`` and ``v`` per leaf and ``step``, an int32
    0-d tensor, on the parameters' device."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return {"m": zeros, "v": {k: torch.zeros_like(z)
                              for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(params: Params, grads: Params, state, lr, b1=0.9,
                 b2=0.95, eps=1e-8, wd=0.01) -> Tuple[Params, dict]:
    """One AdamW step, the JAX package's arithmetic: moments and update
    in float32, bias corrections ``1 - b ** step`` in float32, the new
    parameter cast back to its dtype.  ``grads`` holds every leaf."""
    step = state["step"] + 1
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    m, v, out = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m[k] = b1 * state["m"][k] + (1 - b1) * g
        v[k] = b2 * state["v"][k] + (1 - b2) * torch.square(g)
        p32 = p.float()
        u = (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) + wd * p32
        out[k] = (p32 - lr * u).to(p.dtype)
    return out, {"m": m, "v": v, "step": step}


def round_decay(lr0: float, decay: float, t) -> np.float32:
    """Paper Table II: lr(t) = lr0 * decay^t per communication round,
    rounded to float32 as the JAX package rounds it."""
    return np.float32(lr0 * decay ** t)


def cosine_decay(lr0: float, step, total: int, warmup: int = 0
                 ) -> np.float32:
    """Linear warm-up over ``warmup`` steps, then a cosine from lr0 to 0
    at ``total``; float32 arithmetic, as the JAX package's."""
    f = np.float32
    step = f(step)
    if step < warmup:
        return f(lr0) * step / f(max(warmup, 1))
    frac = np.clip((step - f(warmup)) / f(max(total - warmup, 1)),
                   f(0), f(1))
    return f(lr0 * 0.5) * (f(1) + np.cos(f(np.pi) * frac))
