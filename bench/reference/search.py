"""Plain reference of one generation of the real-time search (paper
Algorithm 4), on a model reference's ``loss``, ``wrong``, ``trained``
and ``used``:

* a client's update: ``epochs`` passes of minibatch SGD with momentum
  (``v = momentum * v + g``, ``p -= lr * v``, velocity from zero) from
  the master, over the leaves its key uses;
* fill-aggregation (Algorithm 3): per leaf, the weighted sum over the
  uploads of the client's leaf where its key trained it and the
  previous master's elsewhere, in float32, weights ``n_k / sum n``;
* error counts: wrong predictions over every participant's test
  batches (each batch its own normalisation statistics);
* NSGA-II environmental selection on (error, objective), fronts first,
  crowding distance to break a front (Deb et al. 2002), as the
  repository's ``core/nsga2.py`` orders ties (a frozen copy).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def lr_at(lr0: float, decay: float, gen: int) -> float:
    """The round's learning rate, ``lr0 * decay^(gen - 1)`` in float32."""
    return float(np.float32(lr0 * decay ** (gen - 1)))


def client_update(ref, params, key, xb, yb, lr, momentum, epochs,
                  model) -> Dict[str, torch.Tensor]:
    """The leaves ``key`` trains after the client's local SGD."""
    names = [k for k in params if ref.used(k, key, model)]
    p = {k: params[k] for k in names}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    for _ in range(epochs):
        for x, y in zip(xb, yb):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            full = dict(params)
            full.update(leaves)
            loss = ref.loss(full, x, y, key, model)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            for k, g in zip(names, grads):
                vel[k] = momentum * vel[k] + g
                p[k] = p[k] - lr * vel[k].to(p[k].dtype)
    return {k: v.detach() for k, v in p.items()}


def fill_aggregate(ref, master, uploads) -> Dict[str, torch.Tensor]:
    """``uploads``: [(trained leaves, key, n_k)] -> the new master."""
    total = float(sum(n for _, _, n in uploads))
    w = [float(np.float32(n) / np.float32(total)) for _, _, n in uploads]
    out = {}
    for name, prev in master.items():
        acc = torch.zeros_like(prev, dtype=torch.float32)
        for wk, (leaves, key, _) in zip(w, uploads):
            src = leaves[name] if ref.trained(name, key) and name in leaves \
                else prev
            acc += wk * src.float()
        out[name] = acc.to(prev.dtype)
    return out


def error_counts(ref, master, keys, shards, model) -> np.ndarray:
    """Wrong predictions of each key over ``shards``: [(xb, yb)]."""
    return np.asarray([sum(ref.wrong(master, x, y, key, model)
                           for xb, yb in shards for x, y in zip(xb, yb))
                       for key in keys], np.int64)


def _dominates(a, b) -> bool:
    return bool(np.all(a <= b) and np.any(a < b))


def _fronts(objs: np.ndarray) -> List[List[int]]:
    n = len(objs)
    beats = [[] for _ in range(n)]
    count = np.zeros(n, dtype=int)
    fronts: List[List[int]] = [[]]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if _dominates(objs[i], objs[j]):
                beats[i].append(j)
            elif _dominates(objs[j], objs[i]):
                count[i] += 1
        if count[i] == 0:
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt = []
        for i in fronts[k]:
            for j in beats[i]:
                count[j] -= 1
                if count[j] == 0:
                    nxt.append(j)
        k += 1
        fronts.append(nxt)
    return fronts[:-1]


def _crowding(objs: np.ndarray, front: Sequence[int]) -> np.ndarray:
    f = np.asarray(front)
    dist = np.zeros(len(f))
    if len(f) <= 2:
        dist[:] = np.inf
        return dist
    for k in range(objs.shape[1]):
        order = np.argsort(objs[f, k], kind="stable")
        vals = objs[f[order], k]
        span = vals[-1] - vals[0]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        dist[order[1:-1]] += (vals[2:] - vals[:-2]) / span
    return dist


def select(objs: np.ndarray, n: int) -> List[int]:
    chosen: List[int] = []
    for front in _fronts(objs):
        if len(chosen) + len(front) <= n:
            chosen.extend(front)
            continue
        order = np.argsort(-_crowding(objs, front), kind="stable")
        chosen.extend(front[i] for i in order[:n - len(chosen)])
        break
    return chosen
