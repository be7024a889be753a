"""NSGA-II (Deb et al. 2000) — elitist non-dominated sorting + crowding.

Pure numpy; objectives are minimized (the runtime passes test *error* and
FLOPs).  Complexity matches the reference algorithm: O(m N^2) sorting,
O(m N log N) crowding.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """a Pareto-dominates b (all <=, at least one <)."""
    return bool(np.all(a <= b) and np.any(a < b))


def fast_non_dominated_sort(objs: np.ndarray) -> List[List[int]]:
    """objs: (N, m).  Returns fronts as lists of indices, best first."""
    n = len(objs)
    s = [[] for _ in range(n)]        # solutions i dominates
    counts = np.zeros(n, dtype=int)   # how many dominate i
    fronts: List[List[int]] = [[]]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if dominates(objs[i], objs[j]):
                s[i].append(j)
            elif dominates(objs[j], objs[i]):
                counts[i] += 1
        if counts[i] == 0:
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt = []
        for i in fronts[k]:
            for j in s[i]:
                counts[j] -= 1
                if counts[j] == 0:
                    nxt.append(j)
        k += 1
        fronts.append(nxt)
    return fronts[:-1]


def crowding_distance(objs: np.ndarray, front: Sequence[int]) -> np.ndarray:
    """Crowding distance of each member of one front."""
    f = np.asarray(front)
    n, m = len(f), objs.shape[1]
    dist = np.zeros(n)
    if n <= 2:
        dist[:] = np.inf
        return dist
    for k in range(m):
        order = np.argsort(objs[f, k], kind="stable")
        vals = objs[f[order], k]
        span = vals[-1] - vals[0]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        dist[order[1:-1]] += (vals[2:] - vals[:-2]) / span
    return dist


def select(objs: np.ndarray, n_select: int) -> List[int]:
    """Environmental selection: fronts in order, crowding-distance ties."""
    chosen: List[int] = []
    for front in fast_non_dominated_sort(objs):
        if len(chosen) + len(front) <= n_select:
            chosen.extend(front)
        else:
            dist = crowding_distance(objs, front)
            order = np.argsort(-dist, kind="stable")
            need = n_select - len(chosen)
            chosen.extend([front[i] for i in order[:need]])
            break
    return chosen


def knee_point(objs: np.ndarray, front: Sequence[int]) -> int:
    """Knee = max distance to the extreme-point chord (paper Section III.C
    picks knee solutions for deployment)."""
    f = np.asarray(front)
    pts = objs[f].astype(float)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    norm = (pts - lo) / span
    a = norm[np.argmin(norm[:, 0])]
    b = norm[np.argmin(norm[:, 1])]
    ab = b - a
    denom = np.linalg.norm(ab) + 1e-12
    cross = np.abs(ab[0] * (a[1] - norm[:, 1]) - ab[1] * (a[0] - norm[:, 0]))
    return int(f[np.argmax(cross / denom)])
