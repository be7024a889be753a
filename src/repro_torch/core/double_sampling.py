"""Double-sampling (paper Section III.B, contribution 1).

(a) model sampling — one choice key per individual samples a sub-network of
    the master model;
(b) client sampling — the m = C*K participating clients are partitioned
    WITHOUT replacement into N groups of L = floor(m/N); group g trains the
    sub-model of individual g, so every client trains exactly one sub-model
    exactly once per generation.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import choice


def sample_participants(rng: np.random.Generator, total_clients: int,
                        participation: float) -> np.ndarray:
    """Select m = C*K participating clients for this round."""
    m = max(1, int(round(participation * total_clients)))
    return rng.permutation(total_clients)[:m]


def sample_client_groups(rng: np.random.Generator, participants: np.ndarray,
                         n_individuals: int,
                         strict: bool = False) -> List[np.ndarray]:
    """Partition participants into N disjoint groups of L = floor(m/N).

    The paper assumes m >= N (#clients >= population size); in that
    regime clients beyond N*L idle this round, matching the floor in the
    paper.  Under real-time availability (`ClientSimConfig`) fewer than
    N clients may show up, so instead of failing the round degrades
    gracefully: each of the first m groups gets one client and the rest
    stay empty.  An empty group trains nobody, so its individual's
    blocks are simply *filled* from the previous master during
    aggregation — exactly Algorithm 3's semantics for untrained
    branches — and with m == 0 the whole round leaves the master
    untouched.

    ``strict=True`` restores the legacy m >= N requirement: a fully
    synchronous run (no availability simulation) that is short of
    clients is a *misconfiguration*, not churn, and should fail loudly
    rather than silently search over mostly-empty groups.
    """
    m = len(participants)
    if strict and m < n_individuals:
        raise ValueError(f"need >= {n_individuals} clients, got {m}")
    perm = rng.permutation(participants)
    if m >= n_individuals:
        l_per = m // n_individuals
        return [perm[g * l_per:(g + 1) * l_per]
                for g in range(n_individuals)]
    return [perm[g:g + 1] for g in range(n_individuals)]


def sample_population_keys(rng: np.random.Generator, n: int,
                           num_blocks: int) -> List[np.ndarray]:
    return [choice.random_key(rng, num_blocks) for _ in range(n)]
