"""Choice-key encoding for the paper's search space (Section III.A).

A sub-network of the master model is identified by one 2-bit code per
choice block: [0,0]=identity(0), [0,1]=residual(1), [1,0]=inverted(2),
[1,1]=depthwise-separable(3).  For transformer supernets the same four
slots mean identity / full / bottleneck / lite (DESIGN.md Section 3).

Keys travel as int arrays (one int in [0,4) per block); the binary string
form used by the genetic operators is 2*L bits.
"""
from __future__ import annotations

import numpy as np

NUM_BRANCHES = 4
BITS_PER_BLOCK = 2


def random_key(rng: np.random.Generator, num_blocks: int) -> np.ndarray:
    return rng.integers(0, NUM_BRANCHES, size=num_blocks).astype(np.int32)


def key_to_bits(key: np.ndarray) -> np.ndarray:
    """(L,) ints in [0,4) -> (2L,) bits, MSB first per block."""
    key = np.asarray(key, dtype=np.int64)
    hi = (key >> 1) & 1
    lo = key & 1
    return np.stack([hi, lo], axis=1).reshape(-1).astype(np.int8)


def bits_to_key(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, BITS_PER_BLOCK)
    return (bits[:, 0] * 2 + bits[:, 1]).astype(np.int32)


def one_point_crossover(rng: np.random.Generator, a_bits, b_bits):
    """Binary one-point crossover (paper Table I: p_c = 0.9)."""
    n = len(a_bits)
    point = int(rng.integers(1, n))
    c1 = np.concatenate([a_bits[:point], b_bits[point:]])
    c2 = np.concatenate([b_bits[:point], a_bits[point:]])
    return c1, c2


def bit_flip_mutation(rng: np.random.Generator, bits, p: float):
    """Binary bit-flip mutation (paper Table I: p_m = 0.1)."""
    flips = rng.random(len(bits)) < p
    out = np.asarray(bits).copy()
    out[flips] ^= 1
    return out


def make_offspring(rng: np.random.Generator, parent_keys, n_offspring: int,
                   p_crossover: float = 0.9, p_mutation: float = 0.1):
    """Generate offspring choice keys from parent keys (Algorithm 4 l.10-12)."""
    parents = list(parent_keys)
    out = []
    while len(out) < n_offspring:
        i, j = rng.choice(len(parents), size=2, replace=False)
        a, b = key_to_bits(parents[i]), key_to_bits(parents[j])
        if rng.random() < p_crossover:
            a, b = one_point_crossover(rng, a, b)
        a = bit_flip_mutation(rng, a, p_mutation)
        b = bit_flip_mutation(rng, b, p_mutation)
        out.extend([bits_to_key(a), bits_to_key(b)])
    return out[:n_offspring]
