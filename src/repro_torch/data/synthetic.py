"""Synthetic-but-learnable image classification data.

A class-conditional image mixture with CIFAR-10's tensor shapes
(32x32x3, 10 classes): each class owns a smooth random prototype field;
samples are prototype + noise.  Difficulty is set by the signal/noise
ratio.  The draws are the JAX package's, number for number.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(seed: int, n: int, image: int = 32, classes: int = 10,
                        channels: int = 3, signal: float = 1.0,
                        noise: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    # smooth prototypes: low-res random fields upsampled (so conv nets with
    # small receptive fields can pick up class structure)
    low = rng.normal(size=(classes, 4, 4, channels))
    reps = image // 4
    protos = np.repeat(np.repeat(low, reps, axis=1), reps, axis=2)
    y = rng.integers(0, classes, size=n)
    x = protos[y] * signal + rng.normal(size=(n, image, image, channels)) * noise
    return x.astype(np.float32), y.astype(np.int32)


class VirtualClassification:
    """Materialization-free class-conditional image source.

    Same prototype-plus-noise structure as ``make_classification`` (the
    class prototypes come from the identical ``default_rng(seed)``
    draws), but sample ``i``'s label and noise come from a per-index
    counter-based stream ``default_rng((seed, i))`` — so ``take(idx)``
    produces ANY subset of a nominal ``n``-sample dataset in O(len(idx))
    time and memory.  NOT sample-for-sample identical to
    ``make_classification`` (which draws all labels, then all noise,
    from one sequential stream).

    Plugs into ``repro_torch.data.pipeline.ClientFleet`` via ``take``."""

    def __init__(self, seed: int, n: int, image: int = 32,
                 classes: int = 10, channels: int = 3,
                 signal: float = 1.0, noise: float = 1.0):
        rng = np.random.default_rng(seed)
        low = rng.normal(size=(classes, 4, 4, channels))
        reps = image // 4
        self.protos = np.repeat(np.repeat(low, reps, axis=1), reps, axis=2)
        self.seed = seed
        self.n = n
        self.image = image
        self.classes = classes
        self.channels = channels
        self.signal = signal
        self.noise = noise

    def __len__(self) -> int:
        return self.n

    def take(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize the samples at ``indices`` (sorted or not)."""
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"sample indices out of range [0, {self.n})")
        shape = (self.image, self.image, self.channels)
        x = np.empty((len(idx),) + shape, np.float32)
        y = np.empty(len(idx), np.int32)
        for row, i in enumerate(idx):
            r = np.random.default_rng((self.seed, int(i)))
            yi = int(r.integers(0, self.classes))
            y[row] = yi
            x[row] = (self.protos[yi] * self.signal
                      + r.normal(size=shape) * self.noise)
        return x, y
