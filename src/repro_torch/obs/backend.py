"""InstrumentedBackend: phase spans applied around any execution backend.

The same decorating pattern as ``repro_torch.comm.backend.CodecBackend`` —
implement the ``ExecutionBackend`` protocol, proxy the engine plumbing
(``name`` / ``dispatches`` / ``reset``), delegate the work.  The engine
wraps it *outermost* (``InstrumentedBackend(CodecBackend(backend))``)
so a ``fill_train`` span covers the whole backend call including codec
encode/decode, and the codec's own ``codec_encode``/``codec_decode``
spans nest beneath it in the recorded paths
(``"fill_train/codec_decode"``).

Like the codec wrapper, it is only constructed when telemetry is
enabled; disabled runs keep the exact pre-subsystem call path.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

Params = Any


class InstrumentedBackend:
    """Wrap ``inner`` so every backend call runs under a telemetry span:
    ``fill_train`` for the training entry points, ``eval`` for the
    evaluation ones."""

    def __init__(self, inner, telemetry):
        self.inner = inner
        self.telemetry = telemetry

    # -- engine plumbing -----------------------------------------------------

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def dispatches(self) -> int:
        return self.inner.dispatches

    @dispatches.setter
    def dispatches(self, value: int) -> None:
        self.inner.dispatches = value

    def reset(self) -> None:
        reset = getattr(self.inner, "reset", None)
        if reset is not None:
            reset()

    # -- ExecutionBackend protocol -------------------------------------------

    def train_fill(self, master: Params, keys, groups, lr: float,
                   survivors=None) -> Params:
        with self.telemetry.span("fill_train"):
            return self.inner.train_fill(master, keys, groups, lr,
                                         survivors=survivors)

    def train_fedavg(self, params: Params, key, client_ids,
                     lr: float, survivors=None) -> Params:
        with self.telemetry.span("fill_train"):
            return self.inner.train_fedavg(params, key, client_ids, lr,
                                           survivors=survivors)

    def train_fedavg_population(self, params_list: Sequence[Params], keys,
                                client_ids, lr: float,
                                survivors=None) -> List[Params]:
        with self.telemetry.span("fill_train"):
            return self.inner.train_fedavg_population(
                params_list, keys, client_ids, lr, survivors=survivors)

    def eval_shared(self, params: Params, keys, client_ids,
                    survivors=None) -> np.ndarray:
        with self.telemetry.span("eval"):
            return self.inner.eval_shared(params, keys, client_ids,
                                          survivors=survivors)

    def eval_paired(self, params_list: Sequence[Params], keys,
                    client_ids, survivors=None) -> np.ndarray:
        with self.telemetry.span("eval"):
            return self.inner.eval_paired(params_list, keys, client_ids,
                                          survivors=survivors)
