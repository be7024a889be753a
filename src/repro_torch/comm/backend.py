"""CodecBackend: encode→decode applied around the execution backend.

The execution backend answers *how* client work is dispatched; this
wrapper answers *what crosses the wire* around those dispatches,
uniformly for every strategy:

  * **downlink** — every parameter tree a client receives (the master a
    round trains from / evaluates, the per-individual inits of the
    offline baseline) is replaced by its ``downlink.roundtrip`` — the
    reconstruction of the compressed broadcast.
  * **uplink** — the aggregated master update (what the fill-aggregated
    uploads change about the master, ``raw - sent_down``) is replaced by
    its error-feedback-compressed reconstruction
    (``repro_torch.comm.error_feedback``): persistent-model paths
    (``train_fill``, Algorithm 3; ``train_fedavg``, Algorithm 1) carry a
    per-stream residual so the lossy uplink stays unbiased over rounds;
    the offline baseline's per-round reinitialized individuals are
    ephemeral, so their updates get a plain (residual-free) roundtrip.

Compression is simulated at the aggregate boundary — per-client wire
*bytes* are still charged per upload by the strategies' ``CommStats``
accounting, but the information loss is applied once to the aggregated
update, a deterministic function of the aggregate.

The wrapper implements the whole execution-backend protocol (and
proxies ``dispatches``), so ``FedEngine`` treats it as just another
backend; it is only constructed when at least one codec is not
``"none"``, so codec-free runs take the exact path without it.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch.comm.codec import PayloadCodec
from repro_torch.comm.error_feedback import ErrorFeedback, _tree_add, \
    _tree_sub
from repro_torch.obs import NULL_TELEMETRY

Params = Any


class CodecBackend:
    """Wrap ``inner`` with uplink/downlink payload codecs."""

    # shared no-op unless FedEngine attaches a real Telemetry (obs)
    telemetry = NULL_TELEMETRY

    def __init__(self, inner, uplink: PayloadCodec, downlink: PayloadCodec):
        self.inner = inner
        self.uplink = uplink
        self.downlink = downlink
        self._ef = {"fill": ErrorFeedback(uplink),
                    "fedavg": ErrorFeedback(uplink)}

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
        """Drop error-feedback residuals (``FedEngine.run`` re-entrancy)."""
        for ef in self._ef.values():
            ef.reset()

    # -- codec application ---------------------------------------------------

    def _down(self, params: Params) -> Params:
        # telemetry "codec_decode": the downlink roundtrip — what every
        # client reconstructs from the compressed broadcast (nests under
        # fill_train/eval when the InstrumentedBackend wraps this one)
        with self.telemetry.span("codec_decode"):
            return self.downlink.roundtrip(params)

    def _up(self, sent_down: Params, raw: Params,
            stream: Optional[str] = None) -> Params:
        """Receiver-side master after the uplink codec: ``sent_down`` plus
        the (EF-)compressed reconstruction of ``raw - sent_down``.
        ``stream`` names the error-feedback residual to carry; ``None``
        (ephemeral models) compresses without a residual."""
        if self.uplink.is_identity:
            return raw
        # telemetry "codec_encode": the (error-feedback) uplink
        # compression of the aggregated update
        with self.telemetry.span("codec_encode"):
            delta = _tree_sub(raw, sent_down)
            sent = self._ef[stream].step(delta) if stream is not None \
                else self.uplink.roundtrip(delta)
            new = _tree_add(sent_down, sent)
            return {k: v.to(raw[k].dtype) for k, v in new.items()}

    # -- execution-backend protocol ------------------------------------------

    def train_fill(self, master: Params, keys, groups, lr: float,
                   survivors=None) -> Params:
        m_down = self._down(master)
        raw = self.inner.train_fill(m_down, keys, groups, lr,
                                    survivors=survivors)
        return self._up(m_down, raw, "fill")

    def train_fedavg(self, params: Params, key, client_ids,
                     lr: float, survivors=None) -> Params:
        p_down = self._down(params)
        raw = self.inner.train_fedavg(p_down, key, client_ids, lr,
                                      survivors=survivors)
        return self._up(p_down, raw, "fedavg")

    def train_fedavg_population(self, params_list: Sequence[Params], keys,
                                client_ids, lr: float,
                                survivors=None) -> List[Params]:
        downs = [self._down(p) for p in params_list]
        raws = self.inner.train_fedavg_population(downs, keys, client_ids,
                                                  lr, survivors=survivors)
        return [self._up(d, r, stream=None) for d, r in zip(downs, raws)]

    def eval_shared(self, params: Params, keys, client_ids,
                    survivors=None) -> np.ndarray:
        return self.inner.eval_shared(self._down(params), keys, client_ids,
                                      survivors=survivors)

    def eval_paired(self, params_list: Sequence[Params], keys,
                    client_ids, survivors=None) -> np.ndarray:
        return self.inner.eval_paired([self._down(p) for p in params_list],
                                      keys, client_ids, survivors=survivors)
