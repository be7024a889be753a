"""Server-side error feedback for lossy uplink codecs.

Lossy compressors are biased (top-k systematically, int8/cast by
rounding); applied round after round to Algorithm 3's master update the
bias would accumulate.  Error feedback (Seide et al. 2014; Karimireddy
et al. 2019) carries the compression error forward:

    sent_t     = C(delta_t + residual_{t-1})
    residual_t = (delta_t + residual_{t-1}) - sent_t

so the applied updates *telescope*:

    sum_t sent_t = sum_t delta_t + residual_0 - residual_T

— the cumulative applied update differs from the cumulative true update
by exactly the final residual, a single-step compression error that does
not grow with T.

The residual lives on the *server*, in float32 on the master's device:
clients are ephemeral (double sampling redraws the client groups every
round), so the one persistent place compression error can be carried is
around the aggregated master update, where
``repro_torch.comm.backend.CodecBackend`` applies ``step``.
"""
from __future__ import annotations

import torch

from repro_torch.comm.codec import PayloadCodec, tree_map_float


def _zeros_like_float(tree):
    return tree_map_float(
        lambda x: torch.zeros(x.shape, dtype=torch.float32,
                              device=x.device), tree)


def _float_op(op):
    """Elementwise float32 op on floating leaves; non-float leaves (none
    in the current master trees) pass the first argument through."""
    def tree_op(a, b):
        return {k: op(x.float(), b[k].float()) if x.is_floating_point()
                else x for k, x in a.items()}

    return tree_op


_tree_add = _float_op(torch.add)
_tree_sub = _float_op(torch.sub)


class ErrorFeedback:
    """One compression stream's residual state (reset per ``run()``)."""

    def __init__(self, codec: PayloadCodec):
        self.codec = codec
        self.residual = None

    def reset(self) -> None:
        self.residual = None

    def step(self, delta):
        """Compress ``delta`` with the carried residual folded in; update
        the residual; return what the receiver reconstructs."""
        if self.codec.is_identity:
            return delta
        if self.residual is None:
            self.residual = _zeros_like_float(delta)
        target = _tree_add(delta, self.residual)
        sent = self.codec.roundtrip(target)
        self.residual = _tree_sub(target, sent)
        return sent
