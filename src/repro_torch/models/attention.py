"""Grouped-query attention of the language models.

Supports GQA (num_kv_heads <= num_heads), RoPE 1d / 2d / none, optional
QKV bias, causal, sliding-window or bidirectional (an encoder's) masks,
cross attention over precomputed encoder K/V (whisper), single-token
decode against a (ring-buffered) KV cache, and a per-head mask for the
supernet's lite branch, with the JAX package's names and layouts.

The softmax(QKᵀ)V core of a full sequence takes one of three routes:
``backend="kernel"`` (the default) is ``kernels.ops.flash_attention``
(kernel K3 on a CUDA tensor, its plain version on the CPU),
``backend="torch"`` is the einsum path ``_attend`` (the JAX package's
``"xla"``) and ``backend="chunked"`` is ``_attend_chunked``, the same
einsums over blocks of queries, each recomputed in the backward pass, so
that only a chunk x T score tile is live.  Cross attention always takes
``_attend``, as in the JAX package; so does decode, but under a
registered mesh whose ``model`` axis divides the head dim
(``launch.policy.set_mesh``), where decode takes
``_attend_decode_pinned``: the JAX package's decode path for its
sharded cache layout, whose probabilities are rounded to V's dtype
before the product with V (in bf16 its logits differ from ``_attend``'s
by a few 1e-3).  The JAX package's sharding hints with no effect on any
value (``_maybe_shard_kv_seq``, and the pins themselves) have no
counterpart in one process.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.launch import policy
from repro_torch.models.layers import apply_rope, dense, dense_init

NEG_INF = -1e30


def attention_init(gen, d_model, num_heads, num_kv_heads, head_dim, dtype,
                   qkv_bias=False):
    return {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, qkv_bias),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         qkv_bias),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         qkv_bias),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _attend(q, k, v, mask, head_mask=None):
    """q: (B, S, H, D); k, v: (B, T, Kh, D); mask: (B|1, S, T) bool ->
    (B, S, H*D) in v's dtype.  Scores, softmax and the weighted sum in
    float32; K/V repeated to the H query heads; ``head_mask`` (H,)
    optionally zeroes heads' outputs (the supernet's lite branch)."""
    b, s, h, d = q.shape
    k, v = _repeat_kv(k, v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    if head_mask is not None:
        out = out * head_mask.to(out.dtype)[None, None, :, None]
    return out.reshape(b, s, h * d).to(v.dtype)


def _repeat_kv(k, v, h):
    kh = k.shape[2]
    if kh != h:
        k = torch.repeat_interleave(k, h // kh, dim=2)
        v = torch.repeat_interleave(v, h // kh, dim=2)
    return k, v


def _attend_chunked(q, k, v, *, causal=True, window=0, chunk=512,
                    head_mask=None):
    """``_attend`` over blocks of ``chunk`` queries, so that only a
    (chunk x T) float32 score tile is live at once; each block runs under
    non-reentrant ``torch.utils.checkpoint`` when grad mode is on, so the
    backward pass recomputes its tile (the JAX package's
    ``jax.checkpoint``).  q: (B, S, H, D); k, v: (B, T, Kh, D) -> (B, S,
    H*D) in v's dtype.  Scores of the model-dtype q and k in float32,
    softmax in float32, the probabilities rounded to v's dtype before the
    product with v, accumulated in float32 (the JAX package's
    ``preferred_element_type``).  q is zero-padded to whole blocks and
    the padded rows dropped.  Query i sits at position i + T - S, also
    in a padded last block (the JAX package shifts every query by the
    padding there, ROADMAP queue 3)."""
    b, s, h, d = q.shape
    k, v = _repeat_kv(k, v, h)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    t_len = k.shape[1]
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(t_len, device=q.device)
    scale = 1.0 / math.sqrt(d)

    def block(qc, start):
        q_pos = start + torch.arange(chunk, device=q.device) + (t_len - s)
        m = torch.ones((chunk, t_len), dtype=torch.bool, device=q.device)
        if causal:
            m = m & (k_pos[None, :] <= q_pos[:, None])
        if window:
            m = m & (k_pos[None, :] > q_pos[:, None] - window)
        sc = torch.einsum("bchd,bthd->bhct", qc.float(), kf) * scale
        sc = torch.where(m[None, None], sc, torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        return torch.einsum("bhct,bthd->bchd", p.to(v.dtype).float(), vf)

    grad = torch.is_grad_enabled()
    outs = []
    for start in range(0, s + pad, chunk):
        qc = q[:, start:start + chunk]
        outs.append(checkpoint(block, qc, start, use_reentrant=False)
                    if grad else block(qc, start))
    out = torch.cat(outs, dim=1)[:, :s]
    if head_mask is not None:
        out = out * head_mask.to(out.dtype)[None, None, :, None]
    return out.reshape(b, s, h * d).to(v.dtype)


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    """(1, S, S) bool: key j visible from query i when j <= i (and
    j > i - window)."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    return m[None]


def self_attention(p, x, positions, *, num_heads, num_kv_heads, head_dim,
                   rope_style="1d", theta=10000.0, causal=True, window=0,
                   head_mask=None, backend="kernel"):
    """Full-sequence self attention (train / prefill), causal or, with
    ``causal=False``, bidirectional (an encoder's: every key visible on
    every route).  x: (B, S, d).  ``head_mask`` (H,) zeroes heads'
    outputs after the softmax(QKᵀ)V core, outside the kernel on the
    kernel route, as the JAX package does."""
    kops.check_backend(backend)
    q = _split_heads(dense(p["wq"], x), num_heads)
    k = _split_heads(dense(p["wk"], x), num_kv_heads)
    v = _split_heads(dense(p["wv"], x), num_kv_heads)
    q = apply_rope(q, positions, theta, rope_style)
    k = apply_rope(k, positions, theta, rope_style)
    b, s = x.shape[:2]
    if backend == "kernel":
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
        if head_mask is not None:
            out = out * head_mask.to(out.dtype)[None, None, :, None]
        out = out.reshape(b, s, num_heads * head_dim)
    elif backend == "chunked":
        out = _attend_chunked(q, k, v, causal=causal, window=window,
                              head_mask=head_mask)
    else:
        mask = causal_mask(s, window=window, device=x.device) if causal \
            else torch.ones((1, s, s), dtype=torch.bool, device=x.device)
        out = _attend(q, k, v, mask, head_mask)
    return dense(p["wo"], out)


def cross_attention(p, x, enc_kv, *, num_heads, num_kv_heads, head_dim,
                    head_mask=None):
    """Decoder -> encoder attention.  x: (B, S, d); ``enc_kv`` = (k, v)
    precomputed from the encoder output (``encode_kv``), each (B, T_enc,
    Kh, D); every key visible.  Always ``_attend``, on every backend, as
    in the JAX package (K3 needs as many keys as queries)."""
    q = _split_heads(dense(p["wq"], x), num_heads)
    k, v = enc_kv
    mask = torch.ones((1, x.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return dense(p["wo"], _attend(q, k, v, mask, head_mask))


def encode_kv(p, enc_out, *, num_kv_heads):
    """Cross-attention K/V from the encoder output (once per request):
    (B, T_enc, d) -> two (B, T_enc, Kh, D)."""
    return (_split_heads(dense(p["wk"], enc_out), num_kv_heads),
            _split_heads(dense(p["wv"], enc_out), num_kv_heads))


def init_cache(batch, num_kv_heads, head_dim, cache_len, dtype,
               device) -> Dict[str, torch.Tensor]:
    """KV cache of one layer.  ``pos`` holds the absolute position stored
    in each slot (-1 = empty), so the same code serves a full cache and a
    sliding-window ring buffer."""
    return {
        "k": torch.zeros((batch, cache_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32,
                          device=device),
    }


def decode_self_attention(p, x, cache, t: int, *, num_heads, num_kv_heads,
                          head_dim, rope_style="1d", theta=10000.0, window=0
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); t: the absolute position (a host
    int).  Writes slot ``t % cache_len`` (a ring buffer when cache_len is
    below the sequence length) of ``cache`` in place, where the JAX
    package returns an updated copy, and returns it."""
    q = _split_heads(dense(p["wq"], x), num_heads)
    k = _split_heads(dense(p["wk"], x), num_kv_heads)
    v = _split_heads(dense(p["wv"], x), num_kv_heads)
    pos = torch.full((x.shape[0], 1), t, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, theta, rope_style)
    k = apply_rope(k, pos, theta, rope_style)
    slot = t % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = t
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= t)
    if window:
        valid = valid & (cpos > t - window)
    attend = _attend_decode_pinned if _pinned(head_dim) else _attend
    out = attend(q, cache["k"], cache["v"], valid[None, None, :])
    return dense(p["wo"], out), cache


def _pinned(head_dim: int) -> bool:
    """Whether decode takes the JAX package's pinned path
    (``_hd_sharding``'s condition): a registered mesh with a ``model``
    axis that divides the head dim."""
    mesh = policy.get_mesh()
    return (mesh is not None and "model" in mesh.axis_names
            and head_dim % mesh.shape["model"] == 0)


def _attend_decode_pinned(q, k, v, mask):
    """Decode attention as the JAX package computes it on its sharded
    cache: float32 scores of the input-dtype q and k, the softmax in
    float32, the probabilities rounded to V's dtype, then P·V accumulated
    in float32 and cast to V's dtype.  q: (B, S, H, D); k, v: (B, T, Kh,
    D); mask: (B|1, S, T) -> (B, S, H*D).  In float32 it equals
    ``_attend``."""
    b, s, h, d = q.shape
    k, v = _repeat_kv(k, v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, s, h * d).to(v.dtype)
