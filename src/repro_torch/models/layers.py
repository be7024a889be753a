"""Primitive layers of the language models (plain functions over tensors).

Parameters are nested dicts of tensors with the JAX package's names and
layouts: a dense ``w`` is ``(d_in, d_out)`` and ``x @ w`` applies it.
Every layer is a pair of an ``*_init`` taking an explicit
``torch.Generator`` (its device is the parameters' device) and an apply
function.  The numerics follow the JAX package: RMSNorm in float32, RoPE
on interleaved pairs in float32, sinusoidal positions in float32, GELU in
its tanh approximation.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def uniform_init(gen: torch.Generator, shape, scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """U(-scale, scale) drawn in float32, then cast to ``dtype``."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, with_bias=False) -> Params:
    p = {"w": uniform_init(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
    if with_bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d, dtype, device) -> Params:
    return {"g": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["g"].float()).to(dt)


def embedding_init(gen, vocab, d, dtype) -> Params:
    return {"table": uniform_init(gen, (vocab, d), 0.02, dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-weights unembedding: logits over the vocabulary."""
    return x @ p["table"].t()


def sinusoidal_positions(seq_len: int, d: int, dtype=torch.float32,
                         offset: int = 0, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings (seq_len, d): the
    halves ``[sin | cos]`` of ``(offset + i) * exp(-ln(10000) 2j / d)``,
    computed in float32 and cast to ``dtype`` (so a sum with bf16 hidden
    states rounds as the JAX package's does).  ``offset`` is a host int
    (the decode position)."""
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)
           + float(offset))[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos * torch.exp(-math.log(10000.0) * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, style: str = "1d") -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    Rotates the interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` — all
    of the head dim (``1d``) or its first half (``2d``, chatglm) — in
    float32 and casts back to x's dtype.
    """
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "1d" else hd // 2
    freqs = rope_freqs(rot, theta, x.device)
    ang = positions[..., :, None].float() * freqs         # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rot == hd:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def mlp_init(gen, d_model, d_ff, dtype, gated=True) -> Dict[str, Params]:
    p = {"wi": dense_init(gen, d_model, d_ff, dtype),
         "wo": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(p, x: torch.Tensor, ff_mask: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """SwiGLU if ``wg`` is present, else GELU (tanh approximation, as
    ``jax.nn.gelu``).  ``ff_mask`` (d_ff,) optionally zeroes hidden units
    (the supernet's bottleneck branch)."""
    h = dense(p["wi"], x)
    if "wg" in p:
        h = F.silu(dense(p["wg"], x)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    if ff_mask is not None:
        h = h * ff_mask.to(h.dtype)
    return dense(p["wo"], h)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in float32; labels == ignore_id are
    masked."""
    logits = logits.float()
    mask = labels != ignore_id
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def fused_cross_entropy(h: torch.Tensor, table: torch.Tensor,
                        labels: torch.Tensor, ignore_id: int = -1,
                        chunk: int = 8192) -> torch.Tensor:
    """Unembed + mean token cross-entropy over chunks of ``chunk``
    tokens, never the whole (B, S, V) logits: each chunk's logits are
    reduced to its summed NLL and token count, and recomputed in the
    backward pass (non-reentrant ``torch.utils.checkpoint``), so at most
    one chunk x V of them is live.  The product runs in the parameters'
    dtype and is cast to float32, as the JAX package's.

    h: (B, S, d); table: (V, d); labels: (B, S).  The tail is padded to
    whole chunks with ``ignore_id``.
    """
    from torch.utils.checkpoint import checkpoint

    b, s, d = h.shape
    t = b * s
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    x = h.reshape(t, d)
    y = labels.reshape(t)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=ignore_id)

    def chunk_nll(xc, yc):
        logits = (xc @ table.t()).float()
        mask = yc != ignore_id
        safe = torch.where(mask, yc, torch.zeros_like(yc)).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[:, None])[:, 0]
        return ((logz - gold) * mask).sum(), mask.sum()

    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        c_nll, c_cnt = checkpoint(chunk_nll, x[sl], y[sl],
                                  use_reentrant=False)
        nll = nll + c_nll
        cnt = cnt + c_cnt
    return nll / torch.clamp(cnt, min=1)
