"""Mamba2 (SSD, state-space duality) block, with the JAX package's names
and layouts.

The sequence is processed in chunks of ``CHUNK`` steps (arXiv:2405.21060):
within a chunk the recurrence is a (Q x Q) semiseparable matrix product,
across chunks a small recurrence carries the (H, P, N) state.  The chunk
scan takes one of two routes: ``backend="kernel"`` (the default) is
``kernels.ops.ssd_scan`` (kernel K4 on a CUDA tensor, its plain version
on the CPU) and ``backend="torch"`` is the chunked einsum path below (the
JAX package's ``"xla"``), written as pairwise products so that no
(b, c, q, k, h, p) intermediate appears.  ``backend="chunked"`` (an
attention route) takes the einsum path too, as the JAX package's scan
takes its own for every route but ``"pallas"``.  Projections are separate dense
layers (z / x / B / C / dt), as in the JAX package.

Decode is the O(1) recurrent update: S <- exp(dt A) S + dt B ⊗ x.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    dense, dense_init, rmsnorm, rmsnorm_init, uniform_init,
)

CHUNK = 128


def ssm_init(gen, cfg):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt, dev = cfg.torch_dtype, gen.device
    cw = 1.0 / math.sqrt(cfg.ssm_conv)

    def conv(c):
        return {"w": uniform_init(gen, (cfg.ssm_conv, c), cw, dt),
                "b": torch.zeros(c, dtype=dt, device=dev)}

    return {
        "z_proj": dense_init(gen, d, di, dt),
        "x_proj": dense_init(gen, d, di, dt),
        "b_proj": dense_init(gen, d, n, dt),
        "c_proj": dense_init(gen, d, n, dt),
        "dt_proj": dense_init(gen, d, h, dt),
        "conv_x": conv(di),
        "conv_b": conv(n),
        "conv_c": conv(n),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=dev),
        "D": torch.ones(h, dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(di, dt, dev),
        "out_proj": dense_init(gen, di, d, dt),
    }


def _causal_conv(x: torch.Tensor, conv) -> torch.Tensor:
    """Depthwise causal conv over the sequence as K shifted adds in x's
    dtype (as the JAX package: a library convolution sums bf16 in
    another order).  x: (B, S, C)."""
    w, b = conv["w"], conv["b"]
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = None
    for i in range(k):
        piece = pad[:, i: i + s, :] * w[i]
        out = piece if out is None else out + piece
    return F.silu(out + b)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Log-space segment sums: out[..., i, j] = sum_{j<m<=i} a[..., m],
    -inf above the diagonal.  a: (..., Q) -> (..., Q, Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x, dt, a_head, b_mat, c_mat, chunk=CHUNK,
                initial_state: Optional[torch.Tensor] = None,
                backend="kernel"):
    """Chunked SSD scan.

    x: (B, S, H, P) head inputs; dt: (B, S, H) (after softplus); a_head:
    (H,) negative decay; b_mat, c_mat: (B, S, N) (one group).  Returns
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).  A
    length that is not a multiple of ``chunk`` is zero-padded with
    dt = 0 (no decay, no input: the state is unchanged) and y cut back.
    """
    kops.check_backend(backend)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    xs = (x * dt[..., None]).reshape(bsz, nc, chunk, h, p).float()
    a = (dt * a_head[None, None, :]).reshape(bsz, nc, chunk, h)  # log decay
    bm = b_mat.reshape(bsz, nc, chunk, n).float()
    cm = c_mat.reshape(bsz, nc, chunk, n).float()

    if backend == "kernel":       # "torch" and "chunked": the einsums
        y, final = kops.ssd_scan(xs, a, bm, cm, initial_state)
    else:
        y, final = ssd_chunked_torch(xs, a, bm, cm, initial_state)
    y = y.reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(x.dtype), final


def ssd_chunked_torch(xs, a, bm, cm, initial_state=None):
    """The chunked scan as einsums, on K4's layout: xs (B, NC, Q, H, P),
    a (B, NC, Q, H), bm and cm (B, NC, Q, N), float32 -> (y (B, NC, Q,
    H, P), final state (B, H, P, N)), from ``initial_state`` (zero if
    None).  The stages K4's kernels implement: the diagonal blocks
    ((C Bᵀ) ∘ L) X and each chunk's local final state in parallel over
    the chunks, a sequential pass over the chunks for the state entering
    each, then that state's share of the outputs."""
    bsz, nc, _, h, p = xs.shape
    n = bm.shape[-1]
    a_cum = torch.cumsum(a, dim=2)                        # (b, c, q, h)
    # 1) intra-chunk (diagonal blocks): ((C Bᵀ) ∘ L) X
    l_mat = torch.exp(segsum(a.transpose(-1, -2)))        # (b, c, h, q, k)
    cb = torch.einsum("bcqn,bckn->bcqk", cm, bm)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * l_mat, xs)
    # 2) per-chunk final states: Xᵀ (B ∘ decay)
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b, c, q, h)
    states = torch.einsum("bcqn,bcqhp->bchpn", bm,
                          xs * decay_states[..., None])
    # 3) inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(a_cum[:, :, -1, :])            # (b, c, h)
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xs.device) if initial_state is None
             else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b, c, h, p, n)
    # 4) state -> output within each chunk: (C Sᵀ) ∘ exp(a_cum)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cm, prev_states) \
        * torch.exp(a_cum)[..., None]
    return y_diag + y_off, carry


def ssm_forward(p, x, cfg, *, state_mask=None, head_mask=None,
                backend="kernel"):
    """Full-sequence Mamba2 block.  x: (B, S, d) -> (B, S, d).
    ``state_mask`` (N,) multiplies B before the scan and ``head_mask``
    (H,) the heads' outputs after it (the supernet's branch masks;
    outside the kernel on the kernel route, as the JAX package)."""
    bsz, s, _ = x.shape
    di, h, pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z = dense(p["z_proj"], x)
    x_in = _causal_conv(dense(p["x_proj"], x), p["conv_x"])
    b_mat = _causal_conv(dense(p["b_proj"], x), p["conv_b"])
    c_mat = _causal_conv(dense(p["c_proj"], x), p["conv_c"])
    dt = dense(p["dt_proj"], x)
    x_in = x_in.reshape(bsz, s, h, pd)
    if state_mask is not None:
        b_mat = b_mat * state_mask.to(b_mat.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a_head = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(x_in, dt, a_head, b_mat, c_mat, backend=backend)
    y = y + x_in.float() * p["D"][None, None, :, None]
    if head_mask is not None:
        y = y * head_mask.to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y)
    return dense(p["out_proj"], y)


def init_ssm_cache(batch, cfg, dtype, device) -> Dict[str, torch.Tensor]:
    di, n = cfg.d_inner, cfg.ssm_state
    k = cfg.ssm_conv - 1
    return {
        "conv_x": torch.zeros((batch, k, di), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, k, n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, k, n), dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
    }


def _conv_step(buf, xt, conv):
    """One-token depthwise conv against the rolling buffer.
    buf: (B, K-1, C), xt: (B, C) -> (out (B, C), new buf)."""
    w, b = conv["w"], conv["b"]
    full = torch.cat([buf, xt[:, None, :]], dim=1)          # (B, K, C)
    out = torch.einsum("bkc,kc->bc", full, w) + b
    return F.silu(out), full[:, 1:, :]


def ssm_decode_step(p, x, cache, cfg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent update.  x: (B, 1, d).  Returns (out (B, 1, d),
    the new cache)."""
    bsz = x.shape[0]
    di, h, pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]
    z = dense(p["z_proj"], x0)
    xt, new_cx = _conv_step(cache["conv_x"], dense(p["x_proj"], x0),
                            p["conv_x"])
    bt, new_cb = _conv_step(cache["conv_b"], dense(p["b_proj"], x0),
                            p["conv_b"])
    ct, new_cc = _conv_step(cache["conv_c"], dense(p["c_proj"], x0),
                            p["conv_c"])
    dt = dense(p["dt_proj"], x0)
    x_in = xt.reshape(bsz, h, pd)
    dt = F.softplus(dt.float() + p["dt_bias"])              # (B, H)
    a_head = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a_head[None, :])                  # (B, H)
    upd = (dt[:, :, None, None] * x_in.float()[:, :, :, None]
           * bt.float()[:, None, None, :])
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", ct.float(), state)
    y = y + x_in.float() * p["D"][None, :, None]
    y = y.reshape(bsz, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y)
    out = dense(p["out_proj"], y)[:, None, :]
    return out, {"conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc,
                 "state": state}
