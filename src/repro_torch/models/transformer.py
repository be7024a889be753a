"""Dense, MoE and SSM language-model stacks: init, full-sequence forward,
and serving (cache init, prefill by replay, single-token decode).

Parameters are nested dicts of tensors with the JAX package's names and
per-layer layouts; where the JAX package stacks every per-layer leaf on a
leading ``L`` axis and scans over it, the port keeps ``params["layers"]``
as a list of per-layer dicts and loops over it in Python
(``convert.lm_params_from_reference`` carries weights across).  Only the
``dense``, ``moe`` and ``ssm`` families without the supernet are
ported: the others raise, naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    embed, embedding_init, mlp, mlp_init, rmsnorm, rmsnorm_init, unembed,
)

Params = Dict[str, Any]

_NOT_PORTED = {
    "hybrid": "ROADMAP queue 1: the hybrid family (zamba2)",
    "vlm": "ROADMAP queue 1: VLM and audio",
    "audio": "ROADMAP queue 1: VLM and audio",
}


def _layer_kind(cfg: ModelConfig) -> str:
    if cfg.family not in ("dense", "moe", "ssm", *_NOT_PORTED):
        raise ValueError(f"{cfg.name}: not a language model "
                         f"(family {cfg.family!r})")
    if cfg.supernet:
        raise NotImplementedError(
            f"{cfg.name}: the LM supernet is not yet ported to repro_torch "
            "(ROADMAP queue 1: the LM supernet NAS path)")
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not yet ported to "
            f"repro_torch ({_NOT_PORTED[cfg.family]})")
    return cfg.family


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    d, dt, dev = cfg.d_model, cfg.torch_dtype, gen.device
    if kind in ("dense", "moe"):
        return {"ln1": rmsnorm_init(d, dt, dev),
                "attn": attn.attention_init(
                    gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.hd, dt,
                    qkv_bias=cfg.qkv_bias),
                "ln2": rmsnorm_init(d, dt, dev),
                **({"moe": moe_mod.moe_init(gen, cfg)} if kind == "moe"
                   else {"mlp": mlp_init(gen, d, cfg.d_ff, dt)})}
    return {"ln": rmsnorm_init(d, dt, dev),
            "ssm": ssm_mod.ssm_init(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights from ``gen``, on its device, in the config's dtype
    (the JAX package's init distributions; not its random bits)."""
    kind = _layer_kind(cfg)
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                cfg.torch_dtype),
        "final_ln": rmsnorm_init(cfg.d_model, cfg.torch_dtype, gen.device),
        "layers": [block_init(gen, cfg, kind)
                   for _ in range(cfg.num_layers)],
    }


def _attn_kw(cfg: ModelConfig, window: int) -> Dict[str, Any]:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.hd, rope_style=cfg.rope_style,
                theta=cfg.rope_theta, window=window)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            window: int = 0, backend: str = "kernel",
            return_hidden: bool = False, return_aux: bool = False):
    """Full-sequence forward.  tokens: (B, S) integers -> logits
    (B, S, V), or the final hidden states (B, S, d) with
    ``return_hidden``; with ``return_aux``, a pair of that and the MoE
    load-balance loss summed over the layers (float32; 0 for the other
    families), as the JAX package's forward returns it beside its
    optional cache.  ``backend`` routes attention, the SSD scan and the
    expert FFN."""
    kind = _layer_kind(cfg)
    kops.check_backend(backend)
    b, s = tokens.shape
    h = embed(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p_l in params["layers"]:
        if kind in ("dense", "moe"):
            h = h + attn.self_attention(p_l["attn"], rmsnorm(p_l["ln1"], h),
                                        positions, backend=backend,
                                        **_attn_kw(cfg, window))
            if kind == "moe":
                y, a = moe_mod.moe_apply(p_l["moe"], rmsnorm(p_l["ln2"], h),
                                         cfg, backend=backend)
                h, aux = h + y, aux + a
            else:
                h = h + mlp(p_l["mlp"], rmsnorm(p_l["ln2"], h))
        else:
            h = h + ssm_mod.ssm_forward(p_l["ssm"], rmsnorm(p_l["ln"], h),
                                        cfg, backend=backend)
    h = rmsnorm(params["final_ln"], h)
    out = h if return_hidden else unembed(params["embed"], h)
    return (out, aux) if return_aux else out


def init_cache(params: Params, cfg: ModelConfig, batch: int,
               cache_len: int) -> Params:
    """An empty decode cache: ``t`` (the next position, a host int) and
    one KV ring (dense, moe) or conv/state record (ssm) per layer."""
    kind = _layer_kind(cfg)
    dt = cfg.torch_dtype
    dev = params["embed"]["table"].device
    if kind in ("dense", "moe"):
        layers = [attn.init_cache(batch, cfg.num_kv_heads, cfg.hd, cache_len,
                                  dt, dev) for _ in range(cfg.num_layers)]
    else:
        layers = [ssm_mod.init_ssm_cache(batch, cfg, dt, dev)
                  for _ in range(cfg.num_layers)]
    return {"t": 0, "layers": layers}


def prefill_cache(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  window: int = 0, cache_len: int = 0) -> Params:
    """Build a decode cache by replaying the sequence through
    ``decode_step``, as the JAX package's reference path does (no kernel
    runs)."""
    b, s = tokens.shape
    cache = init_cache(params, cfg, b, cache_len or s)
    for i in range(s):
        _, cache = decode_step(params, cfg, tokens[:, i:i + 1], cache,
                               window=window)
    return cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, window: int = 0
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B, 1) -> (logits (B, 1, V), cache).  The
    cache is updated in place (KV slots, per-layer records, ``t``) and
    returned.  No kernel launches: attention reads the cache with
    einsums, and the MoE takes its torch route (routing over the B
    tokens of the step)."""
    kind = _layer_kind(cfg)
    t = cache["t"]
    h = embed(params["embed"], token)
    for li, p_l in enumerate(params["layers"]):
        c_l = cache["layers"][li]
        if kind in ("dense", "moe"):
            y, c_l = attn.decode_self_attention(
                p_l["attn"], rmsnorm(p_l["ln1"], h), c_l, t,
                **_attn_kw(cfg, window))
            h = h + y
            if kind == "moe":
                h = h + moe_mod.moe_apply(p_l["moe"], rmsnorm(p_l["ln2"], h),
                                          cfg, backend="torch")[0]
            else:
                h = h + mlp(p_l["mlp"], rmsnorm(p_l["ln2"], h))
        else:
            y, c_l = ssm_mod.ssm_decode_step(p_l["ssm"],
                                             rmsnorm(p_l["ln"], h), c_l, cfg)
            h = h + y
        cache["layers"][li] = c_l
    h = rmsnorm(params["final_ln"], h)
    cache["t"] = t + 1
    return unembed(params["embed"], h), cache
