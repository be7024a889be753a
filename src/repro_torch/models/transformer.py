"""Dense, MoE, SSM, hybrid, VLM and audio (encoder-decoder) language
model stacks: init, full-sequence forward, serving (cache init, prefill
by replay, single-token decode), and the paper's supernet over them.

Parameters are nested dicts of tensors with the JAX package's names and
per-layer layouts; where the JAX package stacks every per-layer leaf on a
leading ``L`` axis and scans over it, the port keeps ``params["layers"]``
(and the audio encoder's ``params["encoder"]``) as a list of per-layer
dicts and loops over it in Python (``convert.lm_params_from_reference``
carries weights across).

The VLM (internvl2) is a dense decoder whose ``forward`` takes a prefix of
stub patch embeddings, projected by ``params["proj"]`` (d x d, with bias)
and put before the tokens: positions and the causal mask run over prefix
+ tokens, and the logits cover the tokens only.  Its decode, as the JAX
package's, is the text-only decoder: ``prefill_cache`` takes no prefix
(ROADMAP queue 3).  The audio model (whisper) runs ``encode`` over a
prefix of stub frame embeddings (sinusoidal positions, bidirectional
``"enc"`` blocks with a GELU MLP, ``enc_ln``); its decoder layers
(``"encdec"``) add cross attention over the encoder output after self
attention, the tokens get sinusoidal positions (no RoPE), and its decode
cache keeps each layer's cross K/V (``cross_k`` / ``cross_v``), filled
once from the encoder output by ``prefill_cache(..., enc_out=)``.

The hybrid (zamba2) is a stack of SSM layers with one dense
attention+MLP block, ``params["shared"]``, applied after every
``attn_every``-th layer (0-based layer l with l % attn_every ==
attn_every - 1), also after a supernet layer that its key makes an
identity; in decode each application point keeps its own KV cache
(``cache["shared"][l // attn_every]``).

The supernet (``cfg.supernet``) follows the JAX package's choice blocks
adapted to transformers: per layer, 4 branches
  0: identity (layer skip)          1: full block
  2: bottleneck (d_ff masked to /2) 3: lite (half the query heads masked)
selected by an int choice key on the host.  Where the JAX package stacks
the 3 weighted branches of a layer on a second axis ``(L, 3, ...)``, the
port keeps ``params["layers"][l]`` as a list of 3 branch dicts (branch b
+ 1 at index b), and ``forward(..., choice_key=)`` runs the selected one
of each layer: an identity layer touches no parameter.  Decoding a
supernet raises, as there is no decode of one in the JAX package either.
``flat_params`` / ``nested_params`` name every leaf by its dotted path
(``layers.{l}.{b}.attn.wq.w``), the layout of the LM supernet's master.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    dense, dense_init, embed, embedding_init, mlp, mlp_init, rmsnorm,
    rmsnorm_init, sinusoidal_positions, unembed,
)

Params = Dict[str, Any]

N_BRANCHES = 3      # weighted branches per supernet layer (0 = identity)

# family -> the kind of its decoder layers
_LAYER_KINDS = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
                "hybrid": "ssm", "audio": "encdec"}


def _layer_kind(cfg: ModelConfig) -> str:
    if cfg.family not in _LAYER_KINDS:
        raise ValueError(f"{cfg.name}: not a language model "
                         f"(family {cfg.family!r})")
    return _LAYER_KINDS[cfg.family]


def _serving_kind(cfg: ModelConfig) -> str:
    kind = _layer_kind(cfg)
    if cfg.supernet:
        raise NotImplementedError(
            f"{cfg.name}: a supernet is not decoded (the LM supernet NAS "
            "path evaluates full sequences only, as the JAX package's); "
            "serve a subnet's weights as a plain model")
    return kind


def branch_masks(cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    """The supernet's static branch masks (bool): the first half of the
    MLP's hidden units (``ff``), of the query heads (``head``), of the
    experts' hidden units (``moe_ff``), of the SSM state (``state``) and
    of the SSM heads (``ssm_head``), where the config has them."""
    def half(n):
        return torch.arange(n, device=device) < n // 2

    m: Dict[str, torch.Tensor] = {}
    if cfg.d_ff:
        m["ff"] = half(cfg.d_ff)
    if cfg.num_heads:
        m["head"] = half(cfg.num_heads)
    if cfg.num_experts:
        m["moe_ff"] = half(cfg.moe_d_ff or cfg.d_ff)
    if cfg.ssm_state:
        m["state"] = half(cfg.ssm_state)
        m["ssm_head"] = half(cfg.ssm_heads)
    return m


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    """One block of ``kind``: ``dense`` or ``moe`` (attention, then a
    SwiGLU MLP or the experts), ``ssm``, ``enc`` (an encoder block:
    attention, then a GELU MLP) or ``encdec`` (a decoder block of the
    audio model: self attention, cross attention ``xattn`` without QKV
    bias, then a GELU MLP)."""
    d, dt, dev = cfg.d_model, cfg.torch_dtype, gen.device
    if kind == "ssm":
        return {"ln": rmsnorm_init(d, dt, dev),
                "ssm": ssm_mod.ssm_init(gen, cfg)}

    def attention(qkv_bias):
        return attn.attention_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.hd, dt, qkv_bias=qkv_bias)

    p = {"ln1": rmsnorm_init(d, dt, dev), "attn": attention(cfg.qkv_bias)}
    if kind == "encdec":
        p["lnx"] = rmsnorm_init(d, dt, dev)
        p["xattn"] = attention(False)
    p["ln2"] = rmsnorm_init(d, dt, dev)
    if kind == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dt, gated=kind == "dense")
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights from ``gen``, on its device, in the config's dtype
    (the JAX package's init distributions; not its random bits).  A
    supernet's layer is a list of ``N_BRANCHES`` blocks; the hybrid's
    shared block is one dense block, a supernet's too.  The VLM adds
    ``proj``, the audio model its encoder (``encoder``, a list of
    ``encoder_layers`` blocks, and ``enc_ln``)."""
    kind = _layer_kind(cfg)

    def layer():
        if cfg.supernet:
            return [block_init(gen, cfg, kind) for _ in range(N_BRANCHES)]
        return block_init(gen, cfg, kind)

    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                cfg.torch_dtype),
        "final_ln": rmsnorm_init(cfg.d_model, cfg.torch_dtype, gen.device),
        "layers": [layer() for _ in range(cfg.num_layers)],
    }
    if cfg.family == "hybrid":
        params["shared"] = block_init(gen, cfg, "dense")
    if cfg.family == "vlm":
        params["proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                    cfg.torch_dtype, with_bias=True)
    if cfg.family == "audio":
        params["encoder"] = [block_init(gen, cfg, "enc")
                             for _ in range(cfg.encoder_layers)]
        params["enc_ln"] = rmsnorm_init(cfg.d_model, cfg.torch_dtype,
                                        gen.device)
    return params


def _flatten_into(out: Dict[str, torch.Tensor], node, prefix: str) -> None:
    if isinstance(node, torch.Tensor):
        out[prefix[:-1]] = node
        return
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for k, v in items:
        _flatten_into(out, v, f"{prefix}{k}.")


def flat_params(params: Params) -> Dict[str, torch.Tensor]:
    """Nested params -> one ordered ``{dotted path: tensor}`` dict (the
    same tensors, no copies); a list's items are named by their index.
    (A module-level walk: a recursive closure over ``out`` would keep the
    dict, and every tensor in it, alive in a reference cycle until the
    garbage collector runs.)"""
    out: Dict[str, torch.Tensor] = {}
    _flatten_into(out, params, "")
    return out


def nested_params(flat: Dict[str, torch.Tensor]) -> Params:
    """Inverse of ``flat_params``: the nested dicts and lists (a level
    whose names are all integers is a list), holding the same tensors."""
    root: Dict[str, Any] = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _attn_kw(cfg: ModelConfig, window: int) -> Dict[str, Any]:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.hd, rope_style=cfg.rope_style,
                theta=cfg.rope_theta, window=window)


def _block_fwd(p_l, h, positions, cfg: ModelConfig, kind: str, window: int,
               backend: str, branch: int = 1,
               masks: Optional[Dict[str, torch.Tensor]] = None,
               enc_out: Optional[torch.Tensor] = None, causal: bool = True):
    """One layer: the full block (branch 1), or the supernet's bottleneck
    (2: the MLP's / experts' hidden units or the SSM state masked to
    half) or lite branch (3: half the attention or SSM heads) ->
    (h, the MoE aux loss or None).  An ``encdec`` layer attends to
    ``enc_out`` after its self attention; an encoder block is a
    ``dense`` one with ``causal=False``."""
    bottle, lite = branch == 2, branch == 3
    if kind in ("dense", "moe", "encdec"):
        h = h + attn.self_attention(
            p_l["attn"], rmsnorm(p_l["ln1"], h), positions, causal=causal,
            head_mask=masks["head"] if lite else None, backend=backend,
            **_attn_kw(cfg, window))
        if kind == "encdec":
            h = h + attn.cross_attention(
                p_l["xattn"], rmsnorm(p_l["lnx"], h),
                attn.encode_kv(p_l["xattn"], enc_out,
                               num_kv_heads=cfg.num_kv_heads),
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.hd)
        x = rmsnorm(p_l["ln2"], h)
        if kind == "moe":
            y, a = moe_mod.moe_apply(
                p_l["moe"], x, cfg,
                ff_mask=masks["moe_ff"] if bottle else None, backend=backend)
            return h + y, a
        return h + mlp(p_l["mlp"], x,
                       ff_mask=masks["ff"] if bottle else None), None
    return h + ssm_mod.ssm_forward(
        p_l["ssm"], rmsnorm(p_l["ln"], h), cfg,
        state_mask=masks["state"] if bottle else None,
        head_mask=masks["ssm_head"] if lite else None, backend=backend), None


def _shared_fires(cfg: ModelConfig, li: int) -> bool:
    """Whether the hybrid's shared block follows layer ``li``."""
    return (cfg.family == "hybrid"
            and li % cfg.attn_every == cfg.attn_every - 1)


def _layer_fwd(p_l, h, positions, cfg: ModelConfig, kind: str, window: int,
               backend: str, branch: int, masks, shared, enc_out):
    """Layer ``p_l`` on its branch (0: the identity), then the shared
    block ``shared`` where it is not None -> (h, the MoE aux loss or
    None)."""
    a = None
    if branch:
        h, a = _block_fwd(p_l, h, positions, cfg, kind, window, backend,
                          branch, masks, enc_out)
    if shared is not None:
        h = _block_fwd(shared, h, positions, cfg, "dense", window,
                       backend)[0]
    return h, a


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix: Optional[torch.Tensor] = None, choice_key=None,
            window: int = 0, backend: str = "kernel", remat: bool = False,
            return_hidden: bool = False, return_aux: bool = False):
    """Full-sequence forward.  tokens: (B, S) integers -> logits
    (B, S, V), or the final hidden states (B, S, d) with
    ``return_hidden``, over the token positions only.  ``prefix``, which
    the VLM and audio families need and the others refuse: (B, P, d)
    patch embeddings (VLM; projected by ``proj`` and put before the
    tokens) or (B, F, d) frame embeddings (audio; through ``encode`` on
    the same backend, without checkpoints).  With ``return_aux``, a pair
    of that and the MoE load-balance loss summed over the layers
    (float32; 0 for the other families), as the JAX package's forward
    returns it beside its optional cache.  ``backend`` routes attention, the SSD scan and the
    expert FFN.  A supernet needs ``choice_key``, one host int per layer:
    layer l runs branch ``choice_key[l]`` (0 skips it), from
    ``params["layers"][l][choice_key[l] - 1]``; only the selected
    branches are read (the others may be None).  The hybrid's shared
    block runs after its layers whatever their branch, unmasked.

    ``remat`` runs each decoder layer, with the shared block where it
    follows the layer, under non-reentrant ``torch.utils.checkpoint``, so
    the backward pass recomputes its activations (the JAX package's
    ``jax.checkpoint`` of its scan body), on the plain stack and on a
    supernet's selected branches alike.  An audio supernet raises
    ``ValueError``, as the JAX package's branch functions do for its
    layers.  The JAX package's ``unroll`` (an option of its layer scan)
    has no counterpart in this Python loop."""
    kind = _layer_kind(cfg)
    kops.check_backend(backend)
    if cfg.supernet and kind == "encdec":
        raise ValueError(f"{cfg.name}: a supernet of {kind!r} layers is "
                         "not supported (as in the JAX package)")
    b, s = tokens.shape
    h = embed(params["embed"], tokens)
    n_prefix, enc_out = 0, None
    if cfg.family in ("vlm", "audio"):
        if prefix is None:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} needs a "
                             "prefix")
        if cfg.family == "vlm":
            h = torch.cat([dense(params["proj"], prefix.to(h.dtype)), h],
                          dim=1)
            n_prefix = prefix.shape[1]
        else:
            enc_out = encode(params, cfg, prefix, backend=backend)
            h = h + sinusoidal_positions(s, cfg.d_model, h.dtype,
                                         device=h.device)[None]
    elif prefix is not None:
        raise ValueError(f"{cfg.name}: prefix given to a model of family "
                         f"{cfg.family!r}")
    total = h.shape[1]
    positions = torch.arange(total, dtype=torch.int32,
                             device=h.device).expand(b, total)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.supernet:
        if choice_key is None:
            raise ValueError(f"{cfg.name}: a supernet's forward needs a "
                             "choice_key")
        key = np.asarray(choice_key).reshape(-1).tolist()
        if len(key) != cfg.num_layers or not all(0 <= k <= N_BRANCHES
                                                 for k in key):
            raise ValueError(f"{cfg.name}: choice key {key}: need "
                             f"{cfg.num_layers} branches in 0..{N_BRANCHES}")
        masks = branch_masks(cfg, h.device)
        layers = [(p_l[k - 1] if k else None, k)
                  for p_l, k in zip(params["layers"], key)]
    else:
        if choice_key is not None:
            raise ValueError(f"{cfg.name}: choice_key given to a model that "
                             "is not a supernet")
        masks = None
        layers = [(p_l, 1) for p_l in params["layers"]]
    layer = _layer_fwd
    if remat:
        def layer(*args):
            return checkpoint(_layer_fwd, *args, use_reentrant=False)
    for li, (p_l, branch) in enumerate(layers):
        shared = params["shared"] if _shared_fires(cfg, li) else None
        if not branch and shared is None:
            continue
        h, a = layer(p_l, h, positions, cfg, kind, window, backend,
                     branch, masks, shared, enc_out)
        if a is not None:
            aux = aux + a
    h = rmsnorm(params["final_ln"], h)[:, n_prefix:]
    out = h if return_hidden else unembed(params["embed"], h)
    return (out, aux) if return_aux else out


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           backend: str = "kernel") -> torch.Tensor:
    """The audio model's encoder: (B, F, d) stub frame embeddings, cast
    to the config's dtype, plus sinusoidal positions, through the
    ``encoder`` blocks, each bidirectional on ``backend`` (K3 with
    ``causal=False`` on the kernel route), then ``enc_ln`` -> (B, F,
    d)."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no "
                         "encoder")
    kops.check_backend(backend)
    h = frames.to(cfg.torch_dtype)
    b, f, _ = h.shape
    h = h + sinusoidal_positions(f, cfg.d_model, h.dtype,
                                 device=h.device)[None]
    positions = torch.arange(f, dtype=torch.int32,
                             device=h.device).expand(b, f)
    for p_l in params["encoder"]:
        h = _block_fwd(p_l, h, positions, cfg, "dense", 0, backend,
                       causal=False)[0]
    return rmsnorm(params["enc_ln"], h)


def init_cache(params: Params, cfg: ModelConfig, batch: int,
               cache_len: int, enc_len: int = 0) -> Params:
    """An empty decode cache: ``t`` (the next position, a host int) and
    one KV ring (dense, moe, vlm, audio) or conv/state record (ssm,
    hybrid) per layer; the audio model's rings also hold the layer's
    cross K/V, ``cross_k`` / ``cross_v`` (zeros of (B, enc_len, Kh,
    D)); the hybrid's cache also one KV ring per application point of
    its shared block (``"shared"``)."""
    kind = _serving_kind(cfg)
    dt = cfg.torch_dtype
    dev = params["embed"]["table"].device

    def kv():
        return attn.init_cache(batch, cfg.num_kv_heads, cfg.hd, cache_len,
                               dt, dev)

    if kind in ("dense", "moe"):
        layers = [kv() for _ in range(cfg.num_layers)]
    elif kind == "encdec":
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.hd)
        layers = [{**kv(), "cross_k": torch.zeros(shape, dtype=dt,
                                                  device=dev),
                   "cross_v": torch.zeros(shape, dtype=dt, device=dev)}
                  for _ in range(cfg.num_layers)]
    else:
        layers = [ssm_mod.init_ssm_cache(batch, cfg, dt, dev)
                  for _ in range(cfg.num_layers)]
    cache = {"t": 0, "layers": layers}
    if cfg.family == "hybrid":
        cache["shared"] = [kv() for _ in
                           range(cfg.num_layers // cfg.attn_every)]
    return cache


def prefill_cache(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  window: int = 0, cache_len: int = 0,
                  enc_out: Optional[torch.Tensor] = None) -> Params:
    """Build a decode cache by replaying the sequence through
    ``decode_step``, as the JAX package's reference path does (no kernel
    runs).  The audio model needs ``enc_out`` (``encode``'s output),
    from which each layer's cross K/V is computed once, first.  It takes
    no prefix: a VLM's cache holds the tokens alone, as the JAX
    package's (which ignores the prefix it is given)."""
    b, s = tokens.shape
    if (enc_out is not None) != (_layer_kind(cfg) == "encdec"):
        raise ValueError(f"{cfg.name}: enc_out is for the audio family, "
                         "which needs it")
    cache = init_cache(params, cfg, b, cache_len or s,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    if enc_out is not None:
        for p_l, c_l in zip(params["layers"], cache["layers"]):
            c_l["cross_k"], c_l["cross_v"] = attn.encode_kv(
                p_l["xattn"], enc_out, num_kv_heads=cfg.num_kv_heads)
    for i in range(s):
        _, cache = decode_step(params, cfg, tokens[:, i:i + 1], cache,
                               window=window)
    return cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, window: int = 0
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B, 1) -> (logits (B, 1, V), cache).  The
    cache is updated in place (KV slots, per-layer records, the hybrid's
    per application point, ``t``) and returned.  No kernel launches:
    attention (self and cross) reads the cache with einsums, and the MoE
    takes its torch route (routing over the B tokens of the step).  The
    audio model's token gets the sinusoid of position ``t``."""
    kind = _serving_kind(cfg)
    t = cache["t"]
    h = embed(params["embed"], token)
    if cfg.family == "audio":
        h = h + sinusoidal_positions(1, cfg.d_model, h.dtype, offset=t,
                                     device=h.device)[None]
    for li, p_l in enumerate(params["layers"]):
        c_l = cache["layers"][li]
        if kind in ("dense", "moe", "encdec"):
            y, c_l = attn.decode_self_attention(
                p_l["attn"], rmsnorm(p_l["ln1"], h), c_l, t,
                **_attn_kw(cfg, window))
            h = h + y
            if kind == "encdec":
                h = h + attn.cross_attention(
                    p_l["xattn"], rmsnorm(p_l["lnx"], h),
                    (c_l["cross_k"], c_l["cross_v"]),
                    num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.hd)
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
        if _shared_fires(cfg, li):
            sh = params["shared"]
            y, _ = attn.decode_self_attention(
                sh["attn"], rmsnorm(sh["ln1"], h),
                cache["shared"][li // cfg.attn_every], t,
                **_attn_kw(cfg, window))
            h = h + y
            h = h + mlp(sh["mlp"], rmsnorm(sh["ln2"], h))
    h = rmsnorm(params["final_ln"], h)
    cache["t"] = t + 1
    return unembed(params["embed"], h), cache
