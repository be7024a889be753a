"""Analytic FLOPs/MACs — the paper's second objective, plus the roofline
MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) terms.

Integer arithmetic, the JAX package's counts exactly: the CNN subnet's
MACs, and the transformer parameter counts per supernet branch that the
LM supernet's objective and payload are made of.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import cifar_supernet as cs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.cnn import BRANCH_NAMES


# ---------------------------------------------------------------------------
# CNN supernet MACs per choice key (paper objective 2; MAC convention, as in
# Table IV where ResNet18 = 0.5587 GMAC on 32x32 CIFAR)
# ---------------------------------------------------------------------------

def _conv_macs(h, w, cin, cout, k, stride=1, groups=1):
    ho, wo = h // stride, w // stride
    return ho * wo * cout * cin // groups * k * k


def cnn_branch_macs(name: str, h: int, w: int, cin: int, cout: int) -> int:
    red = cout != cin
    stride = 2 if red else 1
    if name == "identity":
        if not red:
            return 0
        return 2 * _conv_macs(h, w, cin, cout // 2, 1, 2)
    if name == "residual":
        return (_conv_macs(h, w, cin, cout, 3, stride)
                + _conv_macs(h // stride, w // stride, cout, cout, 3))
    if name == "inverted":
        hid = 4 * cin
        return (_conv_macs(h, w, cin, hid, 1)
                + _conv_macs(h, w, hid, hid, 3, stride, groups=hid)
                + _conv_macs(h // stride, w // stride, hid, cout, 1))
    if name == "sepconv":
        ho, wo = h // stride, w // stride
        return (_conv_macs(h, w, cin, cin, 3, stride, groups=cin)
                + _conv_macs(ho, wo, cin, cout, 1)
                + _conv_macs(ho, wo, cout, cout, 3, groups=cout)
                + _conv_macs(ho, wo, cout, cout, 1))
    raise ValueError(name)


def cnn_subnet_macs(key: np.ndarray, num_blocks: int = 12,
                    image: int = cs.IMAGE_SIZE) -> int:
    chans = cs.channels_for(num_blocks)
    cin = cs.stem_channels_for(num_blocks)
    h = w = image
    total = _conv_macs(h, w, 3, cin, 3)
    for i in range(num_blocks):
        cout = chans[i]
        total += cnn_branch_macs(BRANCH_NAMES[int(key[i])], h, w, cin, cout)
        if cout != cin:
            h, w = h // 2, w // 2
        cin = cout
    total += cin * cs.NUM_CLASSES
    return int(total)


# ---------------------------------------------------------------------------
# Transformer parameter counts and per-token FLOPs
# ---------------------------------------------------------------------------

def attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    return d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)


def mlp_params(cfg: ModelConfig, d_ff=None, gated=True) -> int:
    f = d_ff if d_ff is not None else cfg.d_ff
    return cfg.d_model * f * (3 if gated else 2)


def ssm_params(cfg: ModelConfig) -> int:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return (d * (2 * di + 2 * n + h)          # in_proj
            + cfg.ssm_conv * (di + 2 * n)     # conv
            + 3 * h + di                      # A_log, dt_bias, D, norm
            + di * d)                         # out_proj


def layer_params(cfg: ModelConfig, branch: int = 1) -> int:
    """Parameter count of one layer for a given supernet branch
    (0=identity, 1=full, 2=bottleneck, 3=lite — counts only the weights the
    branch actually *uses*; the master stores all branches).  Biases are
    not counted, as in the JAX package."""
    fam = cfg.family
    if branch == 0:
        return 0
    if fam in ("dense", "vlm"):
        a, m = attn_params(cfg), mlp_params(cfg)
        if branch == 2:
            m //= 2
        if branch == 3:
            a -= cfg.d_model * cfg.hd * cfg.num_heads  # half q + half o
        return a + m + 2 * cfg.d_model
    if fam == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        a = attn_params(cfg)
        e = cfg.num_experts * cfg.d_model * f * 3 + cfg.d_model * cfg.num_experts
        if branch == 2:
            e //= 2
        if branch == 3:
            a -= cfg.d_model * cfg.hd * cfg.num_heads
        sh = mlp_params(cfg) if cfg.shared_expert else 0
        return a + e + sh + 2 * cfg.d_model
    if fam in ("ssm", "hybrid"):
        s = ssm_params(cfg)
        if branch in (2, 3):
            s = int(s * 0.75)   # masked half-state / half-heads
        return s + cfg.d_model
    if fam == "audio":
        return (attn_params(cfg) * 2 + mlp_params(cfg, gated=False)
                + 3 * cfg.d_model)
    raise ValueError(fam)


def model_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameter count (active_only: count top_k experts only)."""
    n = cfg.vocab_size * cfg.d_model + cfg.d_model       # embed + final ln
    per_layer = layer_params(cfg)
    if cfg.family == "moe" and active_only:
        f = cfg.moe_d_ff or cfg.d_ff
        dense_experts = cfg.num_experts * cfg.d_model * f * 3
        active_experts = cfg.top_k * cfg.d_model * f * 3
        per_layer = per_layer - dense_experts + active_experts
    n += cfg.num_layers * per_layer
    if cfg.family == "hybrid":
        n += (attn_params(cfg) + mlp_params(cfg) + 2 * cfg.d_model)  # shared
    if cfg.family == "audio":
        enc = (attn_params(cfg) + mlp_params(cfg, gated=False)
               + 2 * cfg.d_model)
        n += cfg.encoder_layers * enc + cfg.d_model
    if cfg.family == "vlm":
        n += cfg.d_model * cfg.d_model + cfg.d_model     # projector
    return int(n)


def subnet_params(cfg: ModelConfig, key: np.ndarray) -> int:
    """Parameters of the sub-model selected by ``key`` (transferred payload)."""
    n = cfg.vocab_size * cfg.d_model + cfg.d_model
    for b in np.asarray(key).tolist():
        n += layer_params(cfg, int(b))
    if cfg.family == "hybrid":
        n += attn_params(cfg) + mlp_params(cfg) + 2 * cfg.d_model
    return int(n)


def train_flops(cfg: ModelConfig, tokens: int) -> float:
    """MODEL_FLOPS for the roofline: 6 * N_active * D."""
    return 6.0 * model_params(cfg, active_only=True) * tokens


def decode_flops(cfg: ModelConfig, batch: int) -> float:
    """Per decode step: 2 * N_active * batch (fwd only)."""
    return 2.0 * model_params(cfg, active_only=True) * batch
