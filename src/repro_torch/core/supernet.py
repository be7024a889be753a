"""Uniform supernet API (init / loss / error count / trained mask / flops /
payload as functions of a choice key) for the CIFAR CNN supernet.

The functions are device-agnostic: they run wherever their tensors lie.
``init`` takes a ``torch.Generator`` and returns CPU tensors; the
strategy moves them to the engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregate, flops
from repro_torch.core.choice import BITS_PER_BLOCK
from repro_torch.models.cnn import BRANCH_NAMES, CnnSupernet

Params = Dict[str, torch.Tensor]


def choice_key_bytes(num_blocks: int) -> int:
    """Wire size of one choice key: 2 bits per choice block, byte-padded."""
    return (num_blocks * BITS_PER_BLOCK + 7) // 8


@dataclasses.dataclass(frozen=True)
class SupernetAPI:
    cfg: ModelConfig
    num_blocks: int
    init: Callable[[torch.Generator], Params]
    loss: Callable[[Params, Dict[str, Any], np.ndarray], torch.Tensor]
    error_count: Callable[[Params, Dict[str, Any], np.ndarray], torch.Tensor]
    trained_mask: Callable[[Params, np.ndarray], Params]
    flops: Callable[[np.ndarray], float]
    payload_params: Callable[[np.ndarray], int]
    master_params: Callable[[], int]
    key_bytes: int = 0    # wire size of one choice key (2 bits per block)


def cnn_supernet_api(cfg: ModelConfig) -> SupernetAPI:
    if cfg.family != "cnn":
        raise ValueError(f"cnn_supernet_api needs a cnn config, got "
                         f"{cfg.family!r}")
    net = CnnSupernet(cfg)

    def loss(params, batch, key):
        logits = functional_call(net, params, (batch["x"], key))
        return F.cross_entropy(logits.float(), batch["y"].long())

    def error_count(params, batch, key):
        logits = functional_call(net, params, (batch["x"], key))
        return (logits.argmax(-1) != batch["y"]).sum()

    # per-(block, branch) parameter sizes from the shapes alone
    sizes = {k: s.numel() for k, s in net.shapes().items()}
    total = sum(sizes.values())
    branch_sizes = [{nm: 0 for nm in BRANCH_NAMES}
                    for _ in range(cfg.num_layers)]
    for k, n in sizes.items():
        if k.startswith("blocks."):
            _, i, nm, _ = k.split(".")
            branch_sizes[int(i)][nm] += n
    base = total - sum(sum(b.values()) for b in branch_sizes)

    def payload(key):
        # shared stem/fc + only the selected branch of every choice block
        return base + sum(branch_sizes[i][BRANCH_NAMES[int(b)]]
                          for i, b in enumerate(np.asarray(key)))

    return SupernetAPI(
        cfg=cfg, num_blocks=cfg.num_layers, init=net.init_params, loss=loss,
        error_count=error_count,
        trained_mask=aggregate.cnn_trained_mask,
        flops=lambda key: float(flops.cnn_subnet_macs(key, cfg.num_layers)),
        payload_params=payload, master_params=lambda: total,
        key_bytes=choice_key_bytes(cfg.num_layers))
