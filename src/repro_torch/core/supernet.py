"""Uniform supernet API over the two master-model families.

The paper's runtime is model-agnostic: it needs init / loss / error
count / trained mask / flops / payload as functions of a choice key.
``cnn_supernet_api`` is the paper-faithful CIFAR master model;
``lm_supernet_api`` is the transformer adaptation used with the assigned
architectures; ``make_api`` picks one by the config's family.

The functions are device-agnostic: they run wherever their tensors lie.
``init`` takes a ``torch.Generator`` and returns tensors on its device
(the strategies pass a CPU generator and move the master to the
engine's device).  A master is a flat ordered ``dict[str, Tensor]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregate, flops
from repro_torch.core.choice import BITS_PER_BLOCK
from repro_torch.models import transformer as tr
from repro_torch.models.cnn import BRANCH_NAMES, CnnSupernet
from repro_torch.models.layers import cross_entropy

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


def lm_supernet_api(cfg: ModelConfig) -> SupernetAPI:
    """The transformer supernet of a ``dense``, ``moe`` or ``ssm`` config
    with ``supernet=True``.  The master is ``tr.flat_params`` of
    ``tr.init_params``: names ``embed.table``, ``final_ln.g`` and
    ``layers.{l}.{b}.<path>`` for branch b + 1 of layer l.  The loss is
    the token cross entropy plus 0.01 times the MoE aux loss, the error
    count the number of wrong argmax tokens; both run the torch route
    (the JAX package's ``"xla"``: the kernels are forward-only).  Counts
    (``flops``, ``payload_params``, ``master_params``) are the JAX
    package's analytic ones, which leave biases out."""
    if not (cfg.supernet and cfg.family in ("dense", "moe", "ssm")):
        raise ValueError(f"lm_supernet_api needs a dense, moe or ssm config "
                         f"with supernet=True, got {cfg.family!r} "
                         f"(supernet={cfg.supernet})")
    n_layers = cfg.num_layers

    # the flat master's names parsed once: (name, path below the branch)
    # grouped by (layer, branch), the leaves outside ``layers`` under None
    groups: Dict[Any, List[Tuple[str, List[str]]]] = {}

    def view(params, key):
        """The nested params of the subnet ``key`` selects: the master's
        own tensors (no copies), only the selected branch of each layer
        (``layers.{l}.{b}.…`` with ``key[l] == b + 1``)."""
        key = np.asarray(key).reshape(-1).tolist()
        if sum(map(len, groups.values())) != len(params):
            groups.clear()
            for name in params:
                parts = name.split(".")
                at = ((int(parts[1]), int(parts[2]))
                      if parts[0] == "layers" else None)
                groups.setdefault(at, []).append(
                    (name, parts[3:] if at else parts))

        def put(node, name, path):
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = params[name]

        out: Dict[str, Any] = {}
        for name, path in groups.get(None, ()):
            put(out, name, path)
        layers = [[None] * tr.N_BRANCHES for _ in key]
        for l, k in enumerate(key):
            if k:
                layers[l][k - 1] = {}
                for name, path in groups.get((l, k - 1), ()):
                    put(layers[l][k - 1], name, path)
        out["layers"] = layers
        return out, key

    def init(gen):
        return tr.flat_params(tr.init_params(gen, cfg))

    def logits_aux(params, x, key):
        nested, key = view(params, key)
        return tr.forward(nested, cfg, x, choice_key=key, backend="torch",
                          return_aux=True)

    def loss(params, batch, key):
        logits, aux = logits_aux(params, batch["x"], key)
        return cross_entropy(logits, batch["y"]) + 0.01 * aux

    def error_count(params, batch, key):
        logits, _ = logits_aux(params, batch["x"], key)
        return (logits.argmax(-1) != batch["y"]).sum()

    master = (flops.model_params(cfg)
              + 2 * n_layers * flops.layer_params(cfg))   # 3 branches

    return SupernetAPI(
        cfg=cfg, num_blocks=n_layers, init=init, loss=loss,
        error_count=error_count,
        trained_mask=aggregate.supernet_trained_mask,
        # per-token forward flops of the selected subnet (2 * params used)
        flops=lambda key: 2.0 * flops.subnet_params(cfg, key),
        payload_params=lambda key: flops.subnet_params(cfg, key),
        master_params=lambda: master,
        key_bytes=choice_key_bytes(n_layers))


def make_api(cfg: ModelConfig) -> SupernetAPI:
    """The CNN supernet's API for a ``cnn`` config, else the LM
    supernet's."""
    return cnn_supernet_api(cfg) if cfg.family == "cnn" \
        else lm_supernet_api(cfg)
