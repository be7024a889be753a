"""Carry weights between the JAX package's layouts and the port's.

CIFAR CNN (``params_from_reference`` / ``params_to_reference``):

The JAX package nests its parameters as ``{"stem", "fc": {"w", "b"},
"blocks": [{branch: {leaf: array}}]}`` with HWIO convolutions
(depthwise ``(K, K, 1, C)``); the port keeps a flat ``dict[str, Tensor]``
under ``state_dict`` names with OIHW convolutions (depthwise
``(C, 1, K, K)``).  ``fc.w`` is ``(C, 10)`` in both, and the ``"_"``
placeholder leaf carries over.  Leaves are matched by path, never by
position; the port's order is the module's (leaves of a branch, and
``fc.b`` before ``fc.w``, in name order).

Language models (``lm_params_from_reference`` / ``lm_params_to_reference``):
the JAX package stacks every per-layer leaf on a leading ``L`` axis
(``params["layers"][...]`` of shape ``(L, ...)``); the port keeps a list
of ``L`` per-layer dicts with the same names and the same per-layer
layouts (dense ``w`` is ``(d_in, d_out)`` in both; a MoE layer's
``moe.router.w`` is ``(d, E)``, ``moe.experts.wi``/``wg`` ``(E, d, F)``
and ``wo`` ``(E, F, d)``, beside ``moe.shared`` where the config has a
shared expert).  The hybrid's ``shared`` block is one unstacked dense
block in both, a supernet's too; so are the VLM's ``proj`` and the audio
model's ``enc_ln``.  The audio model's ``encoder`` is stacked on a
leading ``encoder_layers`` axis in the JAX package and a list of that
many block dicts here, as ``layers`` is.  Leaves are matched by path.  A supernet's layer leaves
are ``(L, 3, ...)`` in the JAX package (the weighted branches 1-3 on the
second axis) and ``params["layers"][l][b]`` here, a list of 3 branch
dicts per layer; ``models.transformer.flat_params`` then names them
``layers.{l}.{b}.<path>`` in the LM supernet's flat master.  bfloat16
leaves cross as float32 numpy arrays holding the same values (numpy has
no bfloat16); both directions are exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.cnn import BRANCH_NAMES
from repro_torch.models.transformer import N_BRANCHES

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _to_port(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(_HWIO_TO_OIHW)
    return torch.tensor(a)


def _to_ref(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(_OIHW_TO_HWIO)
    return np.ascontiguousarray(a)


def params_from_reference(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's CNN parameter tree (leaves as numpy arrays) ->
    the port's ordered ``dict[str, Tensor]`` on the CPU."""
    out = {"stem": _to_port(tree["stem"])}
    for i, blk in enumerate(tree["blocks"]):
        for nm in BRANCH_NAMES:
            for leaf in sorted(blk[nm]):
                out[f"blocks.{i}.{nm}.{leaf}"] = _to_port(blk[nm][leaf])
    out["fc.b"] = _to_port(tree["fc"]["b"])
    out["fc.w"] = _to_port(tree["fc"]["w"])
    return out


def params_to_reference(params: Dict[str, torch.Tensor]):
    """Inverse of ``params_from_reference``: numpy arrays in the JAX
    package's layout and nesting."""
    tree = {"stem": None, "fc": {}, "blocks": []}
    for k, t in params.items():
        parts = k.split(".")
        if parts[0] == "stem":
            tree["stem"] = _to_ref(t)
        elif parts[0] == "fc":
            tree["fc"][parts[1]] = _to_ref(t)
        else:
            i, nm, leaf = int(parts[1]), parts[2], parts[3]
            while len(tree["blocks"]) <= i:
                tree["blocks"].append({b: {} for b in BRANCH_NAMES})
            tree["blocks"][i][nm][leaf] = _to_ref(t)
    return tree


# the families of the language models, whose parameters cross here
_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the per-layer stacks: name -> the config field that counts its layers
_STACKS = {"layers": "num_layers", "encoder": "encoder_layers"}


def _lm_family_check(cfg: ModelConfig) -> None:
    if cfg.family not in _LM_FAMILIES:
        raise ValueError(f"{cfg.name}: not a language model (family "
                         f"{cfg.family!r})")


def _leaf_to_port(a, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy's extension type
        a = a.astype(np.float32)
    return torch.tensor(a).to(dtype)


def _tree_to_port(tree, dtype_of):
    if isinstance(tree, dict):
        return {k: _tree_to_port(v, dtype_of) for k, v in tree.items()}
    return _leaf_to_port(tree, dtype_of(tree))


def lm_params_from_reference(cfg: ModelConfig, tree) -> Dict:
    """The JAX package's LM parameter tree (leaves as numpy arrays,
    per-layer leaves stacked on ``L``, a supernet's on ``(L, 3)``, the
    audio encoder's on ``encoder_layers``) -> the port's nested dicts on
    the CPU, ``layers`` a list of ``L`` dicts (a supernet's: of ``L``
    lists of 3 branch dicts), ``encoder`` a list of ``encoder_layers``
    dicts.  float32 leaves stay float32; the others take the config's
    dtype."""
    _lm_family_check(cfg)

    def dtype_of(a):
        return (torch.float32 if np.asarray(a).dtype == np.float32
                else cfg.torch_dtype)

    out = {k: _tree_to_port(v, dtype_of) for k, v in tree.items()
           if k not in _STACKS}

    def unstack(node, idx, lead):
        if isinstance(node, dict):
            return {k: unstack(v, idx, lead) for k, v in node.items()}
        a = np.asarray(node)
        if a.shape[:len(idx)] != lead:
            raise ValueError(f"layer leaf of shape {a.shape}: expected "
                             f"leading axes {lead}")
        return _leaf_to_port(a[idx], dtype_of(a))

    for name, count in _STACKS.items():
        if name not in tree:
            continue
        n = getattr(cfg, count)
        branched = name == "layers" and cfg.supernet
        lead = (n, N_BRANCHES) if branched else (n,)
        out[name] = [
            [unstack(tree[name], (l, b), lead) for b in range(N_BRANCHES)]
            if branched else unstack(tree[name], (l,), lead)
            for l in range(n)]
    return out


def lm_params_to_reference(cfg: ModelConfig, params: Dict):
    """Inverse of ``lm_params_from_reference``: numpy arrays in the JAX
    package's nesting, per-layer leaves stacked on ``L`` (a supernet's on
    ``(L, 3)``, the encoder's on ``encoder_layers``; bfloat16 leaves as
    float32 arrays of the same values)."""
    _lm_family_check(cfg)

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return leaf(node)

    out = {k: tree(v) for k, v in params.items() if k not in _STACKS}

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        if isinstance(nodes[0], np.ndarray):
            return np.stack(nodes)
        return np.stack([leaf(n) for n in nodes])

    for name, count in _STACKS.items():
        if name not in params:
            continue
        blocks = params[name]
        if len(blocks) != getattr(cfg, count):
            raise ValueError(f"{len(blocks)} blocks in {name!r}, config "
                             f"has {getattr(cfg, count)}")
        if name == "layers" and cfg.supernet:
            # (L, 3, ...): stack each layer's branches, then the layers
            out[name] = stack([stack(list(branches)) for branches in blocks])
        else:
            out[name] = stack(blocks)
    return out
