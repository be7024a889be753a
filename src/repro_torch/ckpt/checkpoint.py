"""Flat-key npz checkpoints of nested dicts and lists of tensors (no
external dependencies).

Leaves are saved under '/'-joined key paths built by the JAX package's
rule (``repro.ckpt``): each path element written as a pytree key prints
(``['name']`` for a dict key, ``[0]`` for a list or tuple index) with
``[``, ``]``, ``'`` and ``.`` stripped.  The same nested tree therefore
gives the same npz keys in both packages, and each loads the other's
files.  The port's flat state-dict names lose their dots
(``blocks.0.conv3.w`` -> ``blocks0conv3w``), so ``save_pytree`` raises
when two leaves would share a key instead of overwriting one.

Leaves numpy cannot hold (bfloat16) are saved as float32.  Restore
rebuilds against a template tree: shapes are checked, each leaf is cast
to the template's dtype and placed on the template leaf's device.
"""
from __future__ import annotations

import os
import re
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

Params = Any


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[tuple]:
    """(path elements, leaf) of every leaf; ``None`` is an empty
    subtree, as in a pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"[{i}]",))
    elif tree is not None:
        yield prefix, tree


def _key(path: Tuple[str, ...]) -> str:
    return "/".join(re.sub(r"[\[\]'.]", "", p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            arr = t.numpy()
        except TypeError:                 # bfloat16 etc: not numpy-native
            arr = t.float().numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Params) -> dict:
    out = {}
    for path, leaf in _paths(tree):
        key = _key(path)
        if key in out:
            raise ValueError(f"two leaves map to checkpoint key {key!r}")
        out[key] = _to_numpy(leaf)
    return out


def save_pytree(path: str, tree: Params, step: Optional[int] = None) -> str:
    """Save ``tree`` to ``path`` (or ``path/step_<step>.npz`` when ``step``
    is given) and return the file written."""
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}.npz")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    return path


def _rebuild(template, data, prefix: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _rebuild(v, data, prefix + (f"[{k!r}]",))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, data, prefix + (f"[{i}]",))
                              for i, v in enumerate(template))
    if template is None:
        return None
    key = _key(prefix)
    arr = data[key]
    leaf = torch.as_tensor(template)
    if arr.shape != tuple(leaf.shape):
        raise ValueError(f"{key}: ckpt {arr.shape} != template "
                         f"{tuple(leaf.shape)}")
    return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)


def load_pytree(path: str, template: Params) -> Params:
    """The tree saved at ``path``, rebuilt as ``template``: every leaf a
    tensor of the template leaf's shape (else ``ValueError``), dtype and
    device."""
    with np.load(path) as data:
        return _rebuild(template, data)


def restore_latest(ckpt_dir: str, template: Params):
    """(tree, step) of the newest ``step_*.npz`` in ``ckpt_dir``, or
    (None, -1) when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None, -1
    files = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".npz"))
    if not files:
        return None, -1
    step = int(files[-1][5:-4])
    return load_pytree(os.path.join(ckpt_dir, files[-1]), template), step
