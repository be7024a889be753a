"""The paper's master model: CIFAR CNN supernet (Fig. 3 / Fig. 4).

Conv stem -> choice blocks -> global-avg-pool -> FC.  Each choice block
has 4 branches: identity / residual / inverted-residual (MobileNetV2) /
depthwise-separable, in 'normal' (C->C) or 'reduction' (C->2C, spatial
/2) form depending on position.  Only normal blocks carry shortcut
connections (paper Fig. 4).  BatchNorm has no affine parameters and no
moving statistics (Section IV.C): it normalizes with the current batch.

``CnnSupernet`` holds the structure only; its own parameters live on the
``meta`` device.  The weights travel as an ordered ``dict[str, Tensor]``
under the module's ``state_dict`` names (``stem``,
``blocks.3.residual.c1``, ``fc.w``, ...) and ``forward`` runs through
``torch.func.functional_call``.  Convolution weights are OIHW (depthwise
``(C, 1, 3, 3)``); ``fc.w`` is ``(C, 10)``.  Images arrive NHWC, as in
the JAX package, and the choice key is a host ``(num_blocks,)`` int
array: branch selection is plain Python.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import cifar_supernet as cs
from repro_torch.configs.base import ModelConfig

BRANCH_NAMES = ("identity", "residual", "inverted", "sepconv")

Params = Dict[str, torch.Tensor]


def _same_pad(size: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one spatial axis: the output has
    ceil(size / stride) positions and any odd padding goes to the END
    (a 3x3 stride-2 conv of an even input pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    """Dense conv with SAME padding; x NCHW, w OIHW."""
    k = w.shape[-1]
    lo_h, hi_h = _same_pad(x.shape[2], k, stride)
    lo_w, hi_w = _same_pad(x.shape[3], k, stride)
    if lo_h == hi_h and lo_w == hi_w:
        return F.conv2d(x, w, stride=stride, padding=(lo_h, lo_w))
    return F.conv2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h)), w, stride=stride)


def depthwise(x, w, stride=1):
    """Depthwise 3x3 conv, w (C, 1, 3, 3).  The JAX package pads 1 on
    every side, convolves at stride 1 and keeps every ``stride``-th
    output, which is a strided conv with symmetric padding 1."""
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2,
                    groups=x.shape[1])


def bn(x, eps=1e-5):
    """Paper-faithful BN: batch statistics only (biased variance), no
    affine, no moving stats."""
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mu).square().mean(dim=(0, 2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _branch_shapes(name: str, cin: int, cout: int) -> Dict[str, tuple]:
    """Leaf name -> shape of one branch."""
    if name == "identity":
        if cout == cin:
            return {"_": (1,)}           # placeholder leaf, counts 1 param
        return {"pw1": (cout // 2, cin, 1, 1), "pw2": (cout // 2, cin, 1, 1)}
    if name == "residual":
        return {"c1": (cout, cin, 3, 3), "c2": (cout, cout, 3, 3)}
    if name == "inverted":
        hid = 4 * cin
        return {"pw1": (hid, cin, 1, 1), "dw": (hid, 1, 3, 3),
                "pw2": (cout, hid, 1, 1)}
    if name == "sepconv":
        return {"dw1": (cin, 1, 3, 3), "pw1": (cout, cin, 1, 1),
                "dw2": (cout, 1, 3, 3), "pw2": (cout, cout, 1, 1)}
    raise ValueError(name)


def branch_apply(name: str, p, x, cin: int, cout: int):
    red = cout != cin
    stride = 2 if red else 1
    if name == "identity":
        if not red:
            return x
        return torch.cat([conv(x, p["pw1"], stride=2),
                          conv(x, p["pw2"], stride=2)], dim=1)
    if name == "residual":
        h = F.relu(bn(conv(x, p["c1"], stride=stride)))
        h = bn(conv(h, p["c2"]))
        if not red:
            h = h + x
        return F.relu(h)
    if name == "inverted":
        h = F.relu(bn(conv(x, p["pw1"])))
        h = F.relu(bn(depthwise(h, p["dw"], stride=stride)))
        h = bn(conv(h, p["pw2"]))
        if not red:
            h = h + x
        return h
    if name == "sepconv":
        h = depthwise(x, p["dw1"], stride=stride)
        h = F.relu(bn(conv(h, p["pw1"])))
        h = depthwise(h, p["dw2"])
        h = F.relu(bn(conv(h, p["pw2"])))
        if not red:
            h = h + x
        return h
    raise ValueError(name)


def _meta(shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


class ChoiceBlock(nn.Module):
    """One choice block: a ``ParameterDict`` per branch."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        for name in BRANCH_NAMES:
            # ParameterDict sorts a dict's keys: leaves are in name
            # order, as jax.tree orders them
            self.add_module(name, nn.ParameterDict(
                {k: _meta(s) for k, s in
                 _branch_shapes(name, cin, cout).items()}))

    def forward(self, x, branch: int):
        name = BRANCH_NAMES[branch]
        return branch_apply(name, getattr(self, name), x, self.cin,
                            self.cout)


class CnnSupernet(nn.Module):
    """Structure of the supernet; weights come in through
    ``functional_call`` (see the module docstring)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n = cfg.num_layers
        chans = cs.channels_for(n)
        stem_c = cs.stem_channels_for(n)
        self.stem = _meta((stem_c, 3, 3, 3))
        blocks, cin = [], stem_c
        for i in range(n):
            blocks.append(ChoiceBlock(cin, chans[i]))
            cin = chans[i]
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.ParameterDict({"w": _meta((cin, cs.NUM_CLASSES)),
                                    "b": _meta((cs.NUM_CLASSES,))})

    def forward(self, images, choice_key: Sequence[int]):
        """images: (B, H, W, 3) float32; choice_key: (num_blocks,) ints."""
        h = F.relu(bn(conv(images.permute(0, 3, 1, 2), self.stem)))
        for blk, b in zip(self.blocks, np.asarray(choice_key).tolist()):
            h = blk(h, int(b))
        h = h.mean(dim=(2, 3))
        return h @ self.fc["w"] + self.fc["b"]

    def shapes(self) -> Dict[str, torch.Size]:
        """``state_dict`` name -> shape, in parameter order."""
        return {k: v.shape for k, v in self.named_parameters()}

    def init_params(self, generator: torch.Generator) -> Params:
        """Uniform(-s, s) with s = 1/sqrt(fan_in), the JAX package's
        distribution (its numbers come from ``jax.random`` and differ);
        ``fc.b`` and the placeholder leaves are zero."""
        out: Params = {}
        for k, shape in self.shapes().items():
            leaf = k.rsplit(".", 1)[-1]
            if leaf in ("_", "b"):
                out[k] = torch.zeros(shape)
                continue
            fan_in = shape[0] if k == "fc.w" else math.prod(shape[1:])
            s = 1.0 / math.sqrt(fan_in)
            out[k] = torch.empty(shape).uniform_(-s, s, generator=generator)
        return out
