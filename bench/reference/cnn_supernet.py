"""Plain reference of the paper's CIFAR CNN supernet (Zhu & Jin 2020,
Fig. 3 and 4, Section IV.C).

A conv stem, one choice block per entry of ``channels`` and a linear
classifier over the global average pool.  Each block has four branches
(identity, residual, inverted residual, depthwise separable); a block
whose channels change is a reduction block (stride 2, no shortcut), the
others add a shortcut except where the paper's figure has none.
Batch normalisation uses the batch's own statistics (biased variance),
with no affine parameters and no running statistics.  Convolutions pad
as XLA's "SAME": a strided 3 x 3 convolution of an even side pads one
at the end only; a depthwise convolution pads one on every side.

The weights are a flat ``{name: tensor}`` dict with the master's leaf
names (``stem``, ``blocks.<i>.<branch>.<leaf>``, ``fc.w``, ``fc.b``);
convolution weights are OIHW, images NHWC.  ``init`` draws the master
the benchmark hands the program: Uniform(-s, s), s = 1 / sqrt(fan in),
the classifier's bias and the placeholder leaves zero.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from bench.harness.counts import cnn_branch_shapes


BRANCHES = ("identity", "residual", "inverted", "sepconv")


def _pad_same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    lo, hi = _pad_same(x.shape[-1], w.shape[-1], stride)
    if lo == hi:
        return F.conv2d(x, w, stride=stride, padding=lo)
    x = F.pad(x, (lo, hi, lo, hi))
    return F.conv2d(x, w, stride=stride)


def _dw(x, w, stride=1):
    return F.conv2d(x, w, stride=stride, padding=1, groups=x.shape[1])


def _bn(x, eps=1e-5):
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mu).square().mean(dim=(0, 2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _branch(name, p, x, red):
    s = 2 if red else 1
    if name == "identity":
        if not red:
            return x
        return torch.cat([_conv(x, p["pw1"], 2),
                          _conv(x, p["pw2"], 2)], dim=1)
    if name == "residual":
        h = F.relu(_bn(_conv(x, p["c1"], s)))
        h = _bn(_conv(h, p["c2"]))
        return F.relu(h if red else h + x)
    if name == "inverted":
        h = F.relu(_bn(_conv(x, p["pw1"])))
        h = F.relu(_bn(_dw(h, p["dw"], s)))
        h = _bn(_conv(h, p["pw2"]))
        return h if red else h + x
    if name == "sepconv":
        h = _dw(x, p["dw1"], s)
        h = F.relu(_bn(_conv(h, p["pw1"])))
        h = _dw(h, p["dw2"])
        h = F.relu(_bn(_conv(h, p["pw2"])))
        return h if red else h + x
    raise ValueError(name)


def logits(params: Dict[str, torch.Tensor], x: torch.Tensor,
           key: Sequence[int], model: dict) -> torch.Tensor:
    h = F.relu(_bn(_conv(x.permute(0, 3, 1, 2), params["stem"])))
    cin = model["stem_channels"]
    for i, (cout, b) in enumerate(zip(model["channels"], key)):
        name = BRANCHES[int(b)]
        pre = f"blocks.{i}.{name}."
        p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        h = _branch(name, p, h, cout != cin)
        cin = cout
    h = h.mean(dim=(2, 3))
    return h @ params["fc.w"] + params["fc.b"]


def trained(name: str, key: Sequence[int]) -> bool:
    """Whether an upload of ``key`` carries leaf ``name``: the stem and
    the classifier always, a block's leaves on its selected branch."""
    if not name.startswith("blocks."):
        return True
    _, i, branch, _ = name.split(".")
    return BRANCHES[int(key[int(i)])] == branch


def used(name: str, key: Sequence[int], model: dict) -> bool:
    """Whether the forward of ``key`` reads leaf ``name`` (a normal
    block's identity branch reads none)."""
    return trained(name, key) and not name.endswith("._")


def loss(params, x, y, key, model) -> torch.Tensor:
    return F.cross_entropy(logits(params, x, key, model).float(), y.long())


def wrong(params, x, y, key, model) -> int:
    with torch.no_grad():
        out = logits(params, x, key, model)
    return int((out.argmax(-1) != y).sum())


def leaf_shapes(model: dict) -> Dict[str, tuple]:
    """The master's leaves in order: the stem, every branch of every
    block (a normal block's identity branch holds a one-element
    placeholder), the classifier.  The program takes its leaves by
    name."""
    out = {"stem": (model["stem_channels"], 3, 3, 3)}
    cin = model["stem_channels"]
    for i, cout in enumerate(model["channels"]):
        for name in BRANCHES:
            for leaf, shape in cnn_branch_shapes(name, cin, cout).items():
                out[f"blocks.{i}.{name}.{leaf}"] = shape
        cin = cout
    out["fc.w"] = (cin, model["classes"])
    out["fc.b"] = (model["classes"],)
    return out


def init(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The master from ``seed``: one uniform draw on ``device`` for every
    leaf, cut and scaled by each leaf's fan in."""
    shapes = leaf_shapes(model)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(
        -1.0, 1.0, generator=gen)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("_", "b"):
            out[name] = torch.zeros(shape, device=device)
            continue
        fan_in = shape[0] if name == "fc.w" else math.prod(shape[1:])
        out[name] = (part * (1.0 / math.sqrt(fan_in))).reshape(shape)
    return out
