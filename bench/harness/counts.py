"""The yardstick's arithmetic: parameters, payloads, MACs and FLOPs of a
configuration's sub-models, the bytes Algorithm 3 needs, and the H100's
published peaks.

Everything here is computed from a configuration file's sizes and a
choice key, never from the program's own counts, so that a change to the
program cannot move what it is measured against.  The counts follow
the paper's CNN supernet (Fig. 3 / Section IV.C).
"""
from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense rates, at the card's 700 W limit
PEAK_FLOPS = {"float32": 67e12}      # outside the tensor cores (no TF32)
HBM_BYTES_PER_S = 3.35e12

CNN_BRANCHES = ("identity", "residual", "inverted", "sepconv")


def _cnn_blocks(model: dict):
    """(cin, cout, h) of each choice block, h the input side length."""
    cin, h = model["stem_channels"], model["image"]
    out = []
    for cout in model["channels"]:
        out.append((cin, cout, h))
        if cout != cin:
            h //= 2
        cin = cout
    return out


def cnn_branch_shapes(name: str, cin: int, cout: int) -> Dict[str, tuple]:
    """Leaf -> shape of one branch (the master stores all four)."""
    if name == "identity":
        if cout == cin:
            return {"_": (1,)}            # the master's placeholder leaf
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


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def cnn_shared_params(model: dict) -> int:
    """Stem and classifier: trained by every client."""
    last = model["channels"][-1]
    return (model["stem_channels"] * 3 * 9 + last * model["classes"]
            + model["classes"])


def cnn_branch_params(model: dict, block: int, branch: int) -> int:
    cin, cout, _ = _cnn_blocks(model)[block]
    return sum(_numel(s) for s in cnn_branch_shapes(
        CNN_BRANCHES[branch], cin, cout).values())


def _conv_macs(h, cin, cout, k, stride=1, groups=1) -> int:
    ho = h // stride
    return ho * ho * cout * cin // groups * k * k


def cnn_branch_macs(name: str, h: int, cin: int, cout: int) -> int:
    red = cout != cin
    st = 2 if red else 1
    if name == "identity":
        return 2 * _conv_macs(h, cin, cout // 2, 1, 2) if red else 0
    if name == "residual":
        return (_conv_macs(h, cin, cout, 3, st)
                + _conv_macs(h // st, cout, cout, 3))
    if name == "inverted":
        hid = 4 * cin
        return (_conv_macs(h, cin, hid, 1)
                + _conv_macs(h, hid, hid, 3, st, groups=hid)
                + _conv_macs(h // st, hid, cout, 1))
    if name == "sepconv":
        ho = h // st
        return (_conv_macs(h, cin, cin, 3, st, groups=cin)
                + _conv_macs(ho, cin, cout, 1)
                + _conv_macs(ho, cout, cout, 3, groups=cout)
                + _conv_macs(ho, cout, cout, 1))
    raise ValueError(name)


def cnn_macs(model: dict, key: Sequence[int]) -> int:
    """Forward MACs of one image through the sub-model ``key``: the
    convolutions and the classifier (normalisation and activations are
    not multiply-accumulates)."""
    total = _conv_macs(model["image"], 3, model["stem_channels"], 3)
    for (cin, cout, h), b in zip(_cnn_blocks(model), key):
        total += cnn_branch_macs(CNN_BRANCHES[int(b)], h, cin, cout)
    return total + model["channels"][-1] * model["classes"]


def master_params(config: dict) -> int:
    m = config["model"]
    return cnn_shared_params(m) + sum(
        cnn_branch_params(m, i, b) for i in range(len(m["channels"]))
        for b in range(len(CNN_BRANCHES)))


def payload_params(config: dict, key: Sequence[int]) -> int:
    """The parameters an upload of ``key`` carries: the shared leaves and
    every leaf of each selected branch (what its trained mask marks)."""
    m = config["model"]
    return cnn_shared_params(m) + sum(
        cnn_branch_params(m, i, int(b)) for i, b in enumerate(key))


def fwd_macs(config: dict, key: Sequence[int]) -> float:
    """Forward MACs of one image."""
    return float(cnn_macs(config["model"], key))


def objective(config: dict, key: Sequence[int]) -> float:
    """The search's second objective as the configuration states it: the
    forward MACs of one image."""
    return float(cnn_macs(config["model"], key))


def k1_bytes(config: dict, upload_keys: Sequence[Sequence[int]]) -> float:
    """Bytes Algorithm 3 needs for one aggregation of these uploads, in
    float32: each upload's payload read once, the previous master read
    and the new one written."""
    return 4.0 * (sum(payload_params(config, k) for k in upload_keys)
                  + 2 * master_params(config))
