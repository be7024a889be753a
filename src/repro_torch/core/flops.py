"""Analytic MACs of a CNN subnet — the paper's second objective.

The transformer parameter and FLOP counts of the JAX package follow with
the LM supernet path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import cifar_supernet as cs
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
