"""Shared model blocks — port of pytorchocr_tpu/modeling/common.py.

NCHW `nn.Module`s. Submodule names mirror the flax ones (`conv`, `bn`) so the
weight bridge (utils/weights.py) maps flax paths onto torch names one to one.

Half-ported: the float path of ConvBNAct only. The int8 PTQ branches
(QuantConv, emit_q, finish_residual's int8 flow, quant_max_pool), SEModule and
DPModule wait for their ROADMAP.md items.
"""

import torch
import torch.nn.functional as F
from torch import nn


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


ACTS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "hardswish": hard_swish,
    "hard_swish": hard_swish,
    "hsigmoid": hard_sigmoid,
    "hardsigmoid": hard_sigmoid,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "leakyrelu0.2": lambda x: F.leaky_relu(x, 0.2),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class ConvBNAct(nn.Module):
    """conv -> BN -> activation. `padding` None means symmetric d*(k-1)//2,
    an int is symmetric. `bn_momentum` is the flax one (0.9), i.e. torch
    momentum 0.1. The JAX version's asymmetric padding serves only the
    stem_space_to_depth stem, which is not ported."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, dilation=1, use_bias=False, act="relu",
                 use_bn=True, bn_eps=1e-5, bn_momentum=0.9):
        super().__init__()
        ks = _pair(kernel_size)
        if padding is None:
            padding = tuple(dilation * (k - 1) // 2 for k in ks)
        elif not isinstance(padding, int):
            raise NotImplementedError("ConvBNAct takes None or an int padding")
        self.conv = nn.Conv2d(
            in_channels, out_channels, ks, _pair(stride), padding=padding,
            dilation=dilation, groups=groups, bias=use_bias,
        )
        self.bn = (
            nn.BatchNorm2d(out_channels, eps=bn_eps, momentum=1.0 - bn_momentum)
            if use_bn else None
        )
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = ACTS[self.act](x)
        return x


def max_pool(x, window, strides, padding=(0, 0)):
    """torch MaxPool2d on NCHW: symmetric padding with -inf, as the JAX
    `max_pool` pads."""
    return F.max_pool2d(x, _pair(window), _pair(strides), _pair(padding))


def resize_nearest(x, scale):
    """Nearest-neighbour upsample by an integer scale on NCHW. Equal, element
    for element, to the JAX version's depthwise transposed conv."""
    s = int(scale)
    if s == 1:
        return x
    return F.interpolate(x, scale_factor=s, mode="nearest")
