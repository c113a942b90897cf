"""ConvNeXt detection backbone — port of
pytorchocr_tpu/modeling/backbones/det_convnext.py.

NCHW in and out: a 4x4/4 patchify stem and LayerNorm, then four stages (a
LayerNorm and a 2x2/2 conv before stages 1-3) of blocks (a 7x7 depthwise
conv, LayerNorm, Linear to 4C, GELU, Linear back, the layer scale `gamma`,
the drop path, the residual), and a LayerNorm on each stage's output tap.
The LayerNorms normalise the channels, as the flax ones do over NHWC's last
axis, with eps 1e-6; GELU is flax's default tanh form. Names follow flax:
`stem_conv`, `stem_norm`, `down%d_norm`, `down%d_conv`,
`stage%d_block%d/{dwconv, norm, pwconv1, pwconv2, gamma}`, `out_norm%d`.

The layer scale starts at `layer_scale_init_value` (1.0 in the backbone,
as in JAX). The drop-path rates rise linearly from 0 to `drop_path_rate`
in float32 as jnp.linspace gives them; a train-mode forward with a rate
above 0 needs a torch.Generator (`forward(x, generator)`), which the train
step does not hand it (common.drop_path).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..common import drop_path, linspace_f32

__all__ = ["ConvNeXt"]

_SPECS = {
    "tiny": ([3, 3, 9, 3], [96, 192, 384, 768]),
    "small": ([3, 3, 27, 3], [96, 192, 384, 768]),
    "base": ([3, 3, 27, 3], [192, 384, 768, 1536]),
}


class ChannelsLayerNorm(nn.LayerNorm):
    """LayerNorm over the channel axis of an NCHW tensor (flax's LayerNorm
    over NHWC's last axis)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _Block(nn.Module):
    def __init__(self, dim, drop_rate=0.0, layer_scale_init_value=1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.layer_scale_init_value = layer_scale_init_value
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale_init_value)))
                      if layer_scale_init_value > 0 else None)
        self.drop_rate = drop_rate

    @torch.no_grad()
    def init_like_jax_(self):
        if self.gamma is not None:
            self.gamma.fill_(self.layer_scale_init_value)

    def forward(self, x, generator=None):
        y = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC: the Linears act on channels
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y)), approximate="tanh"))
        if self.gamma is not None:
            y = y * self.gamma
        y = drop_path(y, self.drop_rate, self.training, generator)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, in_channels=3, model_name="tiny", drop_path_rate=0.4,
                 layer_scale_init_value=1.0):
        super().__init__()
        if model_name not in _SPECS:
            raise ValueError("model_name must be in %s" % list(_SPECS))
        depths, dims = _SPECS[model_name]
        rates = linspace_f32(drop_path_rate, sum(depths))
        self.stem_conv = nn.Conv2d(in_channels, dims[0], 4, 4)
        self.stem_norm = ChannelsLayerNorm(dims[0], eps=1e-6)
        self.stages = []
        cur = 0
        for i in range(4):
            if i > 0:
                self.add_module("down%d_norm" % i, ChannelsLayerNorm(dims[i - 1], eps=1e-6))
                self.add_module("down%d_conv" % i, nn.Conv2d(dims[i - 1], dims[i], 2, 2))
            names = []
            for j in range(depths[i]):
                name = "stage%d_block%d" % (i, j)
                self.add_module(name, _Block(dims[i], rates[cur + j], layer_scale_init_value))
                names.append(name)
            self.stages.append(names)
            cur += depths[i]
            self.add_module("out_norm%d" % i, ChannelsLayerNorm(dims[i], eps=1e-6))
        self.out_channels = list(dims)

    def forward(self, x, generator=None):
        outs = []
        for i, names in enumerate(self.stages):
            if i == 0:
                x = self.stem_norm(self.stem_conv(x))
            else:
                x = getattr(self, "down%d_conv" % i)(getattr(self, "down%d_norm" % i)(x))
            for name in names:
                x = getattr(self, name)(x, generator)
            outs.append(getattr(self, "out_norm%d" % i)(x))
        return outs
