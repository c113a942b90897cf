"""CSP-PAN neck — port of pytorchocr_tpu/modeling/necks/csp_pan.py.

1x1 leaky-relu ConvBNActs unify each level's channels (`conv_t%d`), a CSP
top-down pass (`td%d`: nearest upsample, concat, CSP block) and a bottom-up
pass (`down%d`: a stride-2 conv unit, `bu%d`: concat, CSP block). `mode:
table` returns the last bottom-up level (N5) and `fused_channels` is
`out_channels`; otherwise the levels are upsampled to 1/4 and concatenated
(4 x `out_channels`), optionally through the ASF attention
(`concat_attention`, necks/asf.py). NCHW; concats on dim 1 in the JAX
order. Names as flax's: `short`, `main`, `block%d`, `final`, `conv1`,
`conv2/{dw, pw | cna}`.
"""

import torch
from torch import nn

from ..common import ConvBNAct, resize_nearest
from .asf import ScaleFeatureSelection

__all__ = ["CSPPAN"]

_ACT = "leakyrelu"


class _ConvUnit(nn.Module):
    """A depthwise + pointwise pair (`dw`, `pw`) or one ConvBNAct (`cna`)."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, depthwise=False):
        super().__init__()
        self.depthwise = depthwise
        if depthwise:
            self.dw = ConvBNAct(in_ch, in_ch, kernel, stride, groups=in_ch, act=_ACT)
            self.pw = ConvBNAct(in_ch, out_ch, 1, 1, act=_ACT)
        else:
            self.cna = ConvBNAct(in_ch, out_ch, kernel, stride, act=_ACT)

    def forward(self, x):
        if self.depthwise:
            return self.pw(self.dw(x))
        return self.cna(x)


class _DarknetBottleneck(nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, expansion=0.5, add_identity=True,
                 depthwise=False):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = ConvBNAct(in_ch, hidden, 1, 1, act=_ACT)
        self.conv2 = _ConvUnit(hidden, out_ch, kernel, 1, depthwise)
        self.add_identity = add_identity and in_ch == out_ch

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class _CSPModule(nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, expand_ratio=0.5, num_blocks=1,
                 add_identity=True, depthwise=False):
        super().__init__()
        mid = int(out_ch * expand_ratio)
        self.short = ConvBNAct(in_ch, mid, 1, 1, act=_ACT)
        self.main = ConvBNAct(in_ch, mid, 1, 1, act=_ACT)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module("block%d" % i, _DarknetBottleneck(mid, mid, kernel, 1.0,
                                                              add_identity, depthwise))
        self.final = ConvBNAct(2 * mid, out_ch, 1, 1, act=_ACT)

    def forward(self, x):
        x_short = self.short(x)
        x_main = self.main(x)
        for i in range(self.num_blocks):
            x_main = getattr(self, "block%d" % i)(x_main)
        return self.final(torch.cat([x_main, x_short], dim=1))


class CSPPAN(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size=5, num_csp_blocks=1,
                 use_depthwise=True, mode="det", use_asf=False,
                 attention_type="scale_spatial"):
        super().__init__()
        oc = out_channels
        self.out_channels = oc
        self.mode = mode
        self.fused_channels = oc if mode == "table" else oc * 4
        self.n_levels = n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module("conv_t%d" % i, ConvBNAct(c, oc, 1, 1, act=_ACT))
        csp = dict(kernel=kernel_size, num_blocks=num_csp_blocks, add_identity=False,
                   depthwise=use_depthwise)
        for i in range(n - 1):
            self.add_module("td%d" % i, _CSPModule(2 * oc, oc, **csp))
            self.add_module("down%d" % i, _ConvUnit(oc, oc, kernel_size, 2, use_depthwise))
            self.add_module("bu%d" % i, _CSPModule(2 * oc, oc, **csp))
        self.concat_attention = (
            ScaleFeatureSelection(oc * 4, oc, attention_type=attention_type)
            if use_asf and mode != "table" else None
        )

    def forward(self, x):
        n = self.n_levels
        x = [getattr(self, "conv_t%d" % i)(xi) for i, xi in enumerate(x)]
        inner_outs = [x[-1]]
        for idx in range(n - 1, 0, -1):
            up = resize_nearest(inner_outs[0], 2)
            td = getattr(self, "td%d" % (n - 1 - idx))
            inner_outs.insert(0, td(torch.cat([up, x[idx - 1]], dim=1)))
        outs = [inner_outs[0]]
        for idx in range(n - 1):
            down = getattr(self, "down%d" % idx)(outs[-1])
            outs.append(getattr(self, "bu%d" % idx)(torch.cat([down, inner_outs[idx + 1]],
                                                             dim=1)))
        if self.mode == "table":
            return outs[-1]
        outs[-1] = resize_nearest(outs[-1], 8)
        outs[-2] = resize_nearest(outs[-2], 4)
        outs[-3] = resize_nearest(outs[-3], 2)
        fuse = torch.cat(outs, dim=1)
        if self.concat_attention is not None:
            fuse = self.concat_attention(fuse, outs)
        return fuse
