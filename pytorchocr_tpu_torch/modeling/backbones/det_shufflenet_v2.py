"""ShuffleNetV2 detection backbone — port of
pytorchocr_tpu/modeling/backbones/det_shufflenet_v2.py.

NCHW. The feature maps are [the stem after its 3x3/2 max-pool (1/4),
stage2 (1/8), stage3 (1/16), conv5 (1/32)] (:78-92). A stride-1 block splits
the channels in halves (the JAX `jnp.split`, :47) and `channel_shuffle`
(:23-27) gives the JAX channel order on dim 1.

int8 PTQ (ops/quant.py): the depthwise and 1x1 ConvBNActs run int8 on
their own float inputs (no `emit_q`, JAX :40-55, 76, 89); the split, the
concat, `channel_shuffle` and the max-pool stay float.
"""

import torch
from torch import nn

from ..common import ConvBNAct, max_pool

__all__ = ["ShuffleNetV2", "channel_shuffle"]

_SPECS = {
    0.1: ([2, 4, 2], [16, 24, 48, 96, 512]),
    0.5: ([4, 8, 4], [24, 48, 96, 192, 1024]),
    1.0: ([4, 8, 4], [24, 116, 232, 464, 1024]),
    1.5: ([4, 8, 4], [24, 176, 352, 704, 1024]),
    2.0: ([4, 8, 4], [24, 244, 488, 976, 2048]),
}


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride):
        super().__init__()
        bf = oup // 2
        self.stride = stride
        if stride > 1:
            self.b1dw = ConvBNAct(inp, inp, 3, stride, groups=inp, act=None)
            self.b1pw = ConvBNAct(inp, bf, 1, 1, act="relu")
        b2_in = inp if stride > 1 else inp // 2
        self.b2pw1 = ConvBNAct(b2_in, bf, 1, 1, act="relu")
        self.b2dw = ConvBNAct(bf, bf, 3, stride, groups=bf, act=None)
        self.b2pw2 = ConvBNAct(bf, bf, 1, 1, act="relu")

    def forward(self, x):
        if self.stride > 1:
            b1, x2 = self.b1pw(self.b1dw(x)), x
        else:
            b1, x2 = x.chunk(2, dim=1)
        b2 = self.b2pw2(self.b2dw(self.b2pw1(x2)))
        return channel_shuffle(torch.cat([b1, b2], dim=1), 2)


class ShuffleNetV2(nn.Module):
    int8_ported = True  # ops.quant.unsupported: its int8 regions are ported

    def __init__(self, in_channels=3, scale=0.5):
        super().__init__()
        if scale not in _SPECS:
            raise ValueError("ShuffleNetV2 scale must be one of %s" % list(_SPECS))
        repeats, ch = _SPECS[scale]
        self.out_channels = [ch[0], ch[1], ch[2], ch[4]]
        self.conv1 = ConvBNAct(in_channels, ch[0], 3, 2, act="relu")
        self.stage_names = []
        inp = ch[0]
        for si, (rep, oc) in enumerate(zip(repeats, ch[1:4])):
            names = []
            for i in range(rep):
                name = "stage%d_%d" % (si + 2, i)
                self.add_module(name, InvertedResidual(inp, oc, 2 if i == 0 else 1))
                names.append(name)
                inp = oc
            self.stage_names.append(names)
        self.conv5 = ConvBNAct(inp, ch[4], 1, 1, padding=0, act="relu")

    def forward(self, x):
        x = max_pool(self.conv1(x), 3, 2, 1)
        outs = [x]
        for si, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if si < 2:
                outs.append(x)
        outs.append(self.conv5(x))
        return outs
