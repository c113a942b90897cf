"""PP-LCNet, the table / detection backbone — port of
pytorchocr_tpu/modeling/backbones/det_pplcnet.py.

A stride-2 hardswish stem (`conv1`), then depthwise-separable blocks
(`blocks%d_%d`: a depthwise `dw` ConvBNAct with hardswish, SE (`se`) in the
last stage, a 1x1 `pw` ConvBNAct with hardswish). The four feature maps are
the outputs of stages 3-6 (strides 4, 8, 16, 32). NCHW; BN eps 1e-5, flax
momentum 0.9. Names as flax's, so the weight bridge carries them across.
"""

from torch import nn

from ..common import ConvBNAct, SEModule, make_divisible

__all__ = ["PPLCNet"]

NET_CONFIG = {
    # k, in_c, out_c, s, use_se
    "blocks2": [[3, 16, 32, 1, False]],
    "blocks3": [[3, 32, 64, 2, False], [3, 64, 64, 1, False]],
    "blocks4": [[3, 64, 128, 2, False], [3, 128, 128, 1, False]],
    "blocks5": [
        [3, 128, 256, 2, False], [5, 256, 256, 1, False], [5, 256, 256, 1, False],
        [5, 256, 256, 1, False], [5, 256, 256, 1, False], [5, 256, 256, 1, False],
    ],
    "blocks6": [[5, 256, 512, 2, True], [5, 512, 512, 1, True]],
}


class _DPBlock(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, use_se):
        super().__init__()
        self.dw = ConvBNAct(in_ch, in_ch, kernel, stride, groups=in_ch, act="hardswish")
        self.se = SEModule(in_ch) if use_se else None
        self.pw = ConvBNAct(in_ch, out_ch, 1, 1, act="hardswish")

    def forward(self, x):
        x = self.dw(x)
        if self.se is not None:
            x = self.se(x)
        return self.pw(x)


class PPLCNet(nn.Module):
    def __init__(self, in_channels=3, scale=1.0):
        super().__init__()
        self.out_channels = [int(NET_CONFIG["blocks%d" % b][-1][2] * scale) for b in (3, 4, 5, 6)]
        ch = make_divisible(16 * scale)
        self.conv1 = ConvBNAct(in_channels, ch, 3, 2, act="hardswish")
        self.stages = []
        for b in range(2, 7):
            names = []
            for j, (k, _, out_c, st, se) in enumerate(NET_CONFIG["blocks%d" % b]):
                out = make_divisible(out_c * scale)
                self.add_module("blocks%d_%d" % (b, j), _DPBlock(ch, out, k, st, se))
                names.append("blocks%d_%d" % (b, j))
                ch = out
            self.stages.append(names)

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for b, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if b > 0:
                outs.append(x)
        return outs
