"""Detection ResNet v1.5 — port of
pytorchocr_tpu/modeling/backbones/det_resnet.py.

ResNet 18/34 (BasicBlock) and 50/101/152 (Bottleneck), NCHW, returning the
feature maps C2..C5 at strides 1/4..1/32. `mode_3x3` stem and last-stage
dilation as in the JAX version. Under int8 PTQ (ops/quant.py) every tensor
a block writes is an int8 QTensor: the 7x7 stem, conv1..3 and downsample
emit int8, the max pool pools int8, and the residual tails requantize
(JAX det_resnet.py:35-135). Not carried into the port:
`stem_space_to_depth` (a TPU layout trick, off by default; ROADMAP.md A.15).
"""

import torch.nn.functional as F
from torch import nn

from ...ops import quant
from ..common import ConvBNAct, finish_residual, quant_max_pool

__all__ = ["ResNet"]

_SPECS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels, planes, stride=1, downsample=False, dilation=1):
        super().__init__()
        self.conv1 = ConvBNAct(in_channels, planes, 3, stride, dilation=dilation, emit_q=True)
        self.conv2 = ConvBNAct(planes, planes, 3, 1, dilation=dilation, act=None, emit_q=True)
        self.downsample = (
            ConvBNAct(in_channels, planes, 1, stride, act=None, emit_q=True)
            if downsample else None
        )
        self.qmode = None
        self.out_absmax = quant.AbsMax()

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return finish_residual(self, out, identity, F.relu)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels, planes, stride=1, downsample=False, dilation=1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = ConvBNAct(in_channels, planes, 1, 1, emit_q=True)
        # v1.5: the stride sits in the 3x3
        self.conv2 = ConvBNAct(planes, planes, 3, stride, dilation=dilation, emit_q=True)
        self.conv3 = ConvBNAct(planes, out_ch, 1, 1, act=None, emit_q=True)
        self.downsample = (
            ConvBNAct(in_channels, out_ch, 1, stride, act=None, emit_q=True)
            if downsample else None
        )
        self.qmode = None
        self.out_absmax = quant.AbsMax()

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return finish_residual(self, out, identity, F.relu)


class ResNet(nn.Module):
    int8_ported = True  # ops.quant.unsupported: its int8 regions are ported

    def __init__(self, in_channels=3, layers=18, mode_3x3=False,
                 dilation_last=False, stem_space_to_depth=False):
        super().__init__()
        if layers not in _SPECS:
            raise ValueError("ResNet layers must be in %s" % list(_SPECS))
        if stem_space_to_depth:
            raise NotImplementedError(
                "ResNet stem_space_to_depth is not carried into the port (ROADMAP.md A.15)"
            )
        block_type, counts = _SPECS[layers]
        block = BasicBlock if block_type == "basic" else Bottleneck
        self.mode_3x3 = mode_3x3
        if mode_3x3:
            self.stem1 = ConvBNAct(in_channels, 32, 3, 2)
            self.stem2 = ConvBNAct(32, 32, 3, 1)
            self.stem3 = ConvBNAct(32, 64, 3, 1)
        else:
            self.stem = ConvBNAct(in_channels, 64, 7, 2, padding=3, emit_q=True)
        self.block_names = []
        ch = 64
        for stage, planes in enumerate([64, 128, 256, 512]):
            stride, dilation = (1 if stage == 0 else 2), 1
            if stage == 3 and dilation_last:
                stride, dilation = 1, 2
            names = []
            for i in range(counts[stage]):
                s = stride if i == 0 else 1
                need_ds = i == 0 and (s != 1 or ch != planes * block.expansion)
                name = "layer%d_block%d" % (stage + 1, i)
                self.add_module(name, block(ch, planes, s, need_ds, dilation))
                ch = planes * block.expansion
                names.append(name)
            self.block_names.append(names)
        self.out_channels = [64 * block.expansion * m for m in (1, 2, 4, 8)]

    def forward(self, x):
        if self.mode_3x3:
            x = self.stem3(self.stem2(self.stem1(x)))
        else:
            x = self.stem(x)
        x = quant_max_pool(x, 3, 2, 1)
        outs = []
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs
