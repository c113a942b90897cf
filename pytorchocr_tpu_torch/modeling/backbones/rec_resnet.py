"""Recognition (height-collapsing) ResNet — port of
pytorchocr_tpu/modeling/backbones/rec_resnet.py.

NCHW: a 7x7 stride-1 stem, a 3x3/2 max pool padded with -inf, four stages
of basic (18, 34) or bottleneck (50, 101, 152) blocks whose strides are
(s, 1), so only the height shrinks, and a 2x2 average pool without
padding: (N, 3, 32, W) -> (N, out_channels, 1, W/4), what Im2Seq reads.
Block names mirror the flax ones (`layer%d_block%d/{conv1, conv2[, conv3],
downsample}`). A different class from the detection ResNet.
"""

import torch.nn.functional as F
from torch import nn

from ..common import ConvBNAct, max_pool

__all__ = ["ResNet"]

_SPECS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


class _RecBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = ConvBNAct(in_channels, planes, 3, (stride, 1))
        self.conv2 = ConvBNAct(planes, planes, 3, 1, act=None)
        self.downsample = (ConvBNAct(in_channels, planes, 1, (stride, 1), act=None)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class _RecBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels, planes, stride=1, downsample=False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = ConvBNAct(in_channels, planes, 1, 1)
        self.conv2 = ConvBNAct(planes, planes, 3, (stride, 1))
        self.conv3 = ConvBNAct(planes, out_ch, 1, 1, act=None)
        self.downsample = (ConvBNAct(in_channels, out_ch, 1, (stride, 1), act=None)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


class ResNet(nn.Module):
    def __init__(self, in_channels=3, layers=50):
        super().__init__()
        if layers not in _SPECS:
            raise ValueError("ResNet layers must be in %s" % list(_SPECS))
        block_type, counts = _SPECS[layers]
        block = _RecBasicBlock if block_type == "basic" else _RecBottleneck
        self.stem = ConvBNAct(in_channels, 64, 7, 1, padding=3)
        self.block_names = []
        ch = 64
        for stage, planes in enumerate([64, 128, 256, 512]):
            stride = 1 if stage == 0 else 2
            for i in range(counts[stage]):
                s = stride if i == 0 else 1
                need_ds = i == 0 and (s != 1 or ch != planes * block.expansion)
                name = "layer%d_block%d" % (stage + 1, i)
                self.add_module(name, block(ch, planes, s, need_ds))
                ch = planes * block.expansion
                self.block_names.append(name)
        self.out_channels = ch

    def forward(self, x):
        x = max_pool(self.stem(x), 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return F.avg_pool2d(x, 2, 2)
