"""PAN neck: cascaded FPEMs and the FFM fusion — port of
pytorchocr_tpu/modeling/necks/fpem_ffm.py.

1x1 laterals to `out_channels`, `fpem_num` feature pyramid enhancement
modules (up then down path of depthwise 3x3 + 1x1 smoothing), then the four
levels upsampled to 1/4 and concatenated: fused_channels = 4*out_channels.
v2 (PAN++) adds each FPEM's input to its output and fuses the last FPEM;
v1 fuses the sum of all FPEMs. NCHW. `use_asf` puts the fused map through
the ASF attention, `ScaleFeatureSelection(4 * out_channels, out_channels)`
(JAX fpem_ffm.py:104-108), whose convs stay float under int8 PTQ.
"""

import torch
from torch import nn

from ..common import ConvBNAct, resize_nearest
from .asf import ScaleFeatureSelection

__all__ = ["FPEM_FFM"]


class _DWSmooth(nn.Module):
    """depthwise 3x3 (stride s, padding 1) -> 1x1 conv + BN + ReLU."""

    def __init__(self, planes, stride=1):
        super().__init__()
        self.dw = nn.Conv2d(planes, planes, 3, stride, padding=1, groups=planes, bias=False)
        self.smooth = ConvBNAct(planes, planes, 1, 1, padding=0, act="relu")

    def forward(self, x):
        return self.smooth(self.dw(x))


class FPEM(nn.Module):
    def __init__(self, planes, mode="v2"):
        super().__init__()
        self.mode = mode
        for name, stride in (("l3_1", 1), ("l2_1", 1), ("l1_1", 1),
                             ("l2_2", 2), ("l3_2", 2), ("l4_2", 2)):
            self.add_module(name, _DWSmooth(planes, stride))

    def forward(self, x):
        f1, f2, f3, f4 = x

        def up(a, b):
            return resize_nearest(a, 2) + b

        f3_ = self.l3_1(up(f4, f3))
        f2_ = self.l2_1(up(f3_, f2))
        f1_ = self.l1_1(up(f2_, f1))
        f2_ = self.l2_2(up(f2_, f1_))
        f3_ = self.l3_2(up(f3_, f2_))
        f4_ = self.l4_2(up(f4, f3_))
        if self.mode == "v2":
            return [f1 + f1_, f2 + f2_, f3 + f3_, f4 + f4_]
        return [f1_, f2_, f3_, f4_]


class FPEM_FFM(nn.Module):
    int8_ported = True  # ops.quant.unsupported: its int8 regions are ported

    def __init__(self, in_channels, out_channels=128, mode="v2", fpem_num=2,
                 use_asf=False, attention_type="scale_spatial"):
        super().__init__()
        if mode not in ("v1", "v2"):
            raise ValueError("FPEM_FFM mode must be v1 or v2, got %r" % mode)
        oc = out_channels
        self.mode = mode
        self.out_channels = oc
        self.fused_channels = oc * 4
        for name, c in zip(("in2", "in3", "in4", "in5"), in_channels):
            self.add_module(name, ConvBNAct(c, oc, 1, 1, padding=0, act="relu"))
        self.fpem_names = ["fpem_%d" % (i + 1) for i in range(fpem_num)]
        for name in self.fpem_names:
            self.add_module(name, FPEM(oc, mode))
        self.concat_attention = (
            ScaleFeatureSelection(oc * 4, oc, attention_type=attention_type) if use_asf else None)

    def forward(self, x):
        c2, c3, c4, c5 = x
        feats = [self.in2(c2), self.in3(c3), self.in4(c4), self.in5(c5)]
        fpems = []
        for name in self.fpem_names:
            feats = getattr(self, name)(feats)
            fpems.append(feats)
        if self.mode == "v2":
            f1, f2, f3, f4 = fpems[-1]
        else:
            f1, f2, f3, f4 = (sum(level) for level in zip(*fpems))
        feats = [f1, resize_nearest(f2, 2), resize_nearest(f3, 4), resize_nearest(f4, 8)]
        fuse = torch.cat(feats, dim=1)
        if self.concat_attention is not None:
            fuse = self.concat_attention(fuse, feats)
        return fuse
