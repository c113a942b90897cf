"""Adaptive Scale Fusion (DB++ ASF) attention — port of
pytorchocr_tpu/modeling/necks/asf.py:30-143.

NCHW: the JAX channel means (`axis=-1`, asf.py:67,81) are means over dim 1,
its spatial means over dims 2 and 3, and `score[..., i:i+1]` (:139-141) is
`score[:, i:i+1]`. The scale_channel score (N, F, 1, 1) broadcasts over H and
W as the JAX `broadcast_to` (:133-137) does. Biases as flax has them:
`ScaleFeatureSelection.conv` has one (:101), `_conv` (:17) and `aw`
(:86-88) have none. The attention's convs are plain convolutions, float
under int8 PTQ too (JAX asf.py:18,86,101 are `nn.Conv`s), and the FPN in
front of it hands it a float map (fpn.py:39,66,99).
"""

import torch
from torch import nn

from ..common import BatchNorm2d

__all__ = ["ScaleFeatureSelection"]


def _conv(in_channels, out_channels, k, bias=False):
    return nn.Conv2d(in_channels, out_channels, k, padding=k // 2, bias=bias)


class ScaleChannelAttention(nn.Module):
    def __init__(self, in_planes, mid_channels, num_features):
        super().__init__()
        self.fc1 = _conv(in_planes, mid_channels, 1)
        self.bn = BatchNorm2d(mid_channels, eps=1e-5, momentum=0.1)  # flax momentum 0.9
        self.fc2 = _conv(mid_channels, num_features, 1)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        g = self.bn(self.fc1(g)).relu()
        return torch.softmax(self.fc2(g), dim=1)


class ScaleChannelSpatialAttention(nn.Module):
    def __init__(self, in_planes, mid_channels, num_features):
        super().__init__()
        self.cw1 = _conv(in_planes, mid_channels, 1)
        self.cw2 = _conv(mid_channels, in_planes, 1)
        self.sw1 = _conv(1, 1, 3)
        self.sw2 = _conv(1, 1, 1)
        self.aw = _conv(in_planes, num_features, 1)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        channel_atten = torch.sigmoid(self.cw2(self.cw1(g).relu()))
        global_x = channel_atten + x
        s = self.sw1(global_x.mean(dim=1, keepdim=True)).relu()
        global_x = torch.sigmoid(self.sw2(s)) + global_x
        return torch.sigmoid(self.aw(global_x))


class ScaleSpatialAttention(nn.Module):
    def __init__(self, in_planes, num_features):
        super().__init__()
        self.sw1 = _conv(1, 1, 3)
        self.sw2 = _conv(1, 1, 1)
        self.aw = _conv(in_planes, num_features, 1)

    def forward(self, x):
        s = self.sw1(x.mean(dim=1, keepdim=True)).relu()
        global_x = torch.sigmoid(self.sw2(s)) + x
        return torch.sigmoid(self.aw(global_x))


class ScaleFeatureSelection(nn.Module):
    """3x3 conv (with bias) of the concatenated levels to `inter_channels`,
    an attention score per level, and each level scaled by its score, the
    levels concatenated again."""

    def __init__(self, in_channels, inter_channels, out_features_num=4,
                 attention_type="scale_spatial"):
        super().__init__()
        self.out_features_num = out_features_num
        self.conv = _conv(in_channels, inter_channels, 3, bias=True)
        if attention_type == "scale_spatial":
            self.att = ScaleSpatialAttention(inter_channels, out_features_num)
        elif attention_type == "scale_channel_spatial":
            self.att = ScaleChannelSpatialAttention(inter_channels, inter_channels // 4,
                                                    out_features_num)
        elif attention_type == "scale_channel":
            self.att = ScaleChannelAttention(inter_channels, inter_channels // 2,
                                             out_features_num)
        else:
            raise ValueError("unknown attention_type %s" % attention_type)

    def forward(self, concat_x, features_list):
        if len(features_list) != self.out_features_num:
            raise ValueError("ScaleFeatureSelection takes %d levels, got %d"
                             % (self.out_features_num, len(features_list)))
        score = self.att(self.conv(concat_x))
        return torch.cat([score[:, i : i + 1] * f for i, f in enumerate(features_list)], dim=1)
