"""Recognition / direction-classifier MobileNetV3 — port of
pytorchocr_tpu/modeling/backbones/rec_mobilenet_v3.py:17-50.

Stride-2 stem on both axes, (s, 1) depthwise strides inside the stack (only
the height shrinks), the C3 stride dropped to 1, a 1x1 `lastconv` to 6x the
last width and a final 2x2/2 average pool. NCHW. The JAX class defaults to
`in_channels=1` and flax infers the real count; here the channel count is the
config's (`build_base_model` passes it: 3 for cls_mbv3small.yml, RGB).
"""

import torch.nn.functional as F
from torch import nn

from ..common import ConvBNAct
from .det_mobilenet_v3 import InvertedResidual, mobilenet_v3_conf

__all__ = ["MobileNetV3"]


class MobileNetV3(nn.Module):
    def __init__(self, in_channels=3, model_name="small", width_mult=1.0, use_se=True):
        super().__init__()
        if width_mult not in (0.35, 0.5, 0.75, 1.0, 1.25):
            raise ValueError("MobileNetV3 width_mult must be one of 0.35, 0.5, 0.75, 1.0, 1.25")
        conf = mobilenet_v3_conf(model_name, width_mult, use_se, rec=True)
        bn = dict(bn_eps=1e-3, bn_momentum=0.99)
        self.conv1 = ConvBNAct(in_channels, conf[0]["in_ch"], 3, 2, act="hardswish", **bn)
        self.block_names = ["block%d" % i for i in range(len(conf))]
        for name, cnf in zip(self.block_names, conf):
            self.add_module(name, InvertedResidual(cnf, rec=True))
        self.out_channels = 6 * conf[-1]["out"]
        self.lastconv = ConvBNAct(conf[-1]["out"], self.out_channels, 1, 1, act="hardswish", **bn)

    def forward(self, x):
        x = self.conv1(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return F.avg_pool2d(self.lastconv(x), 2, 2)
