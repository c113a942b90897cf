"""CRNN VGG backbone — port of pytorchocr_tpu/modeling/backbones/rec_vgg.py.

NCHW; input (N, C, 32, W) -> output (N, out_channels, 1, W/4 + 1): the same
conv/pool schedule (two 2x2 pools, two (2,2)/(2,1) pools with (0,1) width
padding, a final 2x1 conv without padding that collapses the height).
"""

from torch import nn

from ..common import ConvBNAct, max_pool

__all__ = ["VGG"]

_CFG = {
    ("v1", 0.5): [32, 64, 128, 128, 256, 256, 512],
    ("v1", 1.0): [64, 128, 256, 256, 512, 512, 512],
    ("v2", 0.5): [32, 64, 128, 128, 256, 256, 256],
    ("v2", 1.0): [24, 128, 256, 256, 512, 512, 512],
}
_KS = {"v1": [3, 3, 3, 3, 3, 3, 2], "v2": [5, 3, 3, 3, 3, 3, 2]}
_PS = {"v1": [1, 1, 1, 1, 1, 1, 0], "v2": [2, 1, 1, 1, 1, 1, 0]}
_SS = {"v1": [1, 1, 1, 1, 1, 1, 1], "v2": [2, 1, 1, 1, 1, 1, 1]}
_BN_STAGES = (2, 4, 6)


class _ConvRelu(nn.Module):
    """One VGG stage: v1 = conv(+BN)+ReLU; v2 = depthwise + 1x1 project."""

    def __init__(self, idx, model_name, n_in, n_out, bn, leaky_relu=False):
        super().__init__()
        ks, ps, ss = _KS[model_name][idx], _PS[model_name][idx], _SS[model_name][idx]
        if model_name == "v1":
            act = "leakyrelu0.2" if leaky_relu else "relu"  # slope 0.2, as the JAX stage
            self.add_module("conv%d" % idx, ConvBNAct(
                n_in, n_out, ks, ss, padding=ps, use_bias=True, use_bn=bn, act=act
            ))
        elif idx == 0:
            self.add_module("conv%d" % idx, ConvBNAct(
                n_in, n_out, ks, ss, padding=ps, use_bias=True, use_bn=False
            ))
        else:
            self.add_module("convdw%d" % idx, ConvBNAct(
                n_in, n_in, ks, ss, padding=ps, groups=n_in, use_bias=True, use_bn=bn
            ))
            self.add_module("convproject%d" % idx, ConvBNAct(
                n_in, n_out, 1, 1, padding=0, use_bias=True, use_bn=bn
            ))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class VGG(nn.Module):
    def __init__(self, in_channels=3, model_name="v1", scale=1.0, leaky_relu=False):
        super().__init__()
        if (model_name, scale) not in _CFG:
            raise ValueError("supported (model_name, scale): %s" % list(_CFG))
        nm = _CFG[(model_name, scale)]
        self.model_name = model_name
        n_in = in_channels
        for i in range(7):
            self.add_module("stage%d" % i, _ConvRelu(
                i, model_name, n_in, nm[i], i in _BN_STAGES, leaky_relu
            ))
            n_in = nm[i]
        self.out_channels = nm[-1]

    def forward(self, x):
        x = self.stage0(x)
        if self.model_name == "v1":
            x = max_pool(x, 2, 2)  # H/2
        x = self.stage1(x)
        x = max_pool(x, 2, 2)  # H/4, W/4 (v1) | v2: the stride-2 stem already
        x = self.stage3(self.stage2(x))
        x = max_pool(x, (2, 2), (2, 1), (0, 1))  # H/8
        x = self.stage5(self.stage4(x))
        x = max_pool(x, (2, 2), (2, 1), (0, 1))  # H/16
        return self.stage6(x)  # 2x1 conv, no padding: H collapses to 1
