"""MobileNetV3 — port of pytorchocr_tpu/modeling/backbones/det_mobilenet_v3.py.

`mobilenet_v3_conf`, the squeeze-excitation `_SE` and `InvertedResidual`
(:19-120), which the recognition / direction-classifier variant
(rec_mobilenet_v3.py) builds on, and the detection `MobileNetV3` (:123-164):
a stride-2 hard_swish stem, the blocks, a 1x1 hard_swish `lastconv` to 6x the
last width; the four feature maps are the inputs of the stride-2 blocks past
`start_idx` (2 for large, 0 for small) and the lastconv's output. NCHW; BN
eps 1e-3 and flax momentum 0.99 (torch 0.01) throughout.

int8 PTQ (ops/quant.py), as the JAX package quantizes this backbone
(:107-116, :148-159): every ConvBNAct (the stem, expand, the depthwise k x k
with groups = exp, project, lastconv) runs its conv in int8 and emits no
int8, so each quantizes its own float input with its calibrated
`act_absmax`; BN, hardswish, the residual add and the SE's plain convs stay
float (:87-90).
"""

from torch import nn

from ..common import ConvBNAct, hard_sigmoid, make_divisible

__all__ = ["mobilenet_v3_conf", "InvertedResidual", "MobileNetV3"]


def mobilenet_v3_conf(arch, width_mult=1.0, use_se=True, rec=False):
    """(in, kernel, exp, out, se, act, stride) rows; the rec variant turns
    the C3 stride 2 into 1."""

    def adj(c):
        return make_divisible(c * width_mult, 8)

    c3_stride = 1 if rec else 2
    if arch == "large":
        rows = [
            (16, 3, 16, 16, False, "RE", 1),
            (16, 3, 64, 24, False, "RE", 2),
            (24, 3, 72, 24, False, "RE", 1),
            (24, 5, 72, 40, use_se, "RE", 2),
            (40, 5, 120, 40, use_se, "RE", 1),
            (40, 5, 120, 40, use_se, "RE", 1),
            (40, 3, 240, 80, False, "HS", c3_stride),
            (80, 3, 200, 80, False, "HS", 1),
            (80, 3, 184, 80, False, "HS", 1),
            (80, 3, 184, 80, False, "HS", 1),
            (80, 3, 480, 112, use_se, "HS", 1),
            (112, 3, 672, 112, use_se, "HS", 1),
            (112, 5, 672, 160, True, "HS", 2),
            (160, 5, 960, 160, True, "HS", 1),
            (160, 5, 960, 160, True, "HS", 1),
        ]
    elif arch == "small":
        rows = [
            (16, 3, 16, 16, use_se, "RE", 2),
            (16, 3, 72, 24, False, "RE", 2),
            (24, 3, 88, 24, False, "RE", 1),
            (24, 5, 96, 40, use_se, "HS", c3_stride),
            (40, 5, 240, 40, use_se, "HS", 1),
            (40, 5, 240, 40, use_se, "HS", 1),
            (40, 5, 120, 48, use_se, "HS", 1),
            (48, 5, 144, 48, use_se, "HS", 1),
            (48, 5, 288, 96, True, "HS", 2),
            (96, 5, 576, 96, True, "HS", 1),
            (96, 5, 576, 96, True, "HS", 1),
        ]
    else:
        raise ValueError("Unsupported model type {}".format(arch))
    return [
        dict(in_ch=adj(r[0]), kernel=r[1], exp=adj(r[2]), out=adj(r[3]), se=r[4],
             act="hardswish" if r[5] == "HS" else "relu", stride=r[6])
        for r in rows
    ]


class _SE(nn.Module):
    """torchvision SqueezeExcitation: squeeze to make_divisible(c // 4, 8),
    relu, then hard_sigmoid (relu6(x + 3) / 6)."""

    def __init__(self, channels):
        super().__init__()
        squeeze = make_divisible(channels // 4, 8)
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(self.fc1(s).relu())
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    """expand 1x1 (when exp != in) -> depthwise k x k (stride s, or (s, 1)
    for the rec variant) -> SE -> project 1x1; the residual only at stride 1
    with in == out. BN eps 1e-3, flax momentum 0.99 (torch 0.01)."""

    def __init__(self, cnf, rec=False):
        super().__init__()
        bn = dict(bn_eps=1e-3, bn_momentum=0.99)
        self.use_res = cnf["stride"] == 1 and cnf["in_ch"] == cnf["out"]
        self.expand = (
            ConvBNAct(cnf["in_ch"], cnf["exp"], 1, 1, act=cnf["act"], **bn)
            if cnf["exp"] != cnf["in_ch"] else None
        )
        stride = (cnf["stride"], 1) if rec else cnf["stride"]
        self.dw = ConvBNAct(cnf["exp"], cnf["exp"], cnf["kernel"], stride, groups=cnf["exp"],
                            act=cnf["act"], **bn)
        self.se = _SE(cnf["exp"]) if cnf["se"] else None
        self.project = ConvBNAct(cnf["exp"], cnf["out"], 1, 1, act=None, **bn)

    def forward(self, x):
        out = x if self.expand is None else self.expand(x)
        out = self.dw(out)
        if self.se is not None:
            out = self.se(out)
        out = self.project(out)
        return out + x if self.use_res else out


class MobileNetV3(nn.Module):
    """The detection backbone: four feature maps (det_mobilenet_v3.py:123)."""

    int8_ported = True  # ops.quant.unsupported: its int8 regions are ported

    def __init__(self, in_channels=3, model_name="large", width_mult=1.0, use_se=True):
        super().__init__()
        if width_mult not in (0.35, 0.5, 0.75, 1.0, 1.25):
            raise ValueError("MobileNetV3 width_mult must be one of 0.35, 0.5, 0.75, 1.0, 1.25")
        conf = mobilenet_v3_conf(model_name, width_mult, use_se)
        bn = dict(bn_eps=1e-3, bn_momentum=0.99)
        start_idx = 2 if model_name == "large" else 0
        self.taps = [i for i, cnf in enumerate(conf) if cnf["stride"] == 2 and i > start_idx]
        self.out_channels = [conf[i]["in_ch"] for i in self.taps] + [6 * conf[-1]["out"]]
        self.conv1 = ConvBNAct(in_channels, conf[0]["in_ch"], 3, 2, act="hardswish", **bn)
        self.block_names = ["block%d" % i for i in range(len(conf))]
        for name, cnf in zip(self.block_names, conf):
            self.add_module(name, InvertedResidual(cnf))
        self.lastconv = ConvBNAct(conf[-1]["out"], self.out_channels[-1], 1, 1,
                                  act="hardswish", **bn)

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for i, name in enumerate(self.block_names):
            if i in self.taps:
                outs.append(x)
            x = getattr(self, name)(x)
        outs.append(self.lastconv(x))
        return outs
