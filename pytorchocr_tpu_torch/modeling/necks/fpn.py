"""FPN neck — port of pytorchocr_tpu/modeling/necks/fpn.py.

1x1 laterals + top-down nearest-upsample-add + 3x3 smoothing; mode "DB"
concatenates four out_channels/4 maps back to out_channels, otherwise four
out_channels maps make 4*out_channels. NCHW.

int8 PTQ (ops/quant.py): the laterals take the backbone's int8 QTensors;
in DB mode the fused map is int8 (JAX fpn.py:96-128, `q8_fpn_fuse`): p5..p2
are quantized with one shared calibrated absmax (`fuse_absmax`), so the
concatenation of their int8 payloads, upsampled x8/x4/x2, is one QTensor for
the head. The top-down adds stay float (`q8_fpn_topdown` is off in the JAX
package).

`use_asf` (DB++): the fused map goes through the ASF attention,
`ScaleFeatureSelection(fused_channels, sc)` (JAX fpn.py:139-146). The JAX
FPN keys its int8 regions off under `use_asf` (fpn.py:39,66,99), so the
fused map here has no `fuse_absmax` then and stays float; the laterals
still run int8 on the backbone's QTensors and hand on float, the smoothing
convs quantize their float inputs, and the ASF's own convs stay float.
"""

import torch
from torch import nn

from ...ops import quant
from ..common import ConvBNAct, resize_nearest
from .asf import ScaleFeatureSelection

__all__ = ["FPN"]


class FPN(nn.Module):
    int8_ported = True  # ops.quant.unsupported: its int8 regions are ported

    def __init__(self, in_channels, out_channels=256, mode=None, use_asf=False,
                 attention_type="scale_spatial"):
        super().__init__()
        oc = out_channels
        self.mode = mode
        self.fused_channels = oc if mode == "DB" else oc * 4
        sc = oc // 4 if mode == "DB" else oc
        c2, c3, c4, c5 = in_channels
        self.in5 = ConvBNAct(c5, oc, 1, 1)
        self.in4 = ConvBNAct(c4, oc, 1, 1)
        self.in3 = ConvBNAct(c3, oc, 1, 1)
        self.in2 = ConvBNAct(c2, oc, 1, 1)
        self.out5 = ConvBNAct(oc, sc, 3, 1)
        self.out4 = ConvBNAct(oc, sc, 3, 1)
        self.out3 = ConvBNAct(oc, sc, 3, 1)
        self.out2 = ConvBNAct(oc, sc, 3, 1)
        self.qmode = None
        self.fuse_absmax = quant.AbsMax() if mode == "DB" and not use_asf else None
        self.concat_attention = (
            ScaleFeatureSelection(self.fused_channels, sc, attention_type=attention_type)
            if use_asf else None)

    def forward(self, x):
        c2, c3, c4, c5 = x
        in5, in4, in3, in2 = self.in5(c5), self.in4(c4), self.in3(c3), self.in2(c2)
        out4 = resize_nearest(in5, 2) + in4
        out3 = resize_nearest(out4, 2) + in3
        out2 = resize_nearest(out3, 2) + in2
        p5, p4, p3, p2 = self.out5(in5), self.out4(out4), self.out3(out3), self.out2(out2)
        qmode = quant.quantizing(self) if self.fuse_absmax is not None else None
        if qmode == "calibrate":
            self.fuse_absmax.observe(p5, p4, p3, p2)
        elif qmode == "int8":
            absmax = self.fuse_absmax.get()
            q5, q4, q3, q2 = (quant.qtensor_from(p, absmax) for p in (p5, p4, p3, p2))
            payload = torch.cat([quant.repeat_nearest(q5.q, 8), quant.repeat_nearest(q4.q, 4),
                                 quant.repeat_nearest(q3.q, 2), q2.q], dim=1)
            return quant.QTensor(payload, q2.scale)
        p5, p4, p3 = resize_nearest(p5, 8), resize_nearest(p4, 4), resize_nearest(p3, 2)
        feats = [p5, p4, p3, p2] if self.mode == "DB" else [p2, p3, p4, p5]
        fuse = torch.cat(feats, dim=1)
        if self.concat_attention is not None:
            fuse = self.concat_attention(fuse, feats)
        return fuse
