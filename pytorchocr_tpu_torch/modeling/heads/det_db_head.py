"""DB head — port of pytorchocr_tpu/modeling/heads/det_db_head.py.

Two conv + 2x deconv towers producing full-resolution probability and
threshold maps; the train output adds the differentiable binarization
1/(1+exp(-k(P-T))). Input NCHW; the output keeps the JAX layout, NHWC:
{"maps": (N, H, W, 1)} at eval, {"maps": (N, H, W, 3)} in training mode
(the DB loss reads it: losses/det_db_loss.py).

The deconvs are torch ConvTranspose2d(2, stride 2). flax's ConvTranspose
applies the spatially flipped kernel, so the weight bridge flips it
(utils/weights.py).

int8 PTQ (ops/quant.py, JAX det_db_head.py:29-75, `q8_head`): conv1 takes
the FPN's int8 fused map and emits int8; the deconvs compute in the compute
dtype on dequantized inputs, and the bn2/relu output is requantized with a
calibrated absmax (`mid_absmax`) before deconv2.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import quant
from ..common import BatchNorm2d, ConvBNAct

__all__ = ["DBHead"]


class _Tower(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        c = in_channels // 4
        self.conv1 = ConvBNAct(in_channels, c, 3, 1, emit_q=True)
        self.deconv1 = nn.ConvTranspose2d(c, c, 2, 2)
        self.bn2 = BatchNorm2d(c, eps=1e-5, momentum=0.1)
        self.deconv2 = nn.ConvTranspose2d(c, 1, 2, 2)
        self.qmode = None
        self.mid_absmax = quant.AbsMax()

    def forward(self, x):
        x = self.conv1(x)
        x = F.relu(self.bn2(self.deconv1(quant.dequant(x, quant.compute_dtype(x)))))
        qmode = quant.quantizing(self)
        if qmode == "calibrate":
            self.mid_absmax.observe(x)
        elif qmode == "int8":
            x = quant.qtensor_from(x, self.mid_absmax.get())
            x = quant.dequant(x, quant.compute_dtype(x))
        return torch.sigmoid(self.deconv2(x).float())


class DBHead(nn.Module):
    def __init__(self, in_channels, k=50):
        super().__init__()
        self.k = k
        self.binarize = _Tower(in_channels)
        self.thresh = _Tower(in_channels)

    def forward(self, x, targets=None):
        shrink = self.binarize(x)
        if not self.training:
            return {"maps": shrink.permute(0, 2, 3, 1)}
        thresh = self.thresh(x)
        binary = torch.sigmoid(self.k * (shrink - thresh))
        return {"maps": torch.cat([shrink, thresh, binary], dim=1).permute(0, 2, 3, 1)}
