"""PSE head — port of pytorchocr_tpu/modeling/heads/det_pse_head.py.

conv3x3 (bias) + BN + ReLU -> conv1x1 to `out_channels` kernel logit maps at
the input's resolution (1/4 of the page). Input NCHW; the output keeps the
JAX layout, NHWC float32: {"maps": (N, H, W, out_channels)}, which
losses/det_pse_loss.py trains.
"""

from torch import nn

from ..common import ConvBNAct

__all__ = ["PSEHead"]


class PSEHead(nn.Module):
    def __init__(self, in_channels, hidden_dim=256, out_channels=7):
        super().__init__()
        self.conv1 = ConvBNAct(in_channels, hidden_dim, 3, 1, use_bias=True, act="relu")
        self.conv2 = nn.Conv2d(hidden_dim, out_channels, 1, bias=True)

    def forward(self, x, targets=None):
        return {"maps": self.conv2(self.conv1(x)).float().permute(0, 2, 3, 1)}
