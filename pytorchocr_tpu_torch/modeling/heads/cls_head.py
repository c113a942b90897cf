"""Direction-classifier head — port of
pytorchocr_tpu/modeling/heads/cls_head.py.

Global average pool -> `fc` (Linear) -> float32 softmax at eval. Input NCHW;
the output is (N, class_dim), as in the JAX package.
"""

import torch
from torch import nn

__all__ = ["ClsHead"]


class ClsHead(nn.Module):
    def __init__(self, in_channels, class_dim=2):
        super().__init__()
        self.fc = nn.Linear(in_channels, class_dim)

    def forward(self, x, targets=None):
        x = self.fc(x.mean(dim=(2, 3)))
        if not self.training:
            x = torch.softmax(x.float(), dim=1)
        return x
