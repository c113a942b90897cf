"""CTC head — port of pytorchocr_tpu/modeling/heads/rec_ctc_head.py.

(N, T, C_in) -> (N, T, n_class): logits in training mode, float32 softmax
probabilities at eval.
"""

import torch
from torch import nn

__all__ = ["CTCHead"]


class CTCHead(nn.Module):
    def __init__(self, in_channels, out_channels, return_feats=False):
        super().__init__()
        self.fc = nn.Linear(in_channels, out_channels)
        self.return_feats = return_feats

    def forward(self, x, targets=None):
        predicts = self.fc(x)
        if not self.training:
            return torch.softmax(predicts.float(), dim=2)
        if self.return_feats:
            return x, predicts
        return predicts
