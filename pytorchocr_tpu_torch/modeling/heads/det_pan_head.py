"""PAN head — port of pytorchocr_tpu/modeling/heads/det_pan_head.py.

The PSE head's layers with 6 maps: text, kernel and a 4-dim embedding logit
map at 1/4 of the page, NHWC float32, which losses/det_pan_loss.py trains.
"""

from .det_pse_head import PSEHead

__all__ = ["PANHead"]


class PANHead(PSEHead):
    def __init__(self, in_channels, hidden_dim=128, out_channels=6):
        super().__init__(in_channels, hidden_dim, out_channels)
