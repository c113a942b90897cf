"""Direction-classification loss — port of
pytorchocr_tpu/losses/cls_loss.py:7-18: the mean softmax cross-entropy over
integer labels, in float32 (optax.softmax_cross_entropy_with_integer_labels
in JAX)."""

import torch
import torch.nn.functional as F


class ClsLoss:
    def __init__(self, **kwargs):
        pass

    def __call__(self, predicts, batch):
        # float64 stays (the card's float32 step is held to a float64 one)
        logits = predicts if predicts.dtype == torch.float64 else predicts.float()
        return {"loss": F.cross_entropy(logits, batch[1].long())}
