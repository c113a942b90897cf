"""KL / JS divergence, deep mutual learning and distance losses — port of
pytorchocr_tpu/losses/basic_loss.py:9-73.

Every loss computes in float32 (a float64 input stays float64: the card's
float32 step is held to a float64 one), as the JAX losses cast their
inputs.
"""

import torch

__all__ = ["KLJSLoss", "DMLLoss", "DistanceLoss"]


def _float(x):
    return x if x.dtype == torch.float64 else x.float()


class KLJSLoss:
    def __init__(self, mode="kl", reduction="mean", **kwargs):
        assert mode.lower() in ["kl", "js"]
        assert reduction in ["sum", "mean", "none"]
        self.mode = mode.lower()
        self.reduction = reduction

    def __call__(self, p1, p2):
        loss = p2 * torch.log((p2 + 1e-5) / (p1 + 1e-5) + 1e-5)
        if self.mode == "js":
            loss = loss + p1 * torch.log((p1 + 1e-5) / (p2 + 1e-5) + 1e-5)
            loss = loss * 0.5
        if self.reduction == "sum":
            return loss.sum()
        if self.reduction == "mean":
            return loss.mean()
        return loss


class DMLLoss:
    """Deep mutual learning: JS for det maps; the symmetric batchmean KL over
    log-probabilities for rec logits (`use_log`)."""

    def __init__(self, act=None, use_log=False, **kwargs):
        assert act in [None, "softmax", "sigmoid"]
        self.act = act
        self.use_log = use_log
        self.jskl_loss = KLJSLoss(mode="js")

    def __call__(self, out1, out2):
        out1, out2 = _float(out1), _float(out2)
        if self.act == "softmax":
            # the max-shifted exp over its sum, as the JAX loss writes it
            out1 = torch.exp(out1 - out1.amax(-1, keepdim=True))
            out1 = out1 / out1.sum(-1, keepdim=True)
            out2 = torch.exp(out2 - out2.amax(-1, keepdim=True))
            out2 = out2 / out2.sum(-1, keepdim=True)
        elif self.act == "sigmoid":
            out1, out2 = torch.sigmoid(out1), torch.sigmoid(out2)
        if self.use_log:
            # kl_div(log p, q, "batchmean") = sum(q (log q - log p)) / N
            batch = out1.shape[0]
            log1 = torch.log(out1 + 1e-10)
            log2 = torch.log(out2 + 1e-10)
            kl12 = (out2 * (log2 - log1)).sum() / batch
            kl21 = (out1 * (log1 - log2)).sum() / batch
            return (kl12 + kl21) / 2.0
        return self.jskl_loss(out1, out2)


class DistanceLoss:
    def __init__(self, mode="l2", **kwargs):
        assert mode in ["l1", "l2", "smooth_l1"]
        self.mode = mode

    def __call__(self, x, y):
        d = _float(x) - _float(y)
        if self.mode == "l1":
            return d.abs().mean()
        if self.mode == "l2":
            return (d ** 2).mean()
        ad = d.abs()
        return torch.where(ad < 1.0, 0.5 * d ** 2, ad - 0.5).mean()
