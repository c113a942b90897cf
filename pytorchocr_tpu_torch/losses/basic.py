"""Basic det losses — port of the DB part of pytorchocr_tpu/losses/basic.py
(`bce`, `_kth_largest_threshold`, `_topk_sum`, `balance_loss`, `dice_loss`,
`mask_l1_loss`, :29-149). Float32 torch ops on the maps' device.

OHEM takes the k hardest negatives by the JAX package's 30-step bisection of
the k-th largest value, not by `torch.topk` or a sort: ties at the threshold
count as the JAX function counts them, and the threshold `t` stays
differentiable as in JAX, where `jax.grad` runs through the `fori_loop`: after
the loop `t` is a dyadic mix of the map's min and max, so `t * (k - count)`
sends gradient to those elements (torch's `amin`/`amax`, like JAX's
min/max, split it evenly among ties).
"""

import torch

EPS = 1e-6


def bce(pred, gt):
    """Elementwise binary cross entropy on probabilities, clamped to
    [1e-6, 1 - 1e-6] before the log (torch's F.binary_cross_entropy clamps
    the log at -100 instead, another function). From basic.py:29."""
    p = pred.clamp(1e-6, 1.0 - 1e-6)
    return -(gt * torch.log(p) + (1.0 - gt) * torch.log1p(-p))


def _kth_largest_threshold(values, k, iters=30):
    """Bisection for t with count(values > t) <= k <= count(values >= t).
    From basic.py:41 (the unmasked case the DB loss calls)."""
    lo, hi = values.amin(), values.amax()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = (values > mid).sum() > k
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    return hi


def _topk_sum(values, k):
    """Sum of the k largest entries (k a float tensor), exact up to ties at
    the threshold value. From basic.py:73."""
    t = _kth_largest_threshold(values, k)
    above = values > t
    cnt_above = above.sum()
    sum_above = torch.where(above, values, 0.0).sum()
    return sum_above + t * torch.clamp(k - cnt_above, min=0.0)


def balance_loss(pred, gt, mask, main_loss_type="BCELoss", negative_ratio=3, balance=True):
    """OHEM-balanced loss: all positives + the top-k hardest negatives,
    k = ratio * #positives. From basic.py:84."""
    positive = gt * mask
    negative = (1.0 - gt) * mask
    positive_count = positive.sum()
    negative_count = torch.minimum(negative.sum(), positive_count * negative_ratio)

    if main_loss_type in ("BCELoss", "CrossEntropy"):
        loss = bce(pred, gt)
    elif main_loss_type == "Euclidean":
        loss = (pred - gt) ** 2
    elif main_loss_type == "MaskL1Loss":
        loss = (pred - gt).abs() * mask
    elif main_loss_type == "DiceLoss":
        return dice_loss(pred, gt, mask)
    else:
        raise ValueError("unsupported main_loss_type %s" % main_loss_type)
    if not balance:
        return loss

    positive_loss = positive * loss
    negative_loss = negative * loss
    selected_neg_sum = _topk_sum(negative_loss.reshape(-1), negative_count)
    balance_val = (positive_loss.sum() + selected_neg_sum) / (
        positive_count + negative_count + EPS)
    no_neg_val = positive_loss.sum() / (positive_count + EPS)
    return torch.where(negative_count > 0, balance_val, no_neg_val)


def dice_loss(pred, gt, mask, weights=None):
    """Global dice. From basic.py:126."""
    if weights is not None:
        mask = weights * mask
    intersection = (pred * gt * mask).sum()
    union = (pred * mask).sum() + (gt * mask).sum() + EPS
    return 1.0 - 2.0 * intersection / union


def mask_l1_loss(pred, gt, mask):
    """From basic.py:149."""
    return ((pred - gt).abs() * mask).sum() / (mask.sum() + EPS)
