"""Basic det losses — port of pytorchocr_tpu/losses/basic.py: DB's (`bce`,
`_kth_largest_threshold`, `_topk_sum`, `balance_loss`, `dice_loss`,
`mask_l1_loss`, :29-149) and PSE/PAN's (`_safe_norm`, the masked
`_kth_largest_threshold`, `dice_loss_per_sample`, `iou_binary`, `ohem_batch`,
`emb_loss`, :15, :41, :135-297). Torch ops in the maps' dtype on their device.

OHEM takes the k hardest negatives by the JAX package's 30-step bisection of
the k-th largest value, not by `torch.topk` or a sort: ties at the threshold
count as the JAX function counts them, and the threshold `t` stays
differentiable as in JAX, where `jax.grad` runs through the `fori_loop`: after
the loop `t` is a dyadic mix of the map's min and max, so `t * (k - count)`
sends gradient to those elements (torch's `amin`/`amax`, like JAX's
min/max, split it evenly among ties).

DB's functions (`_topk_sum`, `balance_loss`, `dice_loss`, `mask_l1_loss`)
take their sums, counts and OHEM range over the global batch: under a mesh
with several ranks in its data group they go through
parallel.functional, so k, the bisection's threshold, the selected sum,
the dice and the L1 are the whole batch's, as the JAX step's are; at one
rank those are the local operations. PSE/PAN's per-sample functions stay
per sample.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.functional import all_sum, global_max, global_min

EPS = 1e-6


def _safe_norm(x, dim):
    """L2 norm whose gradient is 0, not NaN, at x == 0. From basic.py:15:
    torch.where's backward, like jnp.where's, multiplies the branch it did
    not select by 0, and 0 * inf is NaN, so the square root sees 1 where the
    squared sum is 0."""
    sq = (x * x).sum(dim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def bce(pred, gt):
    """Elementwise binary cross entropy on probabilities, clamped to
    [1e-6, 1 - 1e-6] before the log (torch's F.binary_cross_entropy clamps
    the log at -100 instead, another function). From basic.py:29."""
    p = pred.clamp(1e-6, 1.0 - 1e-6)
    return -(gt * torch.log(p) + (1.0 - gt) * torch.log1p(-p))


def _kth_largest_threshold(values, k, mask=None, iters=30, global_batch=False):
    """Bisection for t with count(valid values > t) <= k <= count(>= t),
    over the last axis (leading axes are a batch, `k` broadcasts against
    them). With `mask`, the range and the counts take the valid values only;
    an empty mask collapses the range to 0. With `global_batch` (1-D
    values, no mask) the range and every probe's count are over every
    rank's values. From basic.py:41."""
    if global_batch:
        lo, hi = global_min(values), global_max(values)
    elif mask is None:
        lo, hi = values.amin(-1), values.amax(-1)
    else:
        lo = torch.where(mask, values, float("inf")).amin(-1)
        hi = torch.where(mask, values, float("-inf")).amax(-1)
        lo = torch.where(torch.isfinite(lo), lo, 0.0)
        hi = torch.where(torch.isfinite(hi), hi, 0.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = values > mid.unsqueeze(-1)
        if mask is not None:
            above = above & mask
        count = above.sum(-1)
        too_many = (all_sum(count) if global_batch else count) > k
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    return hi


def _topk_sum(values, k):
    """Sum of the k largest entries of every rank's 1-D `values` (k a float
    tensor), exact up to ties at the threshold value. From basic.py:73."""
    t = _kth_largest_threshold(values, k, global_batch=True)
    above = values > t
    cnt_above = all_sum(above.sum())
    sum_above = all_sum(torch.where(above, values, 0.0).sum())
    return sum_above + t * torch.clamp(k - cnt_above, min=0.0)


def balance_loss(pred, gt, mask, main_loss_type="BCELoss", negative_ratio=3, balance=True):
    """OHEM-balanced loss: all positives + the top-k hardest negatives,
    k = ratio * #positives. From basic.py:84."""
    positive = gt * mask
    negative = (1.0 - gt) * mask
    positive_count = all_sum(positive.sum())
    negative_count = torch.minimum(all_sum(negative.sum()), positive_count * negative_ratio)

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
    positive_sum = all_sum(positive_loss.sum())
    balance_val = (positive_sum + selected_neg_sum) / (positive_count + negative_count + EPS)
    no_neg_val = positive_sum / (positive_count + EPS)
    return torch.where(negative_count > 0, balance_val, no_neg_val)


def dice_loss(pred, gt, mask, weights=None):
    """Global dice. From basic.py:126."""
    if weights is not None:
        mask = weights * mask
    intersection = all_sum((pred * gt * mask).sum())
    union = all_sum((pred * mask).sum()) + all_sum((gt * mask).sum()) + EPS
    return 1.0 - 2.0 * intersection / union


def mask_l1_loss(pred, gt, mask):
    """From basic.py:149."""
    return all_sum(((pred - gt).abs() * mask).sum()) / (all_sum(mask.sum()) + EPS)


def dice_loss_per_sample(pred, gt, mask):
    """Per-sample dice (N,). From basic.py:135."""
    b = pred.shape[0]
    pred = pred.reshape(b, -1)
    gt = gt.reshape(b, -1).to(pred.dtype)
    mask = mask.reshape(b, -1).to(pred.dtype)
    pred = pred * mask
    gt = gt * mask
    a = (pred * gt).sum(1)
    bb = (pred * pred).sum(1) + EPS
    c = (gt * gt).sum(1) + EPS
    return 1.0 - (2 * a) / (bb + c)


def iou_binary(a, b, mask, reduce=True):
    """mIoU over the classes {0, 1} of binarised maps, per sample (float32,
    no gradient). From basic.py:153."""
    bsz = a.shape[0]
    a = a.reshape(bsz, -1)
    b = b.reshape(bsz, -1)
    mask = (mask.reshape(bsz, -1) == 1).float()

    def one_class(i):
        ai = (a == i).float() * mask
        bi = (b == i).float() * mask
        inter = (ai * bi).sum(1)
        union = (ai + bi).clamp(0, 1).sum(1)
        return inter / (union + EPS)

    miou = (one_class(0) + one_class(1)) / 2.0
    return miou.mean() if reduce else miou


@torch.no_grad()
def ohem_batch(scores, gt_texts, training_masks, ohem_ratio=3):
    """Per-image OHEM selection (N, H, W), all images at once: the positives
    and the k = min(#negatives, ratio * #valid positives) highest-scoring
    negatives by the bisection threshold, inside the training mask; the
    training mask itself where an image has no positives or no negatives.
    A selection carries no gradient. From basic.py:172."""
    n = scores.shape[0]
    score = scores.reshape(n, -1)
    gt_text = gt_texts.reshape(n, -1)
    training_mask = training_masks.reshape(n, -1)
    dtype = score.dtype
    pos = gt_text > 0.5
    pos_num = (pos & (training_mask > 0.5)).to(dtype).sum(1)
    neg = gt_text <= 0.5
    neg_num = torch.minimum(neg.to(dtype).sum(1), pos_num * ohem_ratio)
    threshold = _kth_largest_threshold(score, neg_num, mask=neg)
    selected = ((score >= threshold[:, None]) | pos) & (training_mask > 0.5)
    fallback = (pos_num == 0) | (neg_num == 0)
    out = torch.where(fallback[:, None], training_mask.to(dtype), selected.to(dtype))
    return out.reshape(scores.shape)


MAX_INSTANCES = 64


def _one_hot(ids, dtype):
    """(MAX_INSTANCES, P) indicator of `ids` (P,). Segment sums and the
    gather of the centres go through it as products: deterministic on the
    card, where index_add_'s float atomics are not."""
    return (ids[None, :] == torch.arange(MAX_INSTANCES, device=ids.device)[:, None]).to(dtype)


def emb_loss_single(emb, instance, kernel, training_mask, delta_v=0.5, delta_d=1.5,
                    mode="v2"):
    """Discriminative embedding loss of one sample. emb (P, D); instance,
    kernel, training_mask (P,). Instance ids are bucketed into a table of
    MAX_INSTANCES (ids past 63 share bucket 63); cluster centres are the
    kernel pixels' means; l_agg pulls pixels to their centre, l_dis pushes
    centres apart (v2: and away from the background), l_reg keeps them near
    0. From basic.py:202."""
    dtype = emb.dtype
    training_mask = (training_mask > 0.5).long()
    kernel = (kernel > 0.5).long()
    instance = (instance.long() * training_mask).clamp(0, MAX_INSTANCES - 1)
    instance_kernel = instance * kernel

    oh_k = _one_hot(instance_kernel, dtype)
    counts_k = oh_k.sum(1)
    valid = counts_k > 0
    emb_mean = (oh_k @ emb) / torch.clamp(counts_k, min=1.0)[:, None]  # (I, D)
    num_instance = valid.sum()  # background 0 included

    oh_i = _one_hot(instance, dtype)
    dist = _safe_norm(emb - oh_i.t() @ emb_mean, 1)
    hinge = torch.log(torch.relu(dist - delta_v) ** 2 + 1.0)
    mean_h = (oh_i @ hinge) / torch.clamp(oh_i.sum(1), min=1.0)
    fg_valid = valid.clone()
    fg_valid[0] = False
    n_fg = fg_valid.to(dtype).sum()
    l_agg = torch.where(fg_valid, mean_h, 0.0).sum() / torch.clamp(n_fg, min=1.0)

    cdist = _safe_norm(emb_mean[:, None, :] - emb_mean[None, :, :], -1)
    eye = torch.eye(MAX_INSTANCES, dtype=torch.bool, device=emb.device)
    pair_valid = fg_valid[:, None] & fg_valid[None, :] & ~eye
    push = torch.log(torch.relu(2 * delta_d - cdist) ** 2 + 1.0)
    n_pairs = pair_valid.to(dtype).sum()
    terms_sum = torch.where(pair_valid, push, 0.0).sum()
    if mode == "v1":
        l_dis = terms_sum / torch.clamp(n_pairs, min=1.0)
    else:
        is_bg = (instance == 0).to(dtype)
        n_bg = is_bg.sum()
        bg_dist = _safe_norm(emb[None, :, :] - emb_mean[:, None, :], -1)  # (I, P)
        bg_push = torch.log(torch.relu(2 * delta_d - bg_dist) ** 2 + 1.0)
        bg_mean = (bg_push * is_bg[None, :]).sum(1) / torch.clamp(n_bg, min=1.0)
        terms_sum = terms_sum + torch.where(fg_valid, bg_mean, 0.0).sum()
        terms_cnt = n_pairs + n_fg * torch.clamp(n_bg, max=1.0)
        l_dis = terms_sum / torch.clamp(terms_cnt, min=1.0)
    l_dis = torch.where(num_instance > 2, l_dis, 0.0)

    l_reg = (torch.where(valid, torch.log(_safe_norm(emb_mean, 1) + 1.0), 0.0).sum()
             / torch.clamp(valid.to(dtype).sum(), min=1.0) * 0.001)
    return torch.where(num_instance > 1, l_agg + l_dis + l_reg, 0.0)


def emb_loss(emb, instance, kernel, training_mask, mode="v2"):
    """The batch's mean embedding loss; emb (N, H, W, D) NHWC, the others
    (N, H, W). From basic.py:287.

    One sample at a time, as jax.vmap maps them, each under activation
    checkpointing: a 640x640 sample's v2 background push is a (64, 409,600,
    4) difference (420 MB in float32) and its one-hot tables 105 MB each, so
    autograd keeps only the inputs and the backward recomputes one sample at
    a time."""
    n = emb.shape[0]
    emb = emb.reshape(n, -1, emb.shape[-1])
    return torch.stack([
        checkpoint(emb_loss_single, emb[i], instance[i].reshape(-1), kernel[i].reshape(-1),
                   training_mask[i].reshape(-1), 0.5, 1.5, mode, use_reentrant=False)
        for i in range(n)]).mean()
