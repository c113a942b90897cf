"""SLANet's loss — port of pytorchocr_tpu/losses/table_att_loss.py.

The structure cross-entropy over the targets shifted by one (`batch[1][:,
1:]`), both sides cut to t = min(decode steps, target steps) (:35-37),
with optax's `smooth_labels` when `label_smoothing` > 0 ((1 - a) one-hot +
a / classes); the masked MSE or smooth-L1 loc loss summed over every
element, over `sum(mask) + 1e-12`; and with `aux_count_weight` > 0 the
row / column count cross-entropies against `batch[4]` / `batch[5]`. Float32
(float64 stays: the card's float32 step is held to a float64 one).

Across ranks (parallel/mesh.py) the loc loss's sum and its mask count are
the global batch's (:56-61, a global sum over a global count in the JAX
step); the cross-entropies are per-token and per-table means, which the
step's gradient average makes global over equal shards.
"""

import torch
import torch.nn.functional as F

from ..parallel.functional import all_sum


def _f(x):
    return x if x.dtype == torch.float64 else x.float()


def _ce(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels, per row."""
    return -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]


class SLALoss:
    def __init__(self, structure_weight, loc_weight, loc_loss_type="mse", label_smoothing=0.0,
                 aux_count_weight=0.0, **kwargs):
        if loc_loss_type not in ("mse", "smooth_l1"):
            raise ValueError("loc_loss_type must be mse or smooth_l1")
        self.structure_weight = structure_weight
        self.loc_weight = loc_weight
        self.loc_loss_type = loc_loss_type
        self.label_smoothing = float(label_smoothing)
        self.aux_count_weight = float(aux_count_weight)
        self.eps = 1e-12

    def __call__(self, predicts, batch):
        structure_probs = _f(predicts["structure_probs"])
        structure_targets = batch[1].long()[:, 1:]
        t = min(structure_probs.shape[1], structure_targets.shape[1])
        logits = structure_probs[:, :t].reshape(-1, structure_probs.shape[-1])
        labels = structure_targets[:, :t].reshape(-1)
        if self.label_smoothing > 0.0:
            n_cls = logits.shape[-1]
            smooth = (F.one_hot(labels, n_cls).to(logits.dtype) * (1.0 - self.label_smoothing)
                      + self.label_smoothing / n_cls)
            ce = -(smooth * torch.log_softmax(logits, dim=-1)).sum(-1)
        else:
            ce = _ce(logits, labels)
        structure_loss = ce.mean() * self.structure_weight

        loc_preds = _f(predicts["loc_preds"])[:, :t]
        loc_targets = batch[2].to(loc_preds.dtype)[:, 1:][:, :t]
        mask = batch[3].to(loc_preds.dtype)[:, 1:][:, :t]
        diff = loc_preds * mask - loc_targets * mask
        if self.loc_loss_type == "smooth_l1":
            ad = torch.abs(diff)
            loc_loss = torch.where(ad < 1.0, 0.5 * diff ** 2, ad - 0.5).sum()
        else:
            loc_loss = (diff ** 2).sum()
        loc_loss = all_sum(loc_loss) * self.loc_weight / (all_sum(mask.sum()) + self.eps)

        total = structure_loss + loc_loss
        out = {"loss": total, "structure_loss": structure_loss, "loc_loss": loc_loss}
        if self.aux_count_weight > 0.0 and "row_logits" in predicts:
            row_ce = _ce(_f(predicts["row_logits"]), batch[4].long())
            col_ce = _ce(_f(predicts["col_logits"]), batch[5].long())
            count_loss = self.aux_count_weight * (row_ce + col_ce).mean()
            out["count_loss"] = count_loss
            out["loss"] = total + count_loss
        return out
