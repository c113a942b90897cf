"""PSE loss — port of pytorchocr_tpu/losses/det_pse_loss.py:15.

Preds are NHWC logit maps at 1/4 of the page (N, H/4, W/4, 7), upsampled x4
(nearest) before the loss: the text map by the dice over the OHEM
selection, the 6 kernel maps by the dice over the kernel-sample mask. The
batch's fields 1-3 are gt_text (N, H, W), gt_kernels (N, 6, H, W) and the
training mask (the KeepKeys order). Sigmoids are `torch.sigmoid`, whose
backward s (1 - s) stays finite, never 1 / (1 + exp(-x)), whose backward is
0 * inf = NaN once exp(-x) overflows (|x| past ~88.7, which dice training
reaches late).

Three selections threshold on a prediction: the OHEM selection (score >=
the bisection threshold), the kernel-sample mask `pred` (sigmoid(text) >
0.5) and the IoU logs' binarisation (logit > 0). `selections` returns them,
so two runs can count the pixels that a rounding moved across a threshold;
`select` makes the two masks the loss sums over, so a reference run can
take another run's.
"""

import torch

from ..modeling.common import resize_nearest
from . import basic


def upsample_maps(maps, scale=4):
    """Nearest upsample of NHWC maps by `scale` (NHWC out)."""
    return resize_nearest(maps.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)


def kernel_masks(mode, texts, gt_texts, training_masks):
    """The pixels the kernel dice sees: inside the text ("gt") or where the
    text map's sigmoid passes 0.5 ("pred"), within the training mask."""
    if mode == "gt":
        return gt_texts * training_masks
    return (torch.sigmoid(texts) > 0.5).to(texts.dtype) * training_masks


class PSELoss:
    def __init__(self, alpha=0.7, ohem_ratio=3, kernel_sample_mask="pred", reduction="mean",
                 **kwargs):
        assert reduction in ["sum", "mean", "none"]
        self.alpha = alpha
        self.ohem_ratio = ohem_ratio
        self.kernel_sample_mask = kernel_sample_mask
        self.reduction = reduction

    def select(self, texts, gt_texts, training_masks):
        """The OHEM selection of the text dice and the kernel-sample mask of
        the kernel dice (float 0/1 maps, no gradient)."""
        return (basic.ohem_batch(texts, gt_texts, training_masks, self.ohem_ratio),
                kernel_masks(self.kernel_sample_mask, texts, gt_texts, training_masks))

    def __call__(self, outputs, labels):
        predicts = upsample_maps(outputs["maps"])
        texts = predicts[..., 0]
        kernels = predicts[..., 1:]
        gt_texts, gt_kernels, training_masks = labels[1:4]

        selected_masks, masks = self.select(texts, gt_texts, training_masks)
        loss_text = basic.dice_loss_per_sample(torch.sigmoid(texts), gt_texts, selected_masks)
        iou_text = basic.iou_binary((texts > 0).int(), gt_texts, training_masks, reduce=False)
        losses = {"loss_text": loss_text, "iou_text": iou_text}

        loss_kernels = torch.stack([
            basic.dice_loss_per_sample(torch.sigmoid(kernels[..., i]), gt_kernels[:, i], masks)
            for i in range(kernels.shape[-1])], dim=1).mean(1)
        iou_kernel = basic.iou_binary((kernels[..., -1] > 0).int(), gt_kernels[:, -1],
                                      training_masks * gt_texts, reduce=False)
        losses.update({"loss_kernels": loss_kernels, "iou_kernel": iou_kernel})
        losses["loss"] = self.alpha * loss_text + (1 - self.alpha) * loss_kernels
        return reduce_losses(losses, self.reduction)

    def selections(self, outputs, labels):
        """The boolean maps this loss takes from thresholds on the
        predictions (OHEM, the kernel-sample mask, the IoU binarisations)."""
        return selections(self, outputs, labels[1], labels[-1], -1)


def selections(loss, outputs, gt_texts, training_masks, kernel_channel):
    """`loss.select`'s two masks and the IoU logs' binarisations of the text
    map and of map `kernel_channel`, as bool maps."""
    with torch.no_grad():
        predicts = upsample_maps(outputs["maps"])
        texts = predicts[..., 0]
        ohem, kernel_mask = loss.select(texts, gt_texts, training_masks)
        return {"ohem": ohem > 0, "kernel_mask": kernel_mask > 0, "text>0": texts > 0,
                "kernel>0": predicts[..., kernel_channel] > 0}


def reduce_losses(losses, reduction):
    if reduction == "sum":
        return {k: v.sum() for k, v in losses.items()}
    if reduction == "mean":
        return {k: v.mean() for k, v in losses.items()}
    return losses


def flipped_pixels(a, b):
    """Pixels on which two runs' `selections` disagree, per selection."""
    return {k: int((a[k].cpu() != b[k].cpu()).sum()) for k in a}
