"""PAN / PAN++ loss — port of pytorchocr_tpu/losses/det_pan_loss.py:20:
alpha * text dice (over the OHEM selection) + beta * kernel dice (over the
kernel-sample mask) + gamma * the embedding loss (v1, or v2 with the
background push), weights 1.0 / 0.5 / 0.25 by default.

Preds are NHWC logit maps at 1/4 of the page (N, H/4, W/4, 6) = text,
kernel, 4 embedding channels, upsampled x4 (nearest). The batch's fields
1-4 are gt_text, gt_kernels (N, H, W), gt_instance (int32) and the training
mask. `torch.sigmoid` throughout (det_pse_loss.py says why).
"""

import torch

from . import basic
from .det_pse_loss import PSELoss, reduce_losses, selections, upsample_maps


class PANLoss:
    def __init__(self, alpha=1.0, beta=0.5, gamma=0.25, feature_dim=4, mode="v2", ohem_ratio=3,
                 kernel_sample_mask="pred", reduction="mean", **kwargs):
        assert reduction in ["sum", "mean", "none"]
        assert mode in ["v1", "v2"]
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.mode = mode  # feature_dim: the embedding's width comes from the maps
        self.ohem_ratio = ohem_ratio
        self.kernel_sample_mask = kernel_sample_mask
        self.reduction = reduction

    def __call__(self, outputs, labels):
        predicts = upsample_maps(outputs["maps"])
        texts = predicts[..., 0]
        kernels = predicts[..., 1]
        embs = predicts[..., 2:]
        gt_texts, gt_kernels, gt_instance, training_masks = labels[1:5]

        selected_masks, masks = self.select(texts, gt_texts, training_masks)
        loss_text = basic.dice_loss_per_sample(torch.sigmoid(texts), gt_texts, selected_masks)
        iou_text = basic.iou_binary((texts > 0).int(), gt_texts, training_masks, reduce=False)
        losses = {"loss_text": loss_text, "iou_text": iou_text}

        loss_kernels = basic.dice_loss_per_sample(torch.sigmoid(kernels), gt_kernels, masks)
        iou_kernel = basic.iou_binary((kernels > 0).int(), gt_kernels,
                                      training_masks * gt_texts, reduce=False)
        losses.update({"loss_kernels": loss_kernels, "iou_kernel": iou_kernel})
        losses["loss_emb"] = basic.emb_loss(embs, gt_instance, gt_kernels, training_masks,
                                            mode=self.mode)
        losses["loss"] = (self.alpha * loss_text + self.beta * loss_kernels
                          + self.gamma * losses["loss_emb"])
        return reduce_losses(losses, self.reduction)

    select = PSELoss.select

    def selections(self, outputs, labels):
        """As PSELoss.selections."""
        return selections(self, outputs, labels[1], labels[-1], 1)
