"""DB loss — port of pytorchocr_tpu/losses/det_db_loss.py:11:
alpha * Balance(shrink) + beta * MaskL1(thresh) + Dice(binary).

Preds are NHWC maps (N, H, W, 3): [shrink, threshold, binary], float32 (the
trainer casts the model's maps before the loss, as the JAX bf16 policy
does). The batch's fields 1-4 are threshold_map, threshold_mask, shrink_map,
shrink_mask (the KeepKeys order).
"""

from . import basic


class DBLoss:
    def __init__(self, balance_loss=True, main_loss_type="BCELoss", alpha=1, beta=10,
                 ohem_ratio=3, eps=1e-6, **kwargs):
        self.alpha = alpha
        self.beta = beta
        self.balance = balance_loss
        self.main_loss_type = main_loss_type
        self.ohem_ratio = ohem_ratio

    def __call__(self, predicts, labels):
        maps = predicts["maps"]
        threshold_map, threshold_mask, shrink_map, shrink_mask = labels[1:5]
        loss_shrink = self.alpha * basic.balance_loss(
            maps[..., 0], shrink_map, shrink_mask, main_loss_type=self.main_loss_type,
            negative_ratio=self.ohem_ratio, balance=self.balance)
        loss_threshold = self.beta * basic.mask_l1_loss(maps[..., 1], threshold_map,
                                                        threshold_mask)
        loss_binary = basic.dice_loss(maps[..., 2], shrink_map, shrink_mask)
        return {
            "loss": loss_shrink + loss_threshold + loss_binary,
            "loss_shrink_maps": loss_shrink,
            "loss_threshold_maps": loss_threshold,
            "loss_binary_maps": loss_binary,
        }
