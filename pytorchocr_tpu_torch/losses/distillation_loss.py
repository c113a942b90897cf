"""Distillation losses — port of pytorchocr_tpu/losses/distillation_loss.py:20-231.

All five: per-student CTC, model-pair DML (with the DB maps sliced by
`maps_name`), per-student ground-truth DBLoss, the teacher's soft shrink map
as a DBLoss target (with the optional binarize + 2x2 dilation), and the
feature distance. The DB maps are NHWC (modeling/heads/det_db_head.py), so a
map is `maps[..., i]`, as in JAX.

`DistillationDBLoss` and `DistillationTeachDBLoss` call `DBLoss.__init__()`
with no arguments, as the JAX classes do (distillation_loss.py:127,164): their
`main_loss_type`, `alpha`, `beta`, `ohem_ratio` and `balance` are DBLoss's
defaults (BCELoss, 1, 10, 3, True) whatever the config says. The loss-dict
keys are the JAX ones.
"""

import torch
import torch.nn.functional as F

from . import basic
from .basic_loss import DistanceLoss, DMLLoss
from .det_db_loss import DBLoss
from .rec_ctc_loss import CTCLoss

__all__ = ["DistillationCTCLoss", "DistillationDMLLoss", "DistillationDBLoss",
           "DistillationTeachDBLoss", "DistillationDistanceLoss"]


def _sum_loss(loss_dict):
    if "loss" in loss_dict:
        return loss_dict
    total = 0.0
    for v in loss_dict.values():
        total = total + v
    loss_dict["loss"] = total
    return loss_dict


def _check_model_name_pairs(model_name_pairs):
    if not isinstance(model_name_pairs, list):
        return []
    if isinstance(model_name_pairs[0], list) and isinstance(model_name_pairs[0][0], str):
        return model_name_pairs
    return [model_name_pairs]


def dilate_2x2(binary):
    """The JAX `reduce_window` max over a 2x2 window, stride 1, padded by one
    row at the bottom and one column at the right with -inf
    (distillation_loss.py:181-190); `F.max_pool2d`'s own padding is
    symmetric, so the pad comes first. (N, H, W) -> (N, H, W)."""
    x = F.pad(binary[:, None], (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(x, 2, stride=1)[:, 0]


class DistillationDMLLoss(DMLLoss):
    """Deep mutual learning over model pairs."""

    def __init__(self, model_name_pairs=None, act=None, use_log=False, key=None,
                 maps_name=None, name="dml", **kwargs):
        super().__init__(act=act, use_log=use_log)
        self.key = key
        self.model_name_pairs = _check_model_name_pairs(model_name_pairs or [])
        self.name = name
        if maps_name is None:
            self.maps_name = None
        elif isinstance(maps_name, str):
            self.maps_name = [maps_name]
        else:
            self.maps_name = list(maps_name)

    def _slice_out(self, outs):
        idx_map = {"shrink_maps": 0, "threshold_maps": 1, "binary_maps": 2}
        return {k: outs[..., idx_map[k]] for k in self.maps_name if k in idx_map}

    def __call__(self, predicts, batch):
        loss_dict = {}
        for idx, pair in enumerate(self.model_name_pairs):
            out1, out2 = predicts[pair[0]], predicts[pair[1]]
            if self.key is not None:
                out1, out2 = out1[self.key], out2[self.key]
            if self.maps_name is None:
                loss_dict["{}_{}".format(self.name, idx)] = super().__call__(out1, out2)
            else:
                outs1, outs2 = self._slice_out(out1), self._slice_out(out2)
                for _c, k in enumerate(outs1.keys()):
                    loss_dict["{}_{}_{}".format(self.name, self.maps_name[_c], idx)] = \
                        super().__call__(outs1[k], outs2[k])
        return _sum_loss(loss_dict)


class DistillationCTCLoss(CTCLoss):
    def __init__(self, model_name_list=None, key=None, name="loss_ctc", **kwargs):
        super().__init__()
        self.model_name_list = model_name_list or []
        self.key = key
        self.name = name

    def __call__(self, predicts, batch):
        loss_dict = {}
        for idx, model_name in enumerate(self.model_name_list):
            out = predicts[model_name]
            if self.key is not None:
                out = out[self.key]
            loss = super().__call__(out, batch)
            for key in loss:
                loss_dict["{}_{}_{}".format(self.name, model_name, idx)] = loss[key]
        return _sum_loss(loss_dict)


class DistillationDBLoss(DBLoss):
    """Ground-truth supervision of each student."""

    def __init__(self, model_name_list=None, balance_loss=True, main_loss_type="BCELoss",
                 alpha=1, beta=10, ohem_ratio=3, eps=1e-6, name="db", **kwargs):
        super().__init__()  # DBLoss's defaults, as in JAX (module docstring)
        self.model_name_list = model_name_list or []
        self.name = name

    def __call__(self, predicts, batch):
        loss_dict = {}
        for model_name in self.model_name_list:
            loss = super().__call__(predicts[model_name], batch)
            for key in loss:
                if key != "loss":
                    loss_dict["{}_{}_{}".format(self.name, model_name, key)] = loss[key]
        return _sum_loss(loss_dict)


class DistillationTeachDBLoss(DBLoss):
    """The teacher's shrink map as the student's target: the balanced loss
    (DBLoss's BCE with OHEM 3, see the module docstring) on the soft map
    plus dice on the map binarized at 0.3; `dilate` binarizes at 0.3 and
    dilates by a 2x2 max window first. The teacher's map carries no
    gradient."""

    def __init__(self, model_name_pairs=None, key=None, balance_loss=True,
                 main_loss_type="DiceLoss", dilate=False, alpha=1, beta=10, ohem_ratio=3,
                 eps=1e-6, name="teach_dbloss", **kwargs):
        super().__init__()  # DBLoss's defaults, as in JAX (module docstring)
        self.model_name_pairs = _check_model_name_pairs(model_name_pairs or [])
        self.name = name
        self.key = key
        self.dilate = dilate

    def __call__(self, predicts, batch):
        loss_dict = {}
        for pair in self.model_name_pairs:
            stu_outs, tch_outs = predicts[pair[0]], predicts[pair[1]]
            stu_preds = stu_outs[self.key] if self.key is not None else stu_outs["maps"]
            tch_preds = tch_outs[self.key] if self.key is not None else tch_outs["maps"]
            stu_shrink_maps, stu_binary_maps = stu_preds[..., 0], stu_preds[..., 2]
            th_shrink_maps = tch_preds[..., 0].detach()
            if self.dilate:
                th_shrink_maps = dilate_2x2((th_shrink_maps > 0.3).to(th_shrink_maps.dtype))
            label_shrink_mask = batch[4]
            bce = self.alpha * basic.balance_loss(
                stu_shrink_maps, th_shrink_maps, label_shrink_mask,
                main_loss_type=self.main_loss_type, negative_ratio=self.ohem_ratio,
                balance=self.balance)
            loss_binary = basic.dice_loss(stu_binary_maps,
                                          (th_shrink_maps > 0.3).to(stu_binary_maps.dtype),
                                          label_shrink_mask)
            loss_dict["{}_{}_{}".format(self.name, pair[0], pair[1])] = bce + loss_binary
        return _sum_loss(loss_dict)


class DistillationDistanceLoss(DistanceLoss):
    def __init__(self, mode="l2", model_name_pairs=None, key=None, name="loss_distance",
                 **kwargs):
        super().__init__(mode=mode)
        self.key = key
        self.model_name_pairs = _check_model_name_pairs(model_name_pairs or [])
        self.name = name + "_" + mode

    def __call__(self, predicts, batch):
        loss_dict = {}
        for idx, pair in enumerate(self.model_name_pairs):
            out1, out2 = predicts[pair[0]], predicts[pair[1]]
            if self.key is not None:
                out1, out2 = out1[self.key], out2[self.key]
            loss_dict["{}_{}_{}_{}".format(self.name, pair[0], pair[1], idx)] = \
                super().__call__(out1, out2)
        return _sum_loss(loss_dict)
