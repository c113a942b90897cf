"""The weighted sum of the config's losses — port of
pytorchocr_tpu/losses/combined_loss.py:23-54."""

from .distillation_loss import (DistillationCTCLoss, DistillationDBLoss, DistillationDistanceLoss,
                                DistillationDMLLoss, DistillationTeachDBLoss)

__all__ = ["CombinedLoss"]

_SUPPORTED = {
    "DistillationCTCLoss": DistillationCTCLoss,
    "DistillationDMLLoss": DistillationDMLLoss,
    "DistillationDistanceLoss": DistillationDistanceLoss,
    "DistillationDBLoss": DistillationDBLoss,
    "DistillationTeachDBLoss": DistillationTeachDBLoss,
}


class CombinedLoss:
    def __init__(self, loss_config_list=None):
        self.loss_func = []
        self.loss_weight = []
        assert isinstance(loss_config_list, list), "operator config should be a list"
        for config in loss_config_list:
            assert isinstance(config, dict) and len(config) == 1, "yaml format error"
            name = list(config)[0]
            param = dict(config[name])
            assert "weight" in param, \
                "weight must be in param, but param just contains {}".format(param.keys())
            self.loss_weight.append(param.pop("weight"))
            self.loss_func.append(_SUPPORTED[name](**param))

    def __call__(self, inputs, batch, **kwargs):
        loss_dict = {}
        loss_all = 0.0
        for idx, loss_func in enumerate(self.loss_func):
            loss = loss_func(inputs, batch, **kwargs)
            if not isinstance(loss, dict):
                loss = {"loss_{}_{}".format(str(loss), idx): loss}
            weight = self.loss_weight[idx]
            loss = {key: loss[key] * weight for key in loss}
            if "loss" in loss:
                loss_all = loss_all + loss["loss"]
            else:
                for v in loss.values():
                    loss_all = loss_all + v
            loss_dict.update(loss)
        loss_dict["loss"] = loss_all
        return loss_dict
