"""DistillationModel: named BaseModels (Teacher, Student, ...) — port of
pytorchocr_tpu/modeling/architectures/distillation_model.py:20-58.

The i-th model of `Architecture.Models`, in the config's order, is the
submodule `models_<i>`: the flax name of the i-th entry of the JAX model's
tuple, so the weight bridge maps `params/models_<i>/...` onto it by name and
a checkpoint's keys read `models_<i>.backbone...`.

A model with `freeze_params` runs as the JAX one does under `train=train and
not frozen` and `stop_gradient`: it stays in eval mode (its BN uses and keeps
its running statistics, its DB head returns the shrink map alone) whatever
mode the whole model is put in, it runs under `torch.no_grad()`, and its
parameters require no gradient, so build_optimizer leaves them out (the JAX
optimizer gives them zero gradients and, with the configs' weight_decay 0, a
zero update). It is built without its head's train-only modules
(`train_only`: DBHead's threshold tower), which the JAX model, initialised
with the frozen model in eval mode, never creates.

`pretrained` per model is applied by tools/train.py
(utils.save_load.load_submodel_pretrained), as the JAX trainer does.
"""

import copy

import torch
from torch import nn

from .base_model import build_base_model

__all__ = ["DistillationModel", "build_distillation_model"]


class DistillationModel(nn.Module):
    def __init__(self, model_names, models, frozen_names=()):
        super().__init__()
        self.model_names = tuple(model_names)
        self.frozen_names = tuple(frozen_names)
        for i, (name, model) in enumerate(zip(self.model_names, models)):
            if name in self.frozen_names:
                for part in getattr(model.head, "train_only", ()):
                    setattr(model.head, part, None)
                model.requires_grad_(False)
            self.add_module("models_%d" % i, model)
        self.train()

    def sub_model(self, name):
        return getattr(self, "models_%d" % self.model_names.index(name))

    def train(self, mode=True):
        super().train(mode)
        for name in self.frozen_names:
            self.sub_model(name).train(False)
        return self

    def forward(self, x, data=None, generator=None):
        result = {}
        for i, name in enumerate(self.model_names):
            model = getattr(self, "models_%d" % i)
            if name in self.frozen_names:
                with torch.no_grad():
                    result[name] = model(x, data=data, generator=generator)
            else:
                result[name] = model(x, data=data, generator=generator)
        return result


def build_distillation_model(config):
    config = copy.deepcopy(config)
    names, models, frozen = [], [], []
    for key in config["Models"]:
        model_config = copy.deepcopy(config["Models"][key])
        if model_config.pop("freeze_params", False):
            frozen.append(key)
        model_config.pop("pretrained", None)
        models.append(build_base_model(model_config))
        names.append(key)
    return DistillationModel(names, models, frozen)
