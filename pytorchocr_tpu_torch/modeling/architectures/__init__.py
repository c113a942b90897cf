"""Architecture registry — port of
pytorchocr_tpu/modeling/architectures/__init__.py."""

import copy

from .base_model import BaseModel, build_base_model
from .distillation_model import DistillationModel, build_distillation_model

__all__ = ["build_model", "BaseModel", "DistillationModel"]


def build_model(config):
    config = copy.deepcopy(config)
    if "name" not in config:
        return build_base_model(config)
    name = config.pop("name")
    if name == "DistillationModel":
        return build_distillation_model(config)
    raise NotImplementedError("architecture %s: unknown" % name)
