"""Architecture registry — port of
pytorchocr_tpu/modeling/architectures/__init__.py."""

import copy

from .base_model import BaseModel, build_base_model

__all__ = ["build_model", "BaseModel"]


def build_model(config):
    config = copy.deepcopy(config)
    if "name" not in config:
        return build_base_model(config)
    name = config.pop("name")
    if name == "DistillationModel":
        raise NotImplementedError("DistillationModel is not ported yet (ROADMAP.md A.12)")
    raise NotImplementedError("architecture %s: unknown" % name)
