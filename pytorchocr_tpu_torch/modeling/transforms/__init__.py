"""Transform registry — port of pytorchocr_tpu/modeling/transforms/__init__.py."""

from ..registry import build
from .tps import TPS

__all__ = ["build_transform"]

_TRANSFORMS = {"TPS": TPS}


def build_transform(config):
    return build("transform", _TRANSFORMS, {}, config)
