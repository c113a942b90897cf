"""Backbone registry — port of pytorchocr_tpu/modeling/backbones/__init__.py."""

from ..registry import build
from .det_resnet import ResNet
from .rec_mobilenet_v3 import MobileNetV3
from .rec_vgg import VGG

__all__ = ["build_backbone"]

_DET = {"ResNet": ResNet}
_DET_LATER = {
    "MobileNetV3": "A.11", "ShuffleNetV2": "A.11", "RepVGG": "A.11",
    "ConvNeXt": "A.11", "SwinTransformer": "A.11", "PPLCNet": "A.11",
}
_REC = {"VGG": VGG, "MobileNetV3": MobileNetV3}
_REC_LATER = {"ResNet": "A.11"}


def build_backbone(config, model_type):
    if model_type in ("det", "table"):
        return build("backbone", _DET, _DET_LATER, config)
    if model_type in ("rec", "cls"):
        return build("backbone", _REC, _REC_LATER, config)
    raise NotImplementedError(model_type)
