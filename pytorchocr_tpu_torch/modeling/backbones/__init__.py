"""Backbone registry — port of pytorchocr_tpu/modeling/backbones/__init__.py."""

from ..registry import build
from .det_mobilenet_v3 import MobileNetV3 as DetMobileNetV3
from .det_pplcnet import PPLCNet
from .det_repvgg import RepVGG
from .det_resnet import ResNet
from .det_shufflenet_v2 import ShuffleNetV2
from .rec_mobilenet_v3 import MobileNetV3
from .rec_vgg import VGG

__all__ = ["build_backbone"]

_DET = {"ResNet": ResNet, "MobileNetV3": DetMobileNetV3, "ShuffleNetV2": ShuffleNetV2,
        "RepVGG": RepVGG, "PPLCNet": PPLCNet}
_DET_LATER = {"ConvNeXt": "A.11", "SwinTransformer": "A.11"}
_REC = {"VGG": VGG, "MobileNetV3": MobileNetV3}
_REC_LATER = {"ResNet": "A.11"}


def build_backbone(config, model_type):
    if model_type in ("det", "table"):
        return build("backbone", _DET, _DET_LATER, config)
    if model_type in ("rec", "cls"):
        return build("backbone", _REC, _REC_LATER, config)
    raise NotImplementedError(model_type)
