"""Backbone registry — port of pytorchocr_tpu/modeling/backbones/__init__.py."""

from ..registry import build
from .det_convnext import ConvNeXt
from .det_mobilenet_v3 import MobileNetV3 as DetMobileNetV3
from .det_pplcnet import PPLCNet
from .det_repvgg import RepVGG
from .det_resnet import ResNet
from .det_shufflenet_v2 import ShuffleNetV2
from .det_swin import SwinTransformer
from .rec_mobilenet_v3 import MobileNetV3
from .rec_resnet import ResNet as RecResNet
from .rec_vgg import VGG

__all__ = ["build_backbone"]

_DET = {"ResNet": ResNet, "MobileNetV3": DetMobileNetV3, "ShuffleNetV2": ShuffleNetV2,
        "RepVGG": RepVGG, "ConvNeXt": ConvNeXt, "SwinTransformer": SwinTransformer,
        "PPLCNet": PPLCNet}
_REC = {"VGG": VGG, "ResNet": RecResNet, "MobileNetV3": MobileNetV3}


def build_backbone(config, model_type):
    if model_type in ("det", "table"):
        return build("backbone", _DET, {}, config)
    if model_type in ("rec", "cls"):
        return build("backbone", _REC, {}, config)
    raise NotImplementedError(model_type)
