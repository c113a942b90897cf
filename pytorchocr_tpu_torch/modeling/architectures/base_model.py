"""BaseModel: Backbone -> Neck -> Head — port of
pytorchocr_tpu/modeling/architectures/base_model.py.

`build_base_model` runs the same channel-inference chain as the JAX version.
The input is NCHW. Not ported: the Transform stage (STAR-Net TPS, ROADMAP.md
A.11).
"""

import copy

from torch import nn

from ..backbones import build_backbone
from ..heads import build_head
from ..necks import build_neck, neck_out_channels

__all__ = ["BaseModel", "build_base_model"]


class BaseModel(nn.Module):
    def __init__(self, backbone, head, neck=None, return_all_feats=False):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.return_all_feats = return_all_feats

    def forward(self, x, data=None):
        y = {}
        x = self.backbone(x)
        y["backbone_out"] = x
        if self.neck is not None:
            x = self.neck(x)
        y["neck_out"] = x
        x = self.head(x, targets=data)
        if isinstance(x, dict):
            y.update(x)
        else:
            y["head_out"] = x
        return y if self.return_all_feats else x


def build_base_model(config):
    """Construct a BaseModel from an Architecture config section."""
    config = copy.deepcopy(config)
    if config.get("Transform"):
        raise NotImplementedError("Transform (TPS) is not ported yet (ROADMAP.md A.11)")
    bcfg = dict(config["Backbone"])
    bcfg["in_channels"] = config.get("in_channels", 3)
    backbone = build_backbone(bcfg, config["model_type"])
    in_channels = backbone.out_channels

    neck = None
    if config.get("Neck"):
        ncfg = dict(config["Neck"])
        ncfg["in_channels"] = in_channels
        neck = build_neck(ncfg)
        in_channels = neck_out_channels(neck)

    hcfg = dict(config["Head"])
    hcfg["in_channels"] = in_channels
    head = build_head(hcfg)
    return BaseModel(backbone, head, neck, config.get("return_all_feats", False))
