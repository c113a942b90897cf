"""BaseModel: Transform -> Backbone -> Neck -> Head — port of
pytorchocr_tpu/modeling/architectures/base_model.py.

`build_base_model` runs the same channel-inference chain as the JAX version
(:55-60): `Architecture.in_channels` feeds the transform (STAR-Net's TPS),
whose `out_channels` feed the backbone. The input is NCHW.

`forward(x, data=None, generator=None)`: the train step's torch.Generator
(trainer.sample_generator) reaches a head that declares `takes_generator`
(SLAHead's scheduled sampling) and no other module, as only the JAX head
that asks for the "sample" rng reads it.
"""

import copy

from torch import nn

from ..backbones import build_backbone
from ..heads import build_head
from ..necks import build_neck, neck_out_channels
from ..transforms import build_transform

__all__ = ["BaseModel", "build_base_model"]


class BaseModel(nn.Module):
    def __init__(self, backbone, head, neck=None, return_all_feats=False, transform=None):
        super().__init__()
        self.transform = transform
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.return_all_feats = return_all_feats

    def forward(self, x, data=None, generator=None):
        y = {}
        if self.transform is not None:
            x = self.transform(x)
        x = self.backbone(x)
        y["backbone_out"] = x
        if self.neck is not None:
            x = self.neck(x)
        y["neck_out"] = x
        if getattr(self.head, "takes_generator", False):
            x = self.head(x, targets=data, generator=generator)
        else:
            x = self.head(x, targets=data)
        if isinstance(x, dict):
            y.update(x)
        else:
            y["head_out"] = x
        return y if self.return_all_feats else x


def build_base_model(config):
    """Construct a BaseModel from an Architecture config section."""
    config = copy.deepcopy(config)
    in_channels = config.get("in_channels", 3)
    transform = None
    if config.get("Transform"):
        tcfg = dict(config["Transform"])
        tcfg["in_channels"] = in_channels
        transform = build_transform(tcfg)
        in_channels = transform.out_channels
    bcfg = dict(config["Backbone"])
    bcfg["in_channels"] = in_channels
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
    return BaseModel(backbone, head, neck, config.get("return_all_feats", False), transform)
