"""Neck registry — port of pytorchocr_tpu/modeling/necks/__init__.py."""

from ..registry import build
from .csp_pan import CSPPAN
from .fpem_ffm import FPEM_FFM
from .fpn import FPN
from .rnn import SequenceEncoder

__all__ = ["build_neck", "neck_out_channels"]

_NECKS = {"FPN": FPN, "FPEM_FFM": FPEM_FFM, "SequenceEncoder": SequenceEncoder,
          "CSPPAN": CSPPAN}
_LATER = {}


def build_neck(config):
    return build("neck", _NECKS, _LATER, config)


def neck_out_channels(neck):
    """Output channel count of a constructed neck module."""
    return getattr(neck, "fused_channels", None) or neck.out_channels
