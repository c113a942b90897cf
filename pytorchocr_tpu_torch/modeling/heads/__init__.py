"""Head registry — port of pytorchocr_tpu/modeling/heads/__init__.py."""

from ..registry import build
from .det_db_head import DBHead
from .rec_ctc_head import CTCHead

__all__ = ["build_head"]

_HEADS = {"DBHead": DBHead, "CTCHead": CTCHead}
_LATER = {"PSEHead": "A.10", "PANHead": "A.10", "ClsHead": "A.5", "SLAHead": "A.13"}


def build_head(config):
    return build("head", _HEADS, _LATER, config)
