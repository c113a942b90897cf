"""Head registry — port of pytorchocr_tpu/modeling/heads/__init__.py."""

from ..registry import build
from .det_db_head import DBHead
from .det_pan_head import PANHead
from .det_pse_head import PSEHead
from .rec_ctc_head import CTCHead

__all__ = ["build_head"]

_HEADS = {"DBHead": DBHead, "PSEHead": PSEHead, "PANHead": PANHead, "CTCHead": CTCHead}
_LATER = {"ClsHead": "A.5", "SLAHead": "A.13"}


def build_head(config):
    return build("head", _HEADS, _LATER, config)
