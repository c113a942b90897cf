"""Head registry — port of pytorchocr_tpu/modeling/heads/__init__.py."""

from ..registry import build
from .cls_head import ClsHead
from .det_db_head import DBHead
from .det_pan_head import PANHead
from .det_pse_head import PSEHead
from .rec_ctc_head import CTCHead
from .table_att_head import SLAHead

__all__ = ["build_head"]

_HEADS = {"DBHead": DBHead, "PSEHead": PSEHead, "PANHead": PANHead, "CTCHead": CTCHead,
          "ClsHead": ClsHead, "SLAHead": SLAHead}
_LATER = {}


def build_head(config):
    return build("head", _HEADS, _LATER, config)
