"""Loss registry — port of pytorchocr_tpu/losses/__init__.py:31. Losses are
callables (preds, batch) -> {"loss": scalar tensor, ...}."""

import copy

from .cls_loss import ClsLoss
from .det_db_loss import DBLoss
from .det_pan_loss import PANLoss
from .det_pse_loss import PSELoss
from .rec_ctc_loss import CTCLoss

__all__ = ["build_loss"]

_SUPPORTED = {"DBLoss": DBLoss, "PSELoss": PSELoss, "PANLoss": PANLoss, "CTCLoss": CTCLoss,
              "ClsLoss": ClsLoss}
_LATER = {"CombinedLoss": "A.12", "SLALoss": "A.13"}


def build_loss(config):
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name in _SUPPORTED:
        return _SUPPORTED[name](**config)
    if name in _LATER:
        raise NotImplementedError("loss %s is not ported yet (ROADMAP.md %s)"
                                  % (name, _LATER[name]))
    raise NotImplementedError("loss %s: unknown; the port supports %s" % (name, list(_SUPPORTED)))
