"""Loss registry — port of pytorchocr_tpu/losses/__init__.py:31. Losses are
callables (preds, batch) -> {"loss": scalar tensor, ...}."""

import copy

from .det_db_loss import DBLoss

__all__ = ["build_loss"]

_LATER = {"CTCLoss": "A.7", "ClsLoss": "A.7", "PSELoss": "A.7", "PANLoss": "A.7",
          "CombinedLoss": "A.12", "SLALoss": "A.13"}


def build_loss(config):
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name == "DBLoss":
        return DBLoss(**config)
    if name in _LATER:
        raise NotImplementedError("loss %s is not ported yet (ROADMAP.md %s)"
                                  % (name, _LATER[name]))
    raise NotImplementedError("loss %s: unknown; the port supports ['DBLoss']" % name)
