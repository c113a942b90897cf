"""Metric registry — port of pytorchocr_tpu/metrics/__init__.py:22."""

import copy

from .cls_metric import ClsMetric
from .det_metric import DetMetric
from .rec_metric import RecMetric
from .table_metric import TableMetric

__all__ = ["build_metric"]

_SUPPORTED = {"DetMetric": DetMetric, "RecMetric": RecMetric, "ClsMetric": ClsMetric,
              "TableMetric": TableMetric}
_LATER = {"DistillationMetric": "A.12"}


def build_metric(config):
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name in _SUPPORTED:
        return _SUPPORTED[name](**config)
    if name in _LATER:
        raise NotImplementedError("metric %s is not ported yet (ROADMAP.md %s)"
                                  % (name, _LATER[name]))
    raise NotImplementedError("metric %s: unknown; the port supports %s" % (name, list(_SUPPORTED)))
