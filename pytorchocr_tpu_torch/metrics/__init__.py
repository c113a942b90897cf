"""Metric registry — port of pytorchocr_tpu/metrics/__init__.py:22."""

import copy

from .cls_metric import ClsMetric
from .det_metric import DetMetric
from .distillation_metric import DistillationMetric
from .rec_metric import RecMetric
from .table_metric import TableMetric

__all__ = ["build_metric"]

_SUPPORTED = {"DetMetric": DetMetric, "RecMetric": RecMetric, "ClsMetric": ClsMetric,
              "TableMetric": TableMetric, "DistillationMetric": DistillationMetric}


def build_metric(config):
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name in _SUPPORTED:
        return _SUPPORTED[name](**config)
    raise NotImplementedError("metric %s: unknown; the port supports %s" % (name, list(_SUPPORTED)))
