"""Metric registry — port of pytorchocr_tpu/metrics/__init__.py:22."""

import copy

from .det_metric import DetMetric

__all__ = ["build_metric"]

_LATER = {"RecMetric": "A.7", "ClsMetric": "A.7", "DistillationMetric": "A.12",
          "TableMetric": "A.13"}


def build_metric(config):
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name == "DetMetric":
        return DetMetric(**config)
    if name in _LATER:
        raise NotImplementedError("metric %s is not ported yet (ROADMAP.md %s)"
                                  % (name, _LATER[name]))
    raise NotImplementedError("metric %s: unknown; the port supports ['DetMetric']" % name)
