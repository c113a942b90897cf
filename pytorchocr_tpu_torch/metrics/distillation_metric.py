"""One metric per model, and the best of `keys` on `main_indicator` — port
of pytorchocr_tpu/metrics/distillation_metric.py:8-53."""

from .cls_metric import ClsMetric
from .det_metric import DetMetric
from .rec_metric import RecMetric

__all__ = ["DistillationMetric"]

_BASE_METRICS = {"DetMetric": DetMetric, "RecMetric": RecMetric, "ClsMetric": ClsMetric}


class DistillationMetric:
    def __init__(self, keys=None, base_metric_name=None, main_indicator=None, **kwargs):
        self.main_indicator = main_indicator
        self.keys = keys if isinstance(keys, list) else [keys]
        self.base_metric_name = base_metric_name
        self.kwargs = kwargs
        self.metrics = None

    def _init_metrics(self, preds):
        self.metrics = {}
        for key in preds:
            self.metrics[key] = _BASE_METRICS[self.base_metric_name](
                main_indicator=self.main_indicator, **self.kwargs)
            self.metrics[key].reset()

    def __call__(self, preds, batch, **kwargs):
        assert isinstance(preds, dict)
        if self.metrics is None:
            self._init_metrics(preds)
        for key in preds:
            self.metrics[key](preds[key], batch, **kwargs)

    def get_metric(self):
        """The metric of the best model of `keys` by `main_indicator` (the
        first on a tie), and every model's as `<name>_<metric>`."""
        output = {}
        best_main_indicator = -1
        for key in self.metrics:
            metric = self.metrics[key].get_metric()
            if key in self.keys and metric[self.main_indicator] > best_main_indicator:
                best_main_indicator = metric[self.main_indicator]
                output.update(metric)
            for sub_key in metric:
                output["{}_{}".format(key, sub_key)] = metric[sub_key]
        return output

    def reset(self):
        for key in self.metrics:
            self.metrics[key].reset()
