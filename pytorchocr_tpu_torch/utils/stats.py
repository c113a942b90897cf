"""Median-smoothed training statistics windows — the port's copy of
pytorchocr_tpu/utils/stats.py."""

import collections

import numpy as np


class SmoothedValue:
    """The last `window_size` values of a series and their median."""

    def __init__(self, window_size):
        self.deque = collections.deque(maxlen=window_size)

    def add_value(self, value):
        self.deque.append(float(value))

    def get_median_value(self):
        return np.median(self.deque)


class TrainingStats:
    def __init__(self, window_size, stats_keys):
        self.window_size = window_size
        self.smoothed_losses_and_metrics = {
            key: SmoothedValue(window_size) for key in stats_keys
        }

    def update(self, stats):
        for k, v in stats.items():
            if k not in self.smoothed_losses_and_metrics:
                self.smoothed_losses_and_metrics[k] = SmoothedValue(self.window_size)
            self.smoothed_losses_and_metrics[k].add_value(float(v))

    def get(self, extras=None):
        stats = collections.OrderedDict()
        if extras:
            for k, v in extras.items():
                stats[k] = v
        for k, v in self.smoothed_losses_and_metrics.items():
            stats[k] = round(v.get_median_value(), 6)
        return stats

    def log(self, extras=None):
        d = self.get(extras)
        strs = ["{}: {:x<6f}".format(k, v) if isinstance(v, float) else "{}: {}".format(k, v)
                for k, v in d.items()]
        return ", ".join(strs)
