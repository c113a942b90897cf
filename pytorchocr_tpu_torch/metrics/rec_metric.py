"""Recognition metric — port of pytorchocr_tpu/metrics/rec_metric.py:11-58:
exact match and normalized edit distance, with the JAX arithmetic (spaces
removed, `is_filter`, `+ 1e-3` in `get_metric`). The edit distance is the
port's own plain dynamic program (`edit_distance`), in place of
`Levenshtein.distance`."""

import string

__all__ = ["RecMetric", "edit_distance"]


def edit_distance(a, b):
    """Levenshtein distance of two strings: unit-cost insertions, deletions
    and substitutions, one row of the dynamic program at a time."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class RecMetric:
    def __init__(self, main_indicator="acc", is_filter=False, **kwargs):
        self.main_indicator = main_indicator
        self.is_filter = is_filter
        self.reset()

    @staticmethod
    def _normalize_text(text):
        text = "".join(filter(lambda x: x in (string.digits + string.ascii_letters), text))
        return text.lower()

    def __call__(self, pred_label, *args, **kwargs):
        preds, labels = pred_label
        correct_num = 0
        all_num = 0
        norm_edit_dis = 0.0
        for (pred, _), (target, _) in zip(preds, labels):
            pred = pred.replace(" ", "")
            target = target.replace(" ", "")
            if self.is_filter:
                pred = self._normalize_text(pred)
                target = self._normalize_text(target)
            norm_edit_dis += edit_distance(pred, target) / max(len(pred), len(target), 1)
            if pred == target:
                correct_num += 1
            all_num += 1
        self.correct_num += correct_num
        self.all_num += all_num
        self.norm_edit_dis += norm_edit_dis
        return {
            "acc": correct_num / all_num if all_num else 0.0,
            "norm_edit_dis": 1 - norm_edit_dis / (all_num + 1e-3),
        }

    def get_metric(self):
        acc = 1.0 * self.correct_num / (self.all_num + 1e-3)
        norm_edit_dis = 1 - self.norm_edit_dis / (self.all_num + 1e-3)
        self.reset()
        return {"acc": acc, "norm_edit_dis": norm_edit_dis}

    def reset(self):
        self.correct_num = 0
        self.all_num = 0
        self.norm_edit_dis = 0
