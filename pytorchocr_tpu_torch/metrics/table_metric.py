"""Table metrics — the port's copy of pytorchocr_tpu/metrics/table_metric.py
(`_token_edit_distance` :17, TableStructureMetric :42, TableMetric :99).

``acc`` is whole-sequence exact match: one wrong token scores the table 0.
``token_acc`` is the normalized token edit similarity (1 - levenshtein /
len over the structure tokens), a diagnostic that never selects the best
model (main_indicator stays ``acc``). With `compute_bbox_metric` the cell
boxes go through the port's DetMetric.
"""

import numpy as np

from .det_metric import DetMetric


def _token_edit_distance(a, b):
    """Levenshtein distance between two token SEQUENCES (numpy row DP)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    # map tokens to ids for fast vector compare
    vocab = {}
    ai = np.asarray([vocab.setdefault(t, len(vocab)) for t in a])
    bi = np.asarray([vocab.setdefault(t, len(vocab)) for t in b])
    prev = np.arange(len(bi) + 1)
    for i, ta in enumerate(ai):
        cur = np.empty(len(bi) + 1, dtype=np.int64)
        cur[0] = i + 1
        sub = prev[:-1] + (bi != ta)
        # cur[j+1] = min(prev[j+1]+1, sub[j], cur[j]+1) — the cur[j]+1 term
        # is a prefix-scan; resolve with the standard running-min trick
        np.minimum(prev[1:] + 1, sub, out=cur[1:])
        for j in range(len(bi)):  # insertion chain (rarely dominates)
            if cur[j] + 1 < cur[j + 1]:
                cur[j + 1] = cur[j] + 1
        prev = cur
    return int(prev[-1])


class TableStructureMetric:
    """Structure exact match ``acc`` and the ``token_acc`` diagnostic. With
    ``del_thead_tbody`` the thead/tbody tokens are filtered as whole tokens
    (as the JAX package does). ``acc`` compares the joined strings,
    ``token_acc`` the token lists."""

    def __init__(self, main_indicator="acc", eps=1e-6, del_thead_tbody=False, **kwargs):
        self.main_indicator = main_indicator
        self.eps = eps
        self.del_thead_tbody = del_thead_tbody
        self.reset()

    def __call__(self, pred_label, batch=None, *args, **kwargs):
        preds, labels = pred_label
        pred_structure_batch_list = preds["structure_batch_list"]
        gt_structure_batch_list = labels["structure_batch_list"]
        correct_num = 0
        all_num = 0
        strip = ("<thead>", "</thead>", "<tbody>", "</tbody>")
        for (pred, _), target in zip(
            pred_structure_batch_list, gt_structure_batch_list
        ):
            pred_toks = list(pred)
            target_toks = list(target)
            if self.del_thead_tbody:
                pred_toks = [t for t in pred_toks if t not in strip]
                target_toks = [t for t in target_toks if t not in strip]
            if "".join(pred_toks) == "".join(target_toks):
                correct_num += 1
            all_num += 1
            dist = _token_edit_distance(pred_toks, target_toks)
            denom = max(len(pred_toks), len(target_toks), 1)
            self.token_sim_sum += 1.0 - dist / denom
        self.correct_num += correct_num
        self.all_num += all_num

    def get_metric(self):
        acc = 1.0 * self.correct_num / (self.all_num + self.eps)
        token_acc = self.token_sim_sum / (self.all_num + self.eps)
        self.reset()
        return {"acc": acc, "token_acc": token_acc}

    def reset(self):
        self.correct_num = 0
        self.all_num = 0
        self.token_sim_sum = 0.0


class TableMetric:
    def __init__(
        self,
        main_indicator="acc",
        compute_bbox_metric=False,
        box_format="xyxy",
        del_thead_tbody=False,
        **kwargs
    ):
        self.structure_metric = TableStructureMetric(del_thead_tbody=del_thead_tbody)
        self.bbox_metric = DetMetric() if compute_bbox_metric else None
        self.main_indicator = main_indicator
        self.box_format = box_format
        self.reset()

    def __call__(self, pred_label, batch=None, *args, **kwargs):
        self.structure_metric(pred_label)
        if self.bbox_metric is not None:
            self.bbox_metric(*self.prepare_bbox_metric_input(pred_label))

    def prepare_bbox_metric_input(self, pred_label):
        pred_bbox_batch_list = []
        gt_ignore_tags_batch_list = []
        gt_bbox_batch_list = []
        preds, labels = pred_label

        batch_num = len(preds["bbox_batch_list"])
        for batch_idx in range(batch_num):
            pred_bbox_list = [
                self.format_box(pred_box)
                for pred_box in preds["bbox_batch_list"][batch_idx]
            ]
            pred_bbox_batch_list.append({"points": pred_bbox_list})

            gt_bbox_list = []
            gt_ignore_tags_list = []
            for gt_box in labels["bbox_batch_list"][batch_idx]:
                gt_bbox_list.append(self.format_box(gt_box))
                gt_ignore_tags_list.append(0)
            gt_bbox_batch_list.append(gt_bbox_list)
            gt_ignore_tags_batch_list.append(gt_ignore_tags_list)

        return [
            pred_bbox_batch_list,
            [0, 0, gt_bbox_batch_list, gt_ignore_tags_batch_list],
        ]

    def get_metric(self):
        structure_metric = self.structure_metric.get_metric()
        if self.bbox_metric is None:
            return structure_metric
        bbox_metric = self.bbox_metric.get_metric()
        if self.main_indicator == self.bbox_metric.main_indicator:
            output = bbox_metric
            for sub_key in structure_metric:
                output["structure_metric_{}".format(sub_key)] = structure_metric[
                    sub_key
                ]
        else:
            output = structure_metric
            for sub_key in bbox_metric:
                output["bbox_metric_{}".format(sub_key)] = bbox_metric[sub_key]
        return output

    def reset(self):
        self.structure_metric.reset()
        if self.bbox_metric is not None:
            self.bbox_metric.reset()

    def format_box(self, box):
        if self.box_format == "xyxy":
            x1, y1, x2, y2 = box
            box = [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]
        elif self.box_format == "xywh":
            x, y, w, h = box
            x1, y1, x2, y2 = x - w // 2, y - h // 2, x + w // 2, y + h // 2
            box = [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]
        elif self.box_format == "xyxyxyxy":
            x1, y1, x2, y2, x3, y3, x4, y4 = box
            box = [[x1, y1], [x2, y2], [x3, y3], [x4, y4]]
        return box
