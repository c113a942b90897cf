"""Label encoders — the port's copy of DetLabelEncode
(pytorchocr_tpu/data/imaug/label_ops.py:25). The rec and cls encoders wait
for the next training slice (ROADMAP.md A.7).
"""

import json

import numpy as np


class DetLabelEncode:
    """JSON label -> polys (padded to max point count), texts, ignore_tags.
    From label_ops.py:25."""

    def __init__(self, ignore_txt=("*", "###"), **kwargs):
        self.ignore_txt = list(ignore_txt)

    def __call__(self, data):
        label = json.loads(data["label"])
        boxes, txts, txt_tags = [], [], []
        for item in label:
            boxes.append(item["points"])
            txt = item["transcription"]
            txts.append(txt)
            txt_tags.append(txt in self.ignore_txt)
        if len(boxes) == 0:
            return None
        boxes = self.expand_points_num(boxes)
        data["polys"] = np.array(boxes, dtype=np.float32)
        data["texts"] = txts
        data["ignore_tags"] = np.array(txt_tags, dtype=bool)
        return data

    @staticmethod
    def expand_points_num(boxes):
        max_points_num = max(len(b) for b in boxes)
        return [list(b) + [b[-1]] * (max_points_num - len(b)) for b in boxes]
