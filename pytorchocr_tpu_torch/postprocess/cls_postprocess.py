"""Direction-classifier postprocess — port of
pytorchocr_tpu/postprocess/cls_postprocess.py: per row the argmax label of
`label_list` and its probability."""

import numpy as np
import torch


class ClsPostProcess:
    def __init__(self, label_list=("0", "180"), **kwargs):
        self.label_list = list(label_list)

    def __call__(self, preds, label=None, *args, **kwargs):
        if torch.is_tensor(preds):
            preds = preds.float().cpu().numpy()
        preds = np.asarray(preds)
        pred_idxs = preds.argmax(axis=1)
        decode_out = [(self.label_list[idx], float(preds[i, idx]))
                      for i, idx in enumerate(pred_idxs)]
        if label is None:
            return decode_out
        label = [(self.label_list[int(idx)], 1.0) for idx in np.asarray(label)]
        return decode_out, label
