"""CTC label decode — port of pytorchocr_tpu/postprocess/rec_postprocess.py.

The greedy collapse runs on the tensor's device (ops/ctc_decode.py); only
(codes, lengths, conf) cross to the host, where the character table maps
codes to text. The table and the label `decode` are the port's copy of
pytorchocr_tpu/postprocess/rec_postprocess.py:13-66,126-127. Not ported:
AttnLabelDecode (ROADMAP.md A.11).
"""

import numpy as np
import torch

from ..ops.ctc_decode import ctc_greedy_collapse
from ..utils.assets import resolve_dict_path


class CTCLabelDecode:
    def __init__(self, character_dict_path=None, use_space_char=False, **kwargs):
        # the table: "blank", then the dictionary's lines (rec_postprocess.py:16-35)
        if character_dict_path is None:
            dict_character = list("0123456789abcdefghijklmnopqrstuvwxyz")
        else:
            dict_character = []
            with open(resolve_dict_path(character_dict_path), "rb") as fin:
                for line in fin.readlines():
                    dict_character.append(line.decode("UTF-8").strip("\n").strip("\r\n"))
            if use_space_char:
                dict_character.append(" ")
        self.character = ["blank"] + dict_character

    def __call__(self, preds, label=None, *args, **kwargs):
        if isinstance(preds, (list, tuple)):
            preds = preds[-1]
        if not torch.is_tensor(preds):
            preds = torch.from_numpy(np.asarray(preds))
        max_len = min(int(preds.shape[1]), 128)
        codes, lengths, conf = ctc_greedy_collapse(preds, max_len=max_len)
        codes, lengths, conf = codes.cpu().numpy(), lengths.cpu().numpy(), conf.cpu().numpy()
        text = [
            ("".join(self.character[c] for c in codes[i, : lengths[i]]), float(conf[i]))
            for i in range(codes.shape[0])
        ]
        if label is None:
            return text
        return text, self.decode(np.asarray(label))

    def decode(self, text_index, text_prob=None, is_remove_duplicate=False):
        """Label codes -> (text, mean confidence) per row, blanks (0) dropped.
        From rec_postprocess.py:40."""
        result_list = []
        for batch_idx in range(len(text_index)):
            char_list = []
            conf_list = []
            for idx in range(len(text_index[batch_idx])):
                if text_index[batch_idx][idx] == 0:
                    continue
                if is_remove_duplicate and idx > 0 and (
                    text_index[batch_idx][idx - 1] == text_index[batch_idx][idx]
                ):
                    continue
                char_list.append(self.character[int(text_index[batch_idx][idx])])
                conf_list.append(1 if text_prob is None else text_prob[batch_idx][idx])
            result_list.append(("".join(char_list), np.mean(conf_list) if conf_list else 0.0))
        return result_list


class DistillationCTCLabelDecode(CTCLabelDecode):
    """CTCLabelDecode over each named model's output (its `key` entry where
    given): {name: that model's decode}. From rec_postprocess.py:130."""

    def __init__(self, character_dict_path=None, use_space_char=False, model_name=("student",),
                 key=None, **kwargs):
        super().__init__(character_dict_path, use_space_char)
        if not isinstance(model_name, (list, tuple)):
            model_name = [model_name]
        self.model_name = list(model_name)
        self.key = key

    def __call__(self, preds, label=None, *args, **kwargs):
        output = {}
        for name in self.model_name:
            pred = preds[name]
            if self.key is not None:
                pred = pred[self.key]
            output[name] = super().__call__(pred, label=label, *args, **kwargs)
        return output
