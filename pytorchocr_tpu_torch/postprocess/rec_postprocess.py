"""CTC and attention label decode — port of
pytorchocr_tpu/postprocess/rec_postprocess.py.

CTC: the greedy collapse runs on the tensor's device (ops/ctc_decode.py);
only (codes, lengths, conf) cross to the host, where the character table
maps codes to text. The table and the label `decode` are the port's copy of
pytorchocr_tpu/postprocess/rec_postprocess.py:13-66,126-127.
AttnLabelDecode (:157) takes the argmax and max of a tensor on its device;
only the (N, T) indices and probabilities cross to the host.
"""

import numpy as np
import torch

from ..ops.ctc_decode import ctc_greedy_collapse
from ..utils.assets import resolve_dict_path


def _dictionary(character_dict_path, use_space_char):
    """The dictionary's lines (and " " with use_space_char), or the 36
    lowercase alphanumerics without one. From rec_postprocess.py:16-35."""
    if character_dict_path is None:
        return list("0123456789abcdefghijklmnopqrstuvwxyz")
    dict_character = []
    with open(resolve_dict_path(character_dict_path), "rb") as fin:
        for line in fin.readlines():
            dict_character.append(line.decode("UTF-8").strip("\n").strip("\r\n"))
    if use_space_char:
        dict_character.append(" ")
    return dict_character


class CTCLabelDecode:
    def __init__(self, character_dict_path=None, use_space_char=False, **kwargs):
        # the table: "blank", then the dictionary
        self.character = ["blank"] + _dictionary(character_dict_path, use_space_char)

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


def _to_idx_prob(preds):
    """(N, T, C) probabilities -> ((N, T) argmax, (N, T) max) as numpy, reduced
    on the tensor's device; an (indices, probabilities) pair passes through.
    From rec_postprocess.py:68."""
    if isinstance(preds, tuple) and len(preds) == 2:
        idx, prob = preds
        return np.asarray(idx), np.asarray(prob)
    if torch.is_tensor(preds):
        prob, idx = preds.detach().float().max(dim=2)
        return idx.cpu().numpy(), prob.cpu().numpy()
    preds = np.asarray(preds)
    return preds.argmax(axis=2), preds.max(axis=2)


class AttnLabelDecode:
    """sos / eos decode: the table is "sos", the dictionary's lines (the 36
    lowercase alphanumerics without one), "eos". A row's text runs to its
    first eos, sos skipped, with the mean probability of its characters;
    the labels decode alike. From rec_postprocess.py:157.

    Stopping at eos is the JAX package's rule (rec_postprocess.py:185-188):
    the reference it ports skips sos and eos before its eos test can stop
    the row, so it reads past eos."""

    def __init__(self, character_dict_path=None, use_space_char=False, **kwargs):
        dict_character = self.add_special_char(_dictionary(character_dict_path, use_space_char))
        self.dict = {char: i for i, char in enumerate(dict_character)}
        self.character = dict_character

    def add_special_char(self, dict_character):
        self.beg_str = "sos"
        self.end_str = "eos"
        return [self.beg_str] + dict_character + [self.end_str]

    def get_ignored_tokens(self):
        return [np.array(self.dict[self.beg_str]), np.array(self.dict[self.end_str])]

    def __call__(self, preds, label=None, *args, **kwargs):
        preds_idx, preds_prob = _to_idx_prob(preds)
        text = self.decode(preds_idx, preds_prob)
        if label is None:
            return text
        return text, self.decode(np.asarray(label))

    def decode(self, text_index, text_prob=None, is_remove_duplicate=False):
        result_list = []
        ignored_tokens = self.get_ignored_tokens()
        end_idx = int(ignored_tokens[1])
        for batch_idx in range(len(text_index)):
            char_list = []
            conf_list = []
            row = text_index[batch_idx]
            for idx in range(len(row)):
                if int(row[idx]) == end_idx:
                    break
                if row[idx] in ignored_tokens:
                    continue
                if is_remove_duplicate and idx > 0 and row[idx - 1] == row[idx]:
                    continue
                char_list.append(self.character[int(row[idx])])
                conf_list.append(1 if text_prob is None else text_prob[batch_idx][idx])
            result_list.append(("".join(char_list),
                                float(np.mean(conf_list)) if conf_list else 0.0))
        return result_list
