"""Table structure decode — the port's copy of
pytorchocr_tpu/postprocess/table_postprocess.py (TableLabelDecode :10), an
AttnLabelDecode as in JAX (its `add_special_char`, `get_ignored_tokens`).
The predictions may be tensors on the card: they are read to the host as
float32 numpy."""

import numpy as np
import torch

from ..utils.assets import resolve_dict_path
from .rec_postprocess import AttnLabelDecode


def _host(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class TableLabelDecode(AttnLabelDecode):
    """`__call__(preds, batch)`: the greedy structure tokens (up to eos,
    sos and eos dropped) with their mean probability, and the boxes of the
    `td_token` steps scaled back to the source image by batch[-1] (the
    shapes); with more than the shapes in `batch`, also the labels'
    (`decode_label`)."""

    def __init__(self, character_dict_path, merge_no_span_structure=False, **kwargs):
        dict_character = []
        with open(resolve_dict_path(character_dict_path), "rb") as fin:
            for line in fin.readlines():
                line = line.decode("UTF-8").strip("\n").strip("\r\n")
                dict_character.append(line)

        if merge_no_span_structure:
            if "<td></td>" not in dict_character:
                dict_character.append("<td></td>")
            if "<td>" in dict_character:
                dict_character.remove("<td>")

        dict_character = self.add_special_char(dict_character)
        self.dict = {char: i for i, char in enumerate(dict_character)}
        self.character = dict_character
        self.td_token = ["<td>", "<td", "<td></td>"]

    def __call__(self, preds, batch=None):
        structure_probs = _host(preds["structure_probs"])
        bbox_preds = _host(preds["loc_preds"])
        shape_list = batch[-1]
        result = self.decode(structure_probs, bbox_preds, shape_list)
        if len(batch) == 1:  # only contains shape
            return result
        label_decode_result = self.decode_label(batch)
        return result, label_decode_result

    def decode(self, structure_probs, bbox_preds, shape_list):
        ignored_tokens = self.get_ignored_tokens()
        end_idx = self.dict[self.end_str]

        structure_idx = structure_probs.argmax(axis=2)
        structure_probs = structure_probs.max(axis=2)

        structure_batch_list = []
        bbox_batch_list = []
        batch_size = len(structure_idx)
        for batch_idx in range(batch_size):
            structure_list = []
            bbox_list = []
            score_list = []
            for idx in range(len(structure_idx[batch_idx])):
                char_idx = int(structure_idx[batch_idx][idx])
                if idx > 0 and char_idx == end_idx:
                    break
                if char_idx in ignored_tokens:
                    continue
                text = self.character[char_idx]
                if text in self.td_token:
                    bbox = bbox_preds[batch_idx, idx].copy()
                    bbox = self._bbox_decode(bbox, shape_list[batch_idx])
                    bbox_list.append(bbox)
                structure_list.append(text)
                score_list.append(structure_probs[batch_idx, idx])
            structure_batch_list.append(
                [structure_list, float(np.mean(score_list)) if score_list else 0.0]
            )
            bbox_batch_list.append(np.array(bbox_list))
        return {
            "bbox_batch_list": bbox_batch_list,
            "structure_batch_list": structure_batch_list,
        }

    @staticmethod
    def _bbox_decode(bbox, shape):
        src_h, src_w, ratio_h, ratio_w, dst_h, dst_w = shape
        bbox[0::2] *= dst_w
        bbox[1::2] *= dst_h
        bbox[0::2] /= ratio_w
        bbox[1::2] /= ratio_h
        return bbox

    def decode_label(self, batch):
        structure_idx = batch[1]
        gt_bbox_list = batch[2]
        shape_list = batch[-1]
        ignored_tokens = self.get_ignored_tokens()
        end_idx = self.dict[self.end_str]

        structure_batch_list = []
        bbox_batch_list = []
        batch_size = len(structure_idx)
        for batch_idx in range(batch_size):
            structure_list = []
            bbox_list = []
            for idx in range(len(structure_idx[batch_idx])):
                char_idx = int(structure_idx[batch_idx][idx])
                if idx > 0 and char_idx == end_idx:
                    break
                if char_idx in ignored_tokens:
                    continue
                structure_list.append(self.character[char_idx])
                bbox = np.asarray(gt_bbox_list[batch_idx][idx], dtype=np.float64).copy()
                if bbox.sum() != 0:
                    bbox = self._bbox_decode(bbox, shape_list[batch_idx])
                    bbox_list.append(bbox)
            structure_batch_list.append(structure_list)
            bbox_batch_list.append(bbox_list)
        return {
            "bbox_batch_list": bbox_batch_list,
            "structure_batch_list": structure_batch_list,
        }
