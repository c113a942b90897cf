"""Label encoders — the port's copy of ClsLabelEncode, DetLabelEncode,
BaseRecLabelEncode and CTCLabelEncode
(pytorchocr_tpu/data/imaug/label_ops.py:11,25,54,115). AttnLabelEncode
waits for STAR-Net (ROADMAP.md A.11).
"""

import json

import numpy as np

from ...utils.assets import resolve_dict_path
from ...utils.logging import get_logger


class ClsLabelEncode:
    """Label string of `label_list` -> its index; any other label drops the
    sample (None). From label_ops.py:11."""

    def __init__(self, label_list, **kwargs):
        self.label_list = label_list

    def __call__(self, data):
        label = data["label"]
        if label not in self.label_list:
            return None
        data["label"] = self.label_list.index(label)
        return data


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


class BaseRecLabelEncode:
    """Text <-> index table. Without `character_dict_path` the table is the
    36 lowercase alphanumerics and texts are lowercased. From
    label_ops.py:54."""

    def __init__(self, max_text_length, character_dict_path=None, use_space_char=False,
                 lower=False, cn2en=False):
        self.max_text_len = max_text_length
        self.beg_str = "sos"
        self.end_str = "eos"
        self.lower = lower
        self.cn2en = cn2en

        if character_dict_path is None:
            get_logger().warning("The character_dict_path is None, model can only recognize "
                                 "number and lower letters")
            self.character_str = "0123456789abcdefghijklmnopqrstuvwxyz"
            dict_character = list(self.character_str)
            self.lower = True
        else:
            self.character_str = ""
            with open(resolve_dict_path(character_dict_path), "rb") as fin:
                for line in fin.readlines():
                    self.character_str += line.decode("UTF-8").strip("\n").strip("\r\n")
            if use_space_char:
                self.character_str += " "
            dict_character = list(self.character_str)
        dict_character = self.add_special_char(dict_character)
        self.dict = {char: i for i, char in enumerate(dict_character)}
        self.character = dict_character

    def add_special_char(self, dict_character):
        return dict_character

    def encode(self, text):
        """Text -> index list; None for an empty text, one longer than
        max_text_length, or one with no character of the table."""
        if len(text) == 0 or len(text) > self.max_text_len:
            return None
        if self.lower:
            text = text.lower()
        if self.cn2en:
            for a, b in [("\uff08", "("), ("\uff09", ")"), ("\uff1a", ":"), ("\uff1b", ";"),
                         ("\uff01", "!"), ("\uff1f", "?")]:
                text = text.replace(a, b)
        text_list = []
        for char in text:
            if char not in self.dict:
                get_logger().warning("{} is not in dict".format(char))
                continue
            text_list.append(self.dict[char])
        if len(text_list) == 0:
            return None
        return text_list


class CTCLabelEncode(BaseRecLabelEncode):
    """Text -> `label` (indices zero-padded to max_text_length), `length`
    and the ACE histogram `label_ace`; blank is index 0. From
    label_ops.py:115."""

    def __init__(self, max_text_length, character_dict_path=None, use_space_char=False,
                 cn2en=False, **kwargs):
        super().__init__(max_text_length, character_dict_path, use_space_char, cn2en=cn2en)

    def __call__(self, data):
        text = self.encode(data["label"])
        if text is None:
            return None
        data["length"] = np.array(len(text))
        text = text + [0] * (self.max_text_len - len(text))
        data["label"] = np.array(text)
        label = [0] * len(self.character)
        for x in text:
            label[x] += 1
        data["label_ace"] = np.array(label)
        return data

    def add_special_char(self, dict_character):
        return ["blank"] + dict_character
