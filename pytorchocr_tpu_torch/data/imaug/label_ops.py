"""Label encoders — the port's copy of ClsLabelEncode, DetLabelEncode,
BaseRecLabelEncode, CTCLabelEncode, AttnLabelEncode, TableLabelEncode and
TableBoxEncode (pytorchocr_tpu/data/imaug/label_ops.py:11,25,54,115,146,180,
345). TableLabelEncode is an AttnLabelEncode, as in JAX: it takes its
"sos" / "eos" table.
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


class AttnLabelEncode(BaseRecLabelEncode):
    """Text -> `label`: sos (0), the text's indices, eos (the table's last
    index), zero-padded to max_text_length, and `length`, the text's own
    length; None where the text is max_text_length long or longer. The table
    is "sos", the characters, "eos". From label_ops.py:146."""

    def __init__(self, max_text_length, character_dict_path=None, use_space_char=False,
                 **kwargs):
        super().__init__(max_text_length, character_dict_path, use_space_char)

    def add_special_char(self, dict_character):
        self.beg_str = "sos"
        self.end_str = "eos"
        return [self.beg_str] + dict_character + [self.end_str]

    def __call__(self, data):
        text = self.encode(data["label"])
        if text is None or len(text) >= self.max_text_len:
            return None
        data["length"] = np.array(len(text))
        text = ([0] + text + [len(self.character) - 1]
                + [0] * (self.max_text_len - len(text) - 2))
        data["label"] = np.array(text)
        return data


class TableLabelEncode(AttnLabelEncode):
    """Table structure tokens -> `structure` (sos, the token indices, eos,
    padded with sos to max_text_length + 2; None when longer), per-token
    cell boxes `bboxes` (loc_reg_num each) and `bbox_masks`, and the aux
    count targets `row_cnt` / `col_cnt` (clipped at 31). The table is the
    dictionary's lines (with merge_no_span_structure "<td></td>" in place
    of "<td>") between "sos" and "eos" (AttnLabelEncode.add_special_char).
    From label_ops.py:180."""

    def __init__(
        self,
        max_text_length,
        character_dict_path,
        replace_empty_cell_token=False,
        merge_no_span_structure=False,
        learn_empty_box=False,
        loc_reg_num=4,
        **kwargs
    ):
        self.max_text_len = max_text_length
        self.learn_empty_box = learn_empty_box
        self.merge_no_span_structure = merge_no_span_structure
        self.replace_empty_cell_token = replace_empty_cell_token

        dict_character = []
        with open(resolve_dict_path(character_dict_path), "rb") as fin:
            for line in fin.readlines():
                line = line.decode("UTF-8").strip("\n").strip("\r\n")
                dict_character.append(line)

        if self.merge_no_span_structure:
            if "<td></td>" not in dict_character:
                dict_character.append("<td></td>")
            if "<td>" in dict_character:
                dict_character.remove("<td>")

        dict_character = self.add_special_char(dict_character)
        self.dict = {char: i for i, char in enumerate(dict_character)}
        self.idx2char = {v: k for k, v in self.dict.items()}
        self.character = dict_character
        self.loc_reg_num = loc_reg_num
        self.pad_idx = self.dict[self.beg_str]
        self.start_idx = self.dict[self.beg_str]
        self.end_idx = self.dict[self.end_str]

        self.td_token = ["<td>", "<td", "<eb></eb>", "<td></td>"]
        self.empty_bbox_token_dict = {
            "[]": "<eb></eb>",
            "[' ']": "<eb1></eb1>",
            "['<b>', ' ', '</b>']": "<eb2></eb2>",
            "['\\u2028', '\\u2028']": "<eb3></eb3>",
            "['<sup>', ' ', '</sup>']": "<eb4></eb4>",
            "['<b>', '</b>']": "<eb5></eb5>",
            "['<i>', ' ', '</i>']": "<eb6></eb6>",
            "['<b>', '<i>', '</i>', '</b>']": "<eb7></eb7>",
            "['<b>', '<i>', ' ', '</i>', '</b>']": "<eb8></eb8>",
            "['<i>', '</i>']": "<eb9></eb9>",
            "['<b>', ' ', '\\u2028', ' ', '\\u2028', ' ', '</b>']": "<eb10></eb10>",
        }

    @property
    def _max_text_len(self):
        return self.max_text_len + 2

    def __call__(self, data):
        cells = data["cells"]
        structure = data["structure"]
        if self.merge_no_span_structure:
            structure = self._merge_no_span_structure(structure)
        if self.replace_empty_cell_token:
            structure = self._replace_empty_cell_token(structure, cells)
        new_structure = []
        for token in structure:
            if token != "":
                if "span" in token and token[0] != " ":
                    token = " " + token
                new_structure.append(token)
        structure = self.encode(new_structure)
        if structure is None:
            return None
        # auxiliary row/column-count supervision targets (SLAHead
        # aux_count branch): rows = closed <tr>s; cols = column count of
        # the first row, with colspan attributes widening their cell.
        # Emitted unconditionally (scalars are ~free); configs opt in by
        # listing row_cnt/col_cnt in keep_keys.
        rows = new_structure.count("</tr>")
        cols = 0
        for token in new_structure:
            if token == "</tr>":
                break
            if token in self.td_token:
                cols += 1
            elif "colspan" in token:
                try:
                    cols += int(token.split('"')[1]) - 1
                except (IndexError, ValueError):
                    pass
        data["row_cnt"] = np.int32(min(rows, 31))
        data["col_cnt"] = np.int32(min(cols, 31))
        structure = [self.start_idx] + structure + [self.end_idx]
        structure = structure + [self.pad_idx] * (self._max_text_len - len(structure))
        structure = np.array(structure)
        data["structure"] = structure
        if len(structure) > self._max_text_len:
            return None

        bboxes = np.zeros((self._max_text_len, self.loc_reg_num), dtype=np.float32)
        bbox_masks = np.zeros((self._max_text_len, 1), dtype=np.float32)
        bbox_idx = 0
        for i, token in enumerate(structure):
            if self.idx2char[int(token)] in self.td_token:
                if "bbox" in cells[bbox_idx] and len(cells[bbox_idx]["tokens"]) > 0:
                    bbox = np.array(
                        cells[bbox_idx]["bbox"], dtype=np.float32
                    ).reshape(-1)
                    bboxes[i] = bbox
                    bbox_masks[i] = 1.0
                if self.learn_empty_box:
                    bbox_masks[i] = 1.0
                bbox_idx += 1
        data["bboxes"] = bboxes
        data["bbox_masks"] = bbox_masks
        return data

    def encode(self, structure_tokens):
        """Token-list variant of BaseRecLabelEncode.encode: table structure
        labels are lists of tokens, not character strings."""
        if len(structure_tokens) == 0 or len(structure_tokens) > self.max_text_len:
            return None
        out = []
        for token in structure_tokens:
            if token not in self.dict:
                get_logger().warning("{} is not in dict".format(token))
                continue
            out.append(self.dict[token])
        if len(out) == 0:
            return None
        return out

    def _merge_no_span_structure(self, structure):
        new_structure = []
        i = 0
        while i < len(structure):
            token = structure[i]
            if token == "<td>":
                token = "<td></td>"
                i += 1
            new_structure.append(token)
            i += 1
        return new_structure

    def _replace_empty_cell_token(self, token_list, cells):
        bbox_idx = 0
        out = []
        for token in token_list:
            if token in ["<td></td>", "<td", "<td>"]:
                if "bbox" not in cells[bbox_idx]:
                    content = str(cells[bbox_idx]["tokens"])
                    token = self.empty_bbox_token_dict[content]
                out.append(token)
                bbox_idx += 1
            else:
                out.append(token)
        return out


class TableBoxEncode:
    """Normalize table cell bboxes to the resized image. From
    label_ops.py:345."""

    def __init__(self, in_box_format="xyxy", out_box_format="xyxy", **kwargs):
        assert out_box_format in ["xywh", "xyxy", "xyxyxyxy"]
        self.in_box_format = in_box_format
        self.out_box_format = out_box_format

    def __call__(self, data):
        src_h, src_w, ratio_h, ratio_w, dst_h, dst_w = data["shape"]
        bboxes = data["bboxes"]
        if self.in_box_format != self.out_box_format:
            if self.out_box_format == "xywh":
                if self.in_box_format == "xyxyxyxy":
                    bboxes = self.xyxyxyxy2xywh(bboxes)
                elif self.in_box_format == "xyxy":
                    bboxes = self.xyxy2xywh(bboxes)
        bboxes[:, 0::2] *= ratio_w
        bboxes[:, 1::2] *= ratio_h
        bboxes[:, 0::2] /= dst_w
        bboxes[:, 1::2] /= dst_h
        data["bboxes"] = bboxes
        return data

    @staticmethod
    def xyxyxyxy2xywh(bboxes):
        # per-box extent (axis=1), as the JAX package computes it
        new_bboxes = np.zeros([len(bboxes), 4])
        new_bboxes[:, 0] = bboxes[:, 0::2].min(axis=1)
        new_bboxes[:, 1] = bboxes[:, 1::2].min(axis=1)
        new_bboxes[:, 2] = bboxes[:, 0::2].max(axis=1) - new_bboxes[:, 0]
        new_bboxes[:, 3] = bboxes[:, 1::2].max(axis=1) - new_bboxes[:, 1]
        return new_bboxes

    @staticmethod
    def xyxy2xywh(bboxes):
        new_bboxes = np.empty_like(bboxes)
        new_bboxes[:, 0] = (bboxes[:, 0] + bboxes[:, 2]) / 2
        new_bboxes[:, 1] = (bboxes[:, 1] + bboxes[:, 3]) / 2
        new_bboxes[:, 2] = bboxes[:, 2] - bboxes[:, 0]
        new_bboxes[:, 3] = bboxes[:, 3] - bboxes[:, 1]
        return new_bboxes
