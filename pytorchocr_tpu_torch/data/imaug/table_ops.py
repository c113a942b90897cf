"""Table image ops — the port's copy of pytorchocr_tpu/data/imaug/table_ops.py
(ResizeTableImage :7, PaddingTableImage :37)."""

import cv2
import numpy as np


class ResizeTableImage:
    """Long-side resize to a /32 multiple, optional square padding; emits
    shape = [src_h, src_w, ratio, ratio, dst_h, dst_w]."""

    def __init__(self, max_len, use_padding=False, **kwargs):
        self.max_len = max(int(round(max_len / 32) * 32), 32)
        self.use_padding = use_padding

    def __call__(self, data):
        img = data["image"]
        src_h, src_w = img.shape[:2]
        ratio = self.max_len / (max(src_h, src_w) * 1.0)
        resize_h = max(int(round(src_h * ratio / 32) * 32), 32)
        resize_w = max(int(round(src_w * ratio / 32) * 32), 32)
        resize_img = cv2.resize(img, (resize_w, resize_h))
        data["image"] = resize_img
        data["shape"] = np.array([src_h, src_w, ratio, ratio, resize_h, resize_w])
        if self.use_padding:
            max_resize_len = max(resize_h, resize_w)
            padding_img = np.zeros(
                (max_resize_len, max_resize_len, 3), dtype=resize_img.dtype
            )
            padding_img[0:resize_h, 0:resize_w, :] = resize_img
            data["image"] = padding_img
            data["shape"] = np.array(
                [src_h, src_w, ratio, ratio, max_resize_len, max_resize_len]
            )
        return data


class PaddingTableImage:
    """Pad to a fixed square size (companion op used by some table configs)."""

    def __init__(self, size, **kwargs):
        self.size = size

    def __call__(self, data):
        img = data["image"]
        pad_h, pad_w = self.size
        padding_img = np.zeros((pad_h, pad_w, 3), dtype=np.float32)
        h, w = img.shape[:2]
        padding_img[0:h, 0:w, :] = img.astype(np.float32)
        data["image"] = padding_img
        shape = data["shape"].tolist()
        shape[4], shape[5] = pad_h, pad_w
        data["shape"] = np.array(shape)
        return data
