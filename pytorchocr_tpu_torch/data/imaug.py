"""The eval ops the deploy entry points run — the port's copy of
DetResizeForTest and KeepKeys (pytorchocr_tpu/data/imaug/operators.py:106,140)
and ClsResizeImg, RecResizeImg with resize_norm_img (rec_img_aug.py:39,48,130).
Host-side numpy and cv2; images stay HWC, as in the JAX package.
"""

import math

import cv2
import numpy as np


class KeepKeys:
    """dict -> ordered list. From operators.py:106."""

    def __init__(self, keep_keys, **kwargs):
        self.keep_keys = keep_keys

    def __call__(self, data):
        return [data[key] for key in self.keep_keys]


class DetResizeForTest:
    """Detection test-time resize. From operators.py:140.

    type1 (`image_shape`): fixed shape; type0 (`limit_side_len` +
    `limit_type` min/max): scale so the min/max side hits the limit, then
    round each side to a multiple of 32; type2 (`resize_long`): long side to
    `resize_long`, rounded up to a multiple of 128. Emits shape = [src_h,
    src_w, ratio_h, ratio_w].
    """

    def __init__(self, **kwargs):
        self.resize_type = 0
        if "image_shape" in kwargs:
            self.image_shape = kwargs["image_shape"]
            self.resize_type = 1
        elif "limit_side_len" in kwargs:
            self.limit_side_len = kwargs["limit_side_len"]
            self.limit_type = kwargs.get("limit_type", "min")
        elif "resize_long" in kwargs:
            self.resize_type = 2
            self.resize_long = kwargs.get("resize_long", 960)
        else:
            self.limit_side_len = 736
            self.limit_type = "min"

    def __call__(self, data):
        img = data["image"]
        src_h, src_w = img.shape[:2]
        if self.resize_type == 0:
            img, (ratio_h, ratio_w) = self.resize_image_type0(img)
        elif self.resize_type == 2:
            img, (ratio_h, ratio_w) = self.resize_image_type2(img)
        else:
            img, (ratio_h, ratio_w) = self.resize_image_type1(img)
        data["image"] = img
        data["shape"] = np.array([src_h, src_w, ratio_h, ratio_w])
        return data

    def resize_image_type1(self, img):
        resize_h, resize_w = self.image_shape
        ori_h, ori_w = img.shape[:2]
        ratio_h = float(resize_h) / ori_h
        ratio_w = float(resize_w) / ori_w
        img = cv2.resize(img, (int(resize_w), int(resize_h)))
        return img, (ratio_h, ratio_w)

    def resize_image_type0(self, img):
        limit_side_len = self.limit_side_len
        h, w = img.shape[:2]
        if self.limit_type in ("max", "resize_long"):
            ratio = float(limit_side_len) / max(h, w)
        elif self.limit_type == "min":
            ratio = float(limit_side_len) / min(h, w)
        else:
            raise ValueError("not supported limit type: %s" % self.limit_type)
        resize_h = int(h * ratio)
        resize_w = int(w * ratio)
        resize_h = max(int(round(resize_h / 32) * 32), 32)
        resize_w = max(int(round(resize_w / 32) * 32), 32)
        img = cv2.resize(img, (int(resize_w), int(resize_h)))
        ratio_h = resize_h / float(h)
        ratio_w = resize_w / float(w)
        return img, (ratio_h, ratio_w)

    def resize_image_type2(self, img):
        h, w = img.shape[:2]
        ratio = float(self.resize_long) / max(h, w)
        resize_h = int(h * ratio)
        resize_w = int(w * ratio)
        max_stride = 128
        resize_h = (resize_h + max_stride - 1) // max_stride * max_stride
        resize_w = (resize_w + max_stride - 1) // max_stride * max_stride
        img = cv2.resize(img, (int(resize_w), int(resize_h)))
        ratio_h = resize_h / float(h)
        ratio_w = resize_w / float(w)
        return img, (ratio_h, ratio_w)


class ClsResizeImg:
    """From rec_img_aug.py:39."""

    def __init__(self, image_shape, **kwargs):
        self.image_shape = image_shape

    def __call__(self, data):
        data["image"] = resize_norm_img(data["image"], self.image_shape)
        return data


class RecResizeImg:
    """From rec_img_aug.py:48."""

    def __init__(self, image_shape, padding=True, **kwargs):
        self.image_shape = image_shape
        self.padding = padding

    def __call__(self, data):
        data["image"] = resize_norm_img(
            data["image"], self.image_shape, resized_w=None, padding=self.padding
        )
        return data


def resize_norm_img(img, image_shape, resized_w=None, padding=True):
    """Aspect-preserving height resize + right-pad, /255 - 0.5 / 0.5
    normalisation. Returns HWC float32. From rec_img_aug.py:130."""
    imgC, imgH, imgW = image_shape
    h, w = img.shape[:2]
    if not padding:
        resized_image = cv2.resize(img, (imgW, imgH))
        resized_w = imgW
    elif resized_w is not None:
        resized_image = cv2.resize(img, (resized_w, imgH))
    else:
        ratio = w / float(h)
        if math.ceil(imgH * ratio) > imgW:
            resized_w = imgW
        else:
            resized_w = int(math.ceil(imgH * ratio))
        resized_image = cv2.resize(img, (resized_w, imgH))
    resized_image = resized_image.astype("float32")
    if resized_image.ndim == 2:  # gray input -> H W 1
        resized_image = resized_image[:, :, np.newaxis]
    resized_image = resized_image / 255.0
    resized_image -= 0.5
    resized_image /= 0.5
    padding_im = np.zeros((imgH, imgW, imgC), dtype=np.float32)
    padding_im[:, 0:resized_w, :] = resized_image[:, :, :imgC]
    return padding_im
