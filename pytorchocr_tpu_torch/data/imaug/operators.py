"""Core image operators — the port's copy of DecodeImage, ToTensor, Normalize,
NormalizeImage, KeepKeys and DetResizeForTest
(pytorchocr_tpu/data/imaug/operators.py:16,43,61,77,106,140). Host-side
numpy and cv2; images stay HWC, as in the JAX package: ToTensor scales to
[0, 1] float32 HWC and Normalize works on the last axis.

ToTensor divides by 255 as the JAX host op and the JAX training transform do
(operators.py:55, trainer.py:81); only the deploy `Runner` multiplies by
float32(1/255), as the JAX JitRunner does (deploy/common.py:104-108).
"""

import cv2
import numpy as np


class DecodeImage:
    """bytes -> cv2 decode -> RGB / GRAY. From operators.py:16."""

    def __init__(self, img_mode="RGB", channel_first=False, **kwargs):
        self.img_mode = img_mode
        self.channel_first = channel_first

    def __call__(self, data):
        img = data["image"]
        if not (isinstance(img, bytes) and len(img) > 0):
            raise ValueError("invalid input 'img' in DecodeImage")
        img = cv2.imdecode(np.frombuffer(img, dtype="uint8"), cv2.IMREAD_COLOR)
        if img is None:
            return None
        if img.shape[2] != 3:
            raise ValueError("invalid shape of image[%s]" % (img.shape,))
        if self.img_mode == "GRAY":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)  # H x W
        elif self.img_mode == "RGB":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self.channel_first:
            img = img.transpose((2, 0, 1))
        data["image"] = img
        return data


class ToTensor:
    """HWC uint8 [0, 255] -> HWC float32 [0, 1]. From operators.py:43."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data):
        img = data["image"]
        if img.ndim == 2:
            img = img[:, :, None]
        data["image"] = img.astype(np.float32) / 255.0
        return data


class Normalize:
    """(x - mean) / std per channel on HWC float images. From operators.py:61."""

    def __init__(self, mean, std, **kwargs):
        self.mean = np.array(mean, dtype=np.float32).reshape(1, 1, -1)
        self.std = np.array(std, dtype=np.float32).reshape(1, 1, -1)

    def __call__(self, data):
        img = data["image"]
        if img.ndim == 2:
            img = img[:, :, None]
        data["image"] = (img.astype(np.float32) - self.mean) / self.std
        return data


class NormalizeImage:
    """Scale, then (x - mean) / std. From operators.py:77."""

    def __init__(self, scale=1.0 / 255.0, mean=None, std=None, order="hwc", **kwargs):
        self.scale = eval(scale) if isinstance(scale, str) else scale
        mean = mean if mean is not None else [0.485, 0.456, 0.406]
        std = std if std is not None else [0.229, 0.224, 0.225]
        self.mean = np.array(mean, dtype=np.float32).reshape(1, 1, -1)
        self.std = np.array(std, dtype=np.float32).reshape(1, 1, -1)

    def __call__(self, data):
        img = data["image"]
        if img.ndim == 2:
            img = img[:, :, None]
        data["image"] = (img.astype(np.float32) * self.scale - self.mean) / self.std
        return data


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
