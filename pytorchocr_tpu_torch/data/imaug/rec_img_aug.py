"""Rec and cls eval resizes — the port's copy of ClsResizeImg, RecResizeImg and
resize_norm_img (pytorchocr_tpu/data/imaug/rec_img_aug.py:39,48,130).
Host-side numpy and cv2; images stay HWC, as in the JAX package.
"""

import math

import cv2
import numpy as np


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
