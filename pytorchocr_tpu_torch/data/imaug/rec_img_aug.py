"""Rec and cls image ops — the port's copy of RecAug, ClsResizeImg,
RecResizeImg, resize_norm_img and the per-sample augmentation `warp` with
its helpers (pytorchocr_tpu/data/imaug/rec_img_aug.py:17,39,48,130,163-233).
Host-side numpy and cv2; images stay HWC, as in the JAX package. The
augmentations draw from `random` and `np.random` in the JAX order, so one
seed gives the JAX package's images.
"""

import math
import random

import cv2
import numpy as np

from .text_image_aug import tia_distort, tia_perspective, tia_stretch


class RecAug:
    """Text-line augmentation: TIA warps, crop, blur, HSV jitter, pixel
    jitter, gaussian noise, invert, each with probability `aug_prob`. A gray
    image goes through RGB and back. From rec_img_aug.py:17."""

    def __init__(self, use_tia=True, aug_prob=0.4, **kwargs):
        self.use_tia = use_tia
        self.aug_prob = aug_prob

    def __call__(self, data):
        img = data["image"]
        gray_mode = False
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
            gray_mode = True
        img = warp(img, 10, self.use_tia, self.aug_prob)
        if gray_mode:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        data["image"] = img
        return data


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


def flag():
    return 1 if random.random() > 0.5000001 else -1


def cvt_color(img):
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    delta = 0.001 * random.random() * flag()
    hsv[:, :, 2] = hsv[:, :, 2] * (1 + delta)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def blur(img):
    h, w = img.shape[:2]
    if h > 10 and w > 10:
        return cv2.GaussianBlur(img, (5, 5), 1)
    return img


def jitter(img):
    w, h = img.shape[:2]
    if h > 10 and w > 10:
        thres = min(w, h)
        s = int(random.random() * thres * 0.01)
        src_img = img.copy()
        for i in range(s):
            img[i:, i:, :] = src_img[: w - i, : h - i, :]
        return img
    return img


def add_gasuss_noise(image, mean=0, var=0.1):
    noise = np.random.normal(mean, var ** 0.5, image.shape)
    out = np.clip(image + 0.5 * noise, 0, 255)
    return np.uint8(out)


def get_crop(image):
    h = image.shape[0]
    top_crop = min(int(random.randint(1, 8)), h - 1)
    crop_img = image.copy()
    if random.randint(0, 1):
        crop_img = crop_img[top_crop:h, :, :]
    else:
        crop_img = crop_img[0 : h - top_crop, :, :]
    return crop_img


def warp(img, ang, use_tia=True, prob=0.4):
    """The per-sample augmentation: each op with probability `prob`, in the
    JAX order. From rec_img_aug.py:210."""
    h, w = img.shape[:2]
    new_img = img

    if use_tia:
        if random.random() <= prob and h >= 20 and w >= 20:
            new_img = tia_distort(new_img, random.randint(3, 6))
        if random.random() <= prob and h >= 20 and w >= 20:
            new_img = tia_stretch(new_img, random.randint(3, 6))
        if random.random() <= prob:
            new_img = tia_perspective(new_img)

    if random.random() <= prob and h >= 20 and w >= 20:
        new_img = get_crop(new_img)
    if random.random() <= prob:
        new_img = blur(new_img)
    if img.ndim == 3 and img.shape[2] == 3 and random.random() <= prob:
        new_img = cvt_color(new_img)
    new_img = jitter(new_img)
    if random.random() <= prob:
        new_img = add_gasuss_noise(new_img)
    if random.random() <= prob:
        new_img = 255 - new_img
    return new_img
