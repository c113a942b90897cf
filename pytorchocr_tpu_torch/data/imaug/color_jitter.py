"""ColorJitter — the port's copy of pytorchocr_tpu/data/imaug/color_jitter.py
(PIL, no torchvision): brightness / contrast / saturation factors drawn from
[max(0, 1 - v), 1 + v], a hue shift from [-v, v], applied in a shuffled
order by PIL's ImageEnhance. It draws from `random` in the JAX op's order
(the four factors, then the shuffle), so a seeded sample equals the JAX one.
"""

import random

import numpy as np
from PIL import Image, ImageEnhance

__all__ = ["ColorJitter"]


def _sample_factor(v):
    if v is None or v == 0:
        return None
    if isinstance(v, (list, tuple)):
        lo, hi = v
    else:
        lo, hi = max(0.0, 1.0 - v), 1.0 + v
    return random.uniform(lo, hi)


def _sample_hue(v):
    if v is None or v == 0:
        return None
    if isinstance(v, (list, tuple)):
        lo, hi = v
    else:
        lo, hi = -v, v
    return random.uniform(lo, hi)


def _adjust_hue(img, hue_factor):
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    np_h = (np_h.astype(np.int16) + int(hue_factor * 255)) % 256
    h = Image.fromarray(np_h.astype(np.uint8), "L")
    return Image.merge("HSV", (h, s, v)).convert(img.mode)


class ColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, **kwargs):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, data):
        img = data["image"]
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        assert isinstance(img, Image.Image), "'img' should be PIL.Image"

        ops = []
        b = _sample_factor(self.brightness)
        if b is not None:
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(b))
        c = _sample_factor(self.contrast)
        if c is not None:
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(c))
        s = _sample_factor(self.saturation)
        if s is not None:
            ops.append(lambda im: ImageEnhance.Color(im).enhance(s))
        hshift = _sample_hue(self.hue)
        if hshift is not None:
            ops.append(lambda im: _adjust_hue(im, hshift))
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        data["image"] = np.asarray(img)
        return data
