"""Detection augmentation: flip / rotate / scale on image + keypoint polys —
the port's copy of pytorchocr_tpu/data/imaug/iaa_augment.py, which replaces
imgaug with direct cv2 affine transforms. The parameters are drawn from
Python's `random` in the JAX op's order.  Supports the three augmenters every
reference config uses — Fliplr(p), Affine(rotate=[lo,hi]), Resize(size=[lo,hi])
— applied sequentially with a shared transform applied to both the image and
the polygons.
"""

import random

import cv2
import numpy as np


class _Fliplr:
    def __init__(self, p=0.5, **kwargs):
        self.p = p

    def sample(self, h, w):
        return {"flip": random.random() < self.p}

    def apply_image(self, img, params):
        return img[:, ::-1].copy() if params["flip"] else img

    def apply_points(self, pts, h, w, params):
        if params["flip"]:
            pts = pts.copy()
            pts[:, 0] = w - pts[:, 0]
        return pts


class _Affine:
    def __init__(self, rotate=(-10, 10), **kwargs):
        self.rotate = rotate

    def sample(self, h, w):
        lo, hi = self.rotate
        return {"angle": random.uniform(lo, hi)}

    def apply_image(self, img, params):
        h, w = img.shape[:2]
        M = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), params["angle"], 1.0)
        params["M"] = M
        return cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)

    def apply_points(self, pts, h, w, params):
        M = params["M"]
        ones = np.ones((len(pts), 1), dtype=np.float64)
        return (np.hstack([pts, ones]) @ M.T).astype(np.float32)


class _Resize:
    def __init__(self, size=(0.5, 3), **kwargs):
        self.size = size

    def sample(self, h, w):
        lo, hi = self.size
        return {"scale": random.uniform(lo, hi)}

    def apply_image(self, img, params):
        h, w = img.shape[:2]
        s = params["scale"]
        return cv2.resize(img, (max(int(round(w * s)), 1), max(int(round(h * s)), 1)))

    def apply_points(self, pts, h, w, params):
        # cv2.resize target dims were rounded; use the effective ratios
        s = params["scale"]
        new_w = max(int(round(w * s)), 1)
        new_h = max(int(round(h * s)), 1)
        pts = pts.copy()
        pts[:, 0] *= new_w / float(w)
        pts[:, 1] *= new_h / float(h)
        return pts


_SUPPORTED = {"Fliplr": _Fliplr, "Affine": _Affine, "Resize": _Resize}


class IaaAugment:
    def __init__(self, augmenter_args=None, **kwargs):
        if augmenter_args is None:
            augmenter_args = [
                {"type": "Fliplr", "args": {"p": 0.5}},
                {"type": "Affine", "args": {"rotate": [-10, 10]}},
                {"type": "Resize", "args": {"size": [0.5, 3]}},
            ]
        self.augmenters = []
        for arg in augmenter_args:
            if arg is None:
                continue
            cls = _SUPPORTED.get(arg["type"])
            if cls is None:
                raise ValueError(
                    "IaaAugment supports %s, got %s" % (list(_SUPPORTED), arg["type"])
                )
            self.augmenters.append(cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in arg.get("args", {}).items()}))

    def __call__(self, data):
        img = data["image"]
        polys = data.get("polys")
        for aug in self.augmenters:
            h, w = img.shape[:2]
            params = aug.sample(h, w)
            img = aug.apply_image(img, params)
            if polys is not None and len(polys):
                shape = polys.shape
                flat = polys.reshape(-1, 2).astype(np.float32)
                flat = aug.apply_points(flat, h, w, params)
                polys = np.asarray(flat, dtype=np.float32).reshape(shape)
        data["image"] = img
        if polys is not None:
            data["polys"] = polys
        return data
