"""Fused det augmentation + text-avoiding crop in ONE image resample — the
port's copy of pytorchocr_tpu/data/imaug/fused_aug_crop.py:42. It draws from
`random` (flip, angle, scale) and then np.random (the crop) in the JAX op's
order, so a seeded sample equals the JAX one.

IaaAugment (flip -> rotate-warp -> scale-resize) followed by
EastRandomCropData (crop + resize-pad) resamples a page up to four times,
at up to 3x scale, mostly to crop it away. This op samples the SAME
augmentation parameters, transforms only the polygon keypoints through the
composed affine, runs the text-avoiding crop selection on the virtual
augmented geometry, and applies ONE composed cv2.warpAffine straight to the
final crop-size canvas. Output semantics match the 2-op chain up to
resampling quality (one bilinear pass instead of three); the polygon math
is identical.

Config (drop-in replacement for the [IaaAugment, EastRandomCropData]
pair in a Train transform list):

    - FusedDetAugCrop:
        flip_p: 0.5
        rotate: [-10, 10]
        scale: [0.5, 3]
        size: [640, 640]
        max_tries: 50
        min_crop_side_ratio: 0.1
        keep_ratio: True
"""

import random

import cv2
import numpy as np

from .random_crop_data import crop_area, is_poly_outside_rect

__all__ = ["FusedDetAugCrop"]


class FusedDetAugCrop:
    def __init__(
        self,
        flip_p=0.5,
        rotate=(-10, 10),
        scale=(0.5, 3),
        size=(640, 640),
        max_tries=10,
        min_crop_side_ratio=0.1,
        keep_ratio=True,
        **kwargs
    ):
        self.flip_p = flip_p
        self.rotate = tuple(rotate)
        self.scale = tuple(scale)
        self.size = tuple(size)
        self.max_tries = max_tries
        self.min_crop_side_ratio = min_crop_side_ratio
        self.keep_ratio = keep_ratio

    @staticmethod
    def _compose(a, b):
        """2x3 affine compose: (a o b)(x) = a(b(x))."""
        a3 = np.vstack([a, [0.0, 0.0, 1.0]])
        b3 = np.vstack([b, [0.0, 0.0, 1.0]])
        return (a3 @ b3)[:2]

    def sample_augment(self, h, w):
        """Sample flip/rotate/scale; return (M_aug 2x3, aug_w, aug_h).
        Matches IaaAugment's parameter distributions and its effective
        point maps (iaa_augment.py): flip x->w-x, rotate about the
        canvas center with same-size canvas, scale by the rounded-dim
        effective ratios."""
        M = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        if random.random() < self.flip_p:
            M = self._compose(np.array([[-1.0, 0.0, float(w)], [0.0, 1.0, 0.0]]), M)
        angle = random.uniform(*self.rotate)
        M = self._compose(
            cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0), M
        )
        s = random.uniform(*self.scale)
        aug_w = max(int(round(w * s)), 1)
        aug_h = max(int(round(h * s)), 1)
        M = self._compose(
            np.array([[aug_w / float(w), 0.0, 0.0], [0.0, aug_h / float(h), 0.0]]),
            M,
        )
        return M, aug_w, aug_h

    def __call__(self, data):
        img = data["image"]
        text_polys = data["polys"]
        ignore_tags = data["ignore_tags"]
        texts = data["texts"]
        h, w = img.shape[:2]

        M_aug, aug_w, aug_h = self.sample_augment(h, w)

        def apply_pts(M, pts):
            ones = np.ones((len(pts), 1), dtype=np.float64)
            return (np.hstack([pts, ones]) @ M.T).astype(np.float32)

        polys_aug = [
            apply_pts(M_aug, np.asarray(p, dtype=np.float64)) for p in text_polys
        ]

        all_care_polys = [
            polys_aug[i] for i, tag in enumerate(ignore_tags) if not tag
        ]
        crop_x, crop_y, crop_w, crop_h = crop_area(
            np.empty((aug_h, aug_w, 0)), all_care_polys,
            self.min_crop_side_ratio, self.max_tries,
        )
        scale_w = self.size[0] / crop_w
        scale_h = self.size[1] / crop_h
        scale = min(scale_w, scale_h)
        out_h = int(crop_h * scale)
        out_w = int(crop_w * scale)

        # final = scale o translate(-crop) o M_aug, rendered once; the
        # dsize canvas zero-pads beyond (out_w, out_h) exactly like the
        # 2-op chain's padimg
        M_final = self._compose(
            np.array([[scale, 0.0, -crop_x * scale], [0.0, scale, -crop_y * scale]]),
            M_aug,
        )
        if self.keep_ratio:
            dsize = (self.size[0], self.size[1])
        else:
            # stretch to the full target (reference keep_ratio=False path)
            M_final = self._compose(
                np.array(
                    [
                        [self.size[0] / float(out_w or 1), 0.0, 0.0],
                        [0.0, self.size[1] / float(out_h or 1), 0.0],
                    ]
                ),
                M_final,
            )
            out_w, out_h = self.size
            dsize = (self.size[0], self.size[1])
        img = cv2.warpAffine(img, M_final, dsize, flags=cv2.INTER_LINEAR)

        text_polys_crop = []
        ignore_tags_crop = []
        texts_crop = []
        for poly, text, tag in zip(polys_aug, texts, ignore_tags):
            poly = ((np.array(poly) - (crop_x, crop_y)) * scale).tolist()
            if not is_poly_outside_rect(poly, 0, 0, out_w, out_h):
                text_polys_crop.append(poly)
                ignore_tags_crop.append(tag)
                texts_crop.append(text)
        data["image"] = img
        data["polys"] = np.array(text_polys_crop)
        data["ignore_tags"] = ignore_tags_crop
        data["texts"] = texts_crop
        return data
