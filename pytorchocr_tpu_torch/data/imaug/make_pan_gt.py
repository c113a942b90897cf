"""PAN GT — the port's copy of pytorchocr_tpu/data/imaug/make_pan_gt.py: the
text map (shrink rate 1) and the kernel map (`min_shrink_ratio`) by
MakePseGt.generate_kernel, the instance map (polygon i filled with i + 1,
int32, later polygons over earlier ones) and the training mask (ignored
polygons cut out). A page whose short edge is under `size` is scaled up to
it first.
"""

import cv2
import numpy as np

from .make_pse_gt import MakePseGt

__all__ = ["MakePanGt"]


class MakePanGt:
    def __init__(self, size=640, min_shrink_ratio=0.5, **kwargs):
        self.min_shrink_ratio = min_shrink_ratio
        self.size = size

    def __call__(self, data):
        image = data["image"]
        text_polys = data["polys"]
        ignore_tags = data["ignore_tags"]

        h, w = image.shape[:2]
        short_edge = min(h, w)
        if short_edge < self.size:
            scale = self.size / short_edge
            image = cv2.resize(image, dsize=None, fx=scale, fy=scale)
            text_polys = text_polys * scale

        gt_kernels = []
        for rate in [1.0, self.min_shrink_ratio]:  # text + kernel
            text_kernel, ignore_tags = MakePseGt.generate_kernel(
                image.shape[0:2], rate, text_polys, ignore_tags)
            gt_kernels.append(text_kernel)

        gt_instance = np.zeros(image.shape[0:2], dtype=np.int32)
        training_mask = np.ones(image.shape[0:2], dtype=np.uint8)
        for i in range(text_polys.shape[0]):
            cv2.fillPoly(gt_instance, text_polys[i].astype(np.int32)[np.newaxis, :, :], i + 1)
            if ignore_tags[i]:
                cv2.fillPoly(training_mask, text_polys[i].astype(np.int32)[np.newaxis, :, :], 0)

        gt_kernels = np.array(gt_kernels, dtype=np.float32)
        gt_kernels[gt_kernels > 0] = 1

        data["image"] = image
        data["polys"] = text_polys
        data["gt_text"] = gt_kernels[0]
        data["gt_kernels"] = gt_kernels[1]
        data["gt_instance"] = gt_instance
        data["mask"] = training_mask.astype(np.float32)
        return data
