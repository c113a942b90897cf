"""PSE GT: progressively shrunk kernels — the port's copy of
pytorchocr_tpu/data/imaug/make_pse_gt.py, on the port's utils/geometry.py.

A page whose short edge is under `size` is scaled up to it first. Each
polygon's interior distance field (one fillPoly + distanceTransform) serves
all `kernel_num` shrink rates: kernel i keeps the pixels at least
A (1 - r_i^2) / L from the boundary. A polygon whose field is empty or
whose kernel vanishes becomes ignored, and ignored polygons are cut out of
the training mask. Out: gt_text (the largest kernel), gt_kernels (the other
kernel_num - 1, float32 0/1), mask (float32).
"""

import cv2
import numpy as np

from ...utils import geometry

__all__ = ["MakePseGt"]


class MakePseGt:
    def __init__(self, kernel_num=7, size=640, min_shrink_ratio=0.4, **kwargs):
        self.kernel_num = kernel_num
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

        fields = [geometry.polygon_distance_field(poly, image.shape[0:2]) for poly in text_polys]
        areas = [abs(geometry.polygon_area(p)) for p in text_polys]
        perims = [geometry.polygon_perimeter(p) for p in text_polys]

        gt_kernels = []
        for i in range(self.kernel_num):
            rate = 1.0 - (1.0 - self.min_shrink_ratio) / (self.kernel_num - 1) * i
            text_kernel = np.zeros(image.shape[0:2], dtype=np.int32)
            for j, field in enumerate(fields):
                if field is None:
                    if ignore_tags is not None:
                        ignore_tags[j] = True
                    continue
                distance = areas[j] * (1 - rate * rate) / (perims[j] + 1e-6)
                x0, y0, dist = field
                shrunk = dist >= distance if distance > 0 else dist > 0
                if not shrunk.any():
                    if ignore_tags is not None:
                        ignore_tags[j] = True
                    continue
                region = text_kernel[y0 : y0 + dist.shape[0], x0 : x0 + dist.shape[1]]
                region[shrunk] = j + 1
            gt_kernels.append(text_kernel)

        training_mask = np.ones(image.shape[0:2], dtype="uint8")
        for i in range(text_polys.shape[0]):
            if ignore_tags[i]:
                cv2.fillPoly(training_mask, text_polys[i].astype(np.int32)[np.newaxis, :, :], 0)
        gt_kernels = np.array(gt_kernels, dtype=np.float32)
        gt_kernels[gt_kernels > 0] = 1

        data["image"] = image
        data["polys"] = text_polys
        data["gt_text"] = gt_kernels[0]
        data["gt_kernels"] = gt_kernels[1:]
        data["mask"] = training_mask.astype("float32")
        return data

    @staticmethod
    def generate_kernel(img_size, shrink_ratio, text_polys, ignore_tags=None):
        """One kernel map at one shrink rate, polygon i filled with i + 1; a
        polygon whose kernel vanishes becomes ignored."""
        h, w = img_size
        text_kernel = np.zeros((h, w), dtype=np.int32)
        for i, poly in enumerate(text_polys):
            area = abs(geometry.polygon_area(poly))
            perim = geometry.polygon_perimeter(poly)
            distance = area * (1 - shrink_ratio * shrink_ratio) / (perim + 1e-6)
            ok = geometry.rasterize_shrunk_polygon(text_kernel, poly, distance, i + 1)
            if not ok and ignore_tags is not None:
                ignore_tags[i] = True
        return text_kernel, ignore_tags
