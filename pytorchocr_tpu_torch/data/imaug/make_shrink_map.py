"""DB shrink-map GT generation — the port's copy of
pytorchocr_tpu/data/imaug/make_shrink_map.py:17.

pyclipper-free: the shrunk region is rasterized directly as a distance-
transform threshold (exact Minkowski erosion by a disk of the shrink
distance — what the reference's JT_ROUND negative offset approximates).
Escalating shrink ratios on failure are kept (reference :50-62).
"""

import cv2
import numpy as np

from ...utils import geometry

__all__ = ["MakeShrinkMap"]


class MakeShrinkMap:
    def __init__(self, min_text_size=8, shrink_ratio=0.4, **kwargs):
        self.min_text_size = min_text_size
        self.shrink_ratio = shrink_ratio

    def __call__(self, data):
        image = data["image"]
        text_polys = data["polys"]
        ignore_tags = data["ignore_tags"]

        h, w = image.shape[:2]
        text_polys, ignore_tags = self.validate_polygons(text_polys, ignore_tags, h, w)
        gt = np.zeros((h, w), dtype=np.float32)
        mask = np.ones((h, w), dtype=np.float32)
        for i in range(len(text_polys)):
            polygon = text_polys[i]
            height = max(polygon[:, 1]) - min(polygon[:, 1])
            width = max(polygon[:, 0]) - min(polygon[:, 0])
            if ignore_tags[i] or min(height, width) < self.min_text_size:
                cv2.fillPoly(mask, polygon.astype(np.int32)[np.newaxis, :, :], 0)
                ignore_tags[i] = True
            else:
                # escalate the ratio if the polygon erodes away entirely
                ok = False
                for ratio in np.arange(self.shrink_ratio, 1, self.shrink_ratio):
                    distance = geometry.shrink_distance(polygon, ratio)
                    if geometry.rasterize_shrunk_polygon(gt, polygon, distance, 1):
                        ok = True
                        break
                if not ok:
                    cv2.fillPoly(
                        mask, polygon.astype(np.int32)[np.newaxis, :, :], 0
                    )
                    ignore_tags[i] = True
                    continue

        data["shrink_map"] = gt
        data["shrink_mask"] = mask
        data["ignore_tags"] = ignore_tags
        return data

    def validate_polygons(self, polygons, ignore_tags, h, w):
        if len(polygons) == 0:
            return polygons, ignore_tags
        assert len(polygons) == len(ignore_tags)
        for polygon in polygons:
            polygon[:, 0] = np.clip(polygon[:, 0], 0, w - 1)
            polygon[:, 1] = np.clip(polygon[:, 1], 0, h - 1)
        for i in range(len(polygons)):
            area = geometry.polygon_area(polygons[i])
            if abs(area) < 1:
                ignore_tags[i] = True
            if area > 0:
                polygons[i] = polygons[i][::-1, :]
        return polygons, ignore_tags
