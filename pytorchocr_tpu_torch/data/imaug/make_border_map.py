"""DB threshold/border-map GT generation — the port's copy of
pytorchocr_tpu/data/imaug/make_border_map.py:21. The native path is the
port's copy of the C++ library (`native.py`, `csrc/geometry_kernels.cpp`);
the numpy path stays for hosts without g++.

pyclipper-free: the dilated ("padded") polygon used for the mask is the true
disk dilation — a pixel is in the band iff it is inside the polygon or its
min distance to any polygon edge is <= the offset distance (the reference's
JT_ROUND positive offset approximates exactly this).  The per-edge distance
field and the [thresh_min, thresh_max] scaling match the reference.
"""

import cv2
import numpy as np

from ... import native
from ...utils import geometry

__all__ = ["MakeBorderMap"]

np.seterr(divide="ignore", invalid="ignore")


class MakeBorderMap:
    def __init__(self, shrink_ratio=0.4, thresh_min=0.3, thresh_max=0.7, **kwargs):
        self.shrink_ratio = shrink_ratio
        self.thresh_min = thresh_min
        self.thresh_max = thresh_max

    def __call__(self, data):
        img = data["image"]
        text_polys = data["polys"]
        ignore_tags = data["ignore_tags"]

        canvas = np.zeros(img.shape[:2], dtype=np.float32)
        mask = np.zeros(img.shape[:2], dtype=np.float32)

        if native.native_available() and len(text_polys):
            # one C call per distinct point count (polys may be ragged) —
            # this is the det-GT host hot spot (~53 ms/sample in numpy vs
            # ~1 ms native at 640x640)
            by_npts = {}
            for poly, ig in zip(text_polys, ignore_tags):
                poly = np.asarray(poly, dtype=np.float32)
                by_npts.setdefault(len(poly), ([], []))
                by_npts[len(poly)][0].append(poly)
                by_npts[len(poly)][1].append(bool(ig))
            for polys, igs in by_npts.values():
                native.make_border_map(
                    np.stack(polys), igs, self.shrink_ratio, canvas, mask
                )
        else:
            for i in range(len(text_polys)):
                if ignore_tags[i]:
                    continue
                self.draw_border_map(text_polys[i], canvas, mask=mask)
        canvas = canvas * (self.thresh_max - self.thresh_min) + self.thresh_min

        data["threshold_map"] = canvas
        data["threshold_mask"] = mask
        return data

    def draw_border_map(self, polygon, canvas, mask):
        polygon = np.array(polygon, dtype=np.float64)
        assert polygon.ndim == 2 and polygon.shape[1] == 2

        area = abs(geometry.polygon_area(polygon))
        if area <= 0:
            return
        distance = (
            area
            * (1 - np.power(self.shrink_ratio, 2))
            / geometry.polygon_perimeter(polygon)
        )
        pad = int(np.ceil(distance)) + 1
        xmin = int(np.floor(polygon[:, 0].min())) - pad
        xmax = int(np.ceil(polygon[:, 0].max())) + pad
        ymin = int(np.floor(polygon[:, 1].min())) - pad
        ymax = int(np.ceil(polygon[:, 1].max())) + pad
        width = xmax - xmin + 1
        height = ymax - ymin + 1

        polygon = polygon.copy()
        polygon[:, 0] -= xmin
        polygon[:, 1] -= ymin

        xs = np.broadcast_to(
            np.linspace(0, width - 1, num=width).reshape(1, width), (height, width)
        )
        ys = np.broadcast_to(
            np.linspace(0, height - 1, num=height).reshape(height, 1), (height, width)
        )

        distance_map = np.zeros((polygon.shape[0], height, width), dtype=np.float32)
        abs_dist_min = np.full((height, width), np.inf, dtype=np.float64)
        for i in range(polygon.shape[0]):
            j = (i + 1) % polygon.shape[0]
            absolute_distance = self._distance(xs, ys, polygon[i], polygon[j])
            abs_dist_min = np.minimum(abs_dist_min, absolute_distance)
            distance_map[i] = np.clip(absolute_distance / distance, 0, 1)
        distance_map = distance_map.min(axis=0)

        # dilated-polygon mask: inside OR within `distance` of the boundary
        inside = np.zeros((height, width), dtype=np.uint8)
        cv2.fillPoly(inside, [np.round(polygon).astype(np.int32)], 1)
        band = np.logical_or(inside > 0, abs_dist_min <= distance)

        xmin_valid = min(max(0, xmin), canvas.shape[1] - 1)
        xmax_valid = min(max(0, xmax), canvas.shape[1] - 1)
        ymin_valid = min(max(0, ymin), canvas.shape[0] - 1)
        ymax_valid = min(max(0, ymax), canvas.shape[0] - 1)

        band_roi = band[
            ymin_valid - ymin : ymax_valid - ymax + height,
            xmin_valid - xmin : xmax_valid - xmax + width,
        ]
        mask_roi = mask[ymin_valid : ymax_valid + 1, xmin_valid : xmax_valid + 1]
        mask_roi[band_roi] = 1.0

        dist_roi = distance_map[
            ymin_valid - ymin : ymax_valid - ymax + height,
            xmin_valid - xmin : xmax_valid - xmax + width,
        ]
        canvas_roi = canvas[ymin_valid : ymax_valid + 1, xmin_valid : xmax_valid + 1]
        np.fmax(1 - dist_roi, canvas_roi, out=canvas_roi, where=band_roi)

    @staticmethod
    def _distance(xs, ys, point_1, point_2):
        """Distance from each (xs, ys) grid point to segment point_1-point_2
        (same construction as the reference's law-of-cosines variant)."""
        square_distance_1 = np.square(xs - point_1[0]) + np.square(ys - point_1[1])
        square_distance_2 = np.square(xs - point_2[0]) + np.square(ys - point_2[1])
        square_distance = np.square(point_1[0] - point_2[0]) + np.square(
            point_1[1] - point_2[1]
        )
        if square_distance < 1e-12:
            return np.sqrt(square_distance_1)
        cosin = (square_distance - square_distance_1 - square_distance_2) / (
            2 * np.sqrt(square_distance_1 * square_distance_2)
        )
        square_sin = np.nan_to_num(1 - np.square(cosin))
        result = np.sqrt(
            square_distance_1 * square_distance_2 * square_sin / square_distance
        )
        result[cosin < 0] = np.sqrt(
            np.fmin(square_distance_1, square_distance_2)
        )[cosin < 0]
        return result
