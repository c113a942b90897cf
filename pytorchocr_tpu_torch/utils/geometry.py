"""Polygon geometry of the detection postprocesses — the port's copy of the
functions of pytorchocr_tpu/utils/geometry.py that it calls (lines 33-237), so
that the port imports nothing of the JAX package. Host-side numpy and cv2.

The unclip of the DB postprocess is a disk dilation: the min-area rect of a
polygon dilated by a disk of radius d is the rect over its hull points each
expanded by d in all directions, sampled here at 16 angles (geometry.py:1-23).
"""

import cv2
import numpy as np


def polygon_area(poly):
    """Signed shoelace area, positive for clockwise polygons in image
    coordinates (y down). From geometry.py:33."""
    poly = np.asarray(poly, dtype=np.float64)
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, 1) - y * np.roll(x, 1)))


def polygon_perimeter(poly):
    """From geometry.py:41."""
    poly = np.asarray(poly, dtype=np.float64)
    d = poly - np.roll(poly, 1, axis=0)
    return float(np.sum(np.sqrt((d * d).sum(axis=1))))


def unclip_distance(poly, unclip_ratio):
    """DB unclip offset: d = A * ratio / L. From geometry.py:56."""
    area = abs(polygon_area(poly))
    perim = polygon_perimeter(poly)
    if perim <= 0:
        return 0.0
    return area * unclip_ratio / perim


_DISK_SAMPLES = 16
_DISK = np.stack(
    [
        np.cos(np.linspace(0, 2 * np.pi, _DISK_SAMPLES, endpoint=False)),
        np.sin(np.linspace(0, 2 * np.pi, _DISK_SAMPLES, endpoint=False)),
    ],
    axis=1,
)


def unclip_points(poly, distance):
    """Point cloud covering the hull of `poly` dilated by a disk of radius
    `distance`, for cv2.minAreaRect: 16 angles per vertex (max radial error
    ~2% of d). From geometry.py:165."""
    poly = np.asarray(poly, dtype=np.float32)
    pts = (poly[:, None, :] + (_DISK * float(distance))[None, :, :]).reshape(-1, 2)
    return pts.astype(np.float32)


def unclip_polygon(poly, distance):
    """Outward offset of a simple polygon as a polygon (the out_polygon
    path): rasterised and dilated with a disk kernel. From geometry.py:176."""
    poly = np.asarray(poly, dtype=np.float32)
    r = int(np.ceil(distance))
    ipoly = np.round(poly).astype(np.int32)
    x0, y0 = ipoly.min(axis=0) - r - 2
    x1, y1 = ipoly.max(axis=0) + r + 3
    w, h = int(x1 - x0), int(y1 - y0)
    if w <= 0 or h <= 0:
        return None
    roi = np.zeros((h, w), dtype=np.uint8)
    cv2.fillPoly(roi, [ipoly - np.array([[x0, y0]], dtype=np.int32)], 1)
    if r > 0:
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1, 2 * r + 1))
        roi = cv2.dilate(roi, kernel)
    contours, _ = cv2.findContours(roi, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    contour = max(contours, key=cv2.contourArea).reshape(-1, 2)
    return (contour + np.array([[x0, y0]])).astype(np.float32)


def min_area_rect_points(points):
    """cv2.minAreaRect with the reference's corner ordering (get_mini_boxes):
    (4x2 array, shortest side length). From geometry.py:204."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 1, 2)
    bounding_box = cv2.minAreaRect(pts)
    box_pts = sorted(list(cv2.boxPoints(bounding_box)), key=lambda x: x[0])

    if box_pts[1][1] > box_pts[0][1]:
        index_1, index_4 = 0, 1
    else:
        index_1, index_4 = 1, 0
    if box_pts[3][1] > box_pts[2][1]:
        index_2, index_3 = 2, 3
    else:
        index_2, index_3 = 3, 2
    box = np.array(
        [box_pts[index_1], box_pts[index_2], box_pts[index_3], box_pts[index_4]],
        dtype=np.float32,
    )
    return box, min(bounding_box[1])


def order_points_clockwise(pts):
    """Order 4 points tl, tr, br, bl. From geometry.py:227."""
    pts = np.asarray(pts, dtype=np.float32)
    rect = np.zeros((4, 2), dtype=np.float32)
    s = pts.sum(axis=1)
    rect[0] = pts[np.argmin(s)]
    rect[2] = pts[np.argmax(s)]
    diff = np.diff(pts, axis=1)
    rect[1] = pts[np.argmin(diff)]
    rect[3] = pts[np.argmax(diff)]
    return rect
