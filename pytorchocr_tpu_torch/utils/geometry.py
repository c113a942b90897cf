"""Polygon geometry of the detection GT makers, postprocesses and metric —
the port's copy of the functions of pytorchocr_tpu/utils/geometry.py that it
calls (lines 33-379), so that the port imports nothing of the JAX package.
Host-side numpy and cv2.

The shrink of the DB GT maps is a distance-transform threshold: a pixel is in
the polygon shrunk by d iff it lies inside and at least d from its boundary
(geometry.py:66-164). The metric's polygon intersection is Sutherland-Hodgman
clipping against a convex polygon, with a raster fallback for two non-convex
ones (geometry.py:245-379).

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


def shrink_distance(poly, ratio):
    """DB shrink offset: d = A * (1 - r^2) / L. From geometry.py:47."""
    area = abs(polygon_area(poly))
    perim = polygon_perimeter(poly)
    if perim <= 0:
        return 0.0
    return area * (1.0 - ratio ** 2) / perim


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


def rasterize_shrunk_polygon(canvas, poly, distance, value=1):
    """Fill `canvas` with `value` on the inward offset of `poly` by `distance`.

    Equivalent to the reference's pyclipper JT_ROUND negative offset followed
    by cv2.fillPoly: a pixel belongs to the shrunk region iff it is inside
    the polygon and its distance to the boundary is >= `distance`.

    Returns True if the shrunk region is non-empty (an empty shrink marks
    the text instance ignored). From geometry.py:71.
    """
    h, w = canvas.shape[:2]
    ipoly = np.round(np.asarray(poly)).astype(np.int32)
    x0 = max(int(ipoly[:, 0].min()) - 2, 0)
    x1 = min(int(ipoly[:, 0].max()) + 3, w)
    y0 = max(int(ipoly[:, 1].min()) - 2, 0)
    y1 = min(int(ipoly[:, 1].max()) + 3, h)
    if x1 <= x0 or y1 <= y0:
        return False
    if distance <= 0:
        cv2.fillPoly(canvas, [ipoly], value)
        return True
    roi = np.zeros((y1 - y0, x1 - x0), dtype=np.uint8)
    cv2.fillPoly(roi, [ipoly - np.array([[x0, y0]], dtype=np.int32)], 1)
    # distance of each interior pixel to the nearest zero (outside) pixel
    dist = cv2.distanceTransform(roi, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
    shrunk = dist >= float(distance)
    if not shrunk.any():
        return False
    region = canvas[y0:y1, x0:x1]
    region[shrunk] = value
    return True


def polygon_distance_field(poly, canvas_shape):
    """Precompute the interior distance field of `poly` clipped to a canvas.

    Returns (x0, y0, dist) where `dist` is the ROI's per-pixel L2 distance
    to the polygon exterior (0 outside), or None for a degenerate ROI.
    One field serves every shrink distance: thresholding `dist >= d`
    reproduces rasterize_shrunk_polygon(..., distance=d) exactly, so
    multi-rate GT makers (PSE's 7 kernels) pay ONE fillPoly +
    distanceTransform per polygon instead of one per (polygon, rate). From
    geometry.py:107.
    """
    h, w = canvas_shape[:2]
    ipoly = np.round(np.asarray(poly)).astype(np.int32)
    x0 = max(int(ipoly[:, 0].min()) - 2, 0)
    x1 = min(int(ipoly[:, 0].max()) + 3, w)
    y0 = max(int(ipoly[:, 1].min()) - 2, 0)
    y1 = min(int(ipoly[:, 1].max()) + 3, h)
    if x1 <= x0 or y1 <= y0:
        return None
    roi = np.zeros((y1 - y0, x1 - x0), dtype=np.uint8)
    cv2.fillPoly(roi, [ipoly - np.array([[x0, y0]], dtype=np.int32)], 1)
    dist = cv2.distanceTransform(roi, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
    return x0, y0, dist


def shrunk_polygon_points(poly, distance, image_shape=None):
    """Return the contour (N,2 int array) of the inward offset of `poly`,
    or None if it vanishes.  Used where the reference needs the shrunk
    *polygon* rather than its raster (e.g. PSE GT with label values). From
    geometry.py:137."""
    ipoly = np.round(np.asarray(poly)).astype(np.int32)
    x0, y0 = ipoly.min(axis=0) - 2
    x1, y1 = ipoly.max(axis=0) + 3
    w, h = x1 - x0, y1 - y0
    if w <= 0 or h <= 0:
        return None
    roi = np.zeros((h, w), dtype=np.uint8)
    cv2.fillPoly(roi, [ipoly - np.array([[x0, y0]], dtype=np.int32)], 1)
    if distance > 0:
        dist = cv2.distanceTransform(roi, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
        roi = (dist >= float(distance)).astype(np.uint8)
    if not roi.any():
        return None
    contours, _ = cv2.findContours(roi, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    contour = max(contours, key=cv2.contourArea).reshape(-1, 2)
    return contour + np.array([[x0, y0]])


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def _is_convex(poly):
    p = np.asarray(poly, dtype=np.float64)
    n = len(p)
    if n < 4:
        return True
    cross = []
    for i in range(n):
        a, b, c = p[i], p[(i + 1) % n], p[(i + 2) % n]
        cross.append(_cross2(b - a, c - b))
    cross = np.array(cross)
    return bool(np.all(cross >= -1e-9) or np.all(cross <= 1e-9))


def _clip_sutherland_hodgman(subject, clip):
    """Clip `subject` polygon by convex `clip` polygon; returns vertex list."""
    clip = np.asarray(clip, dtype=np.float64)
    # Orient the clip polygon so cross(edge, p-a) >= 0 means inside.
    # polygon_area() here is 0.5*sum(x_i*y_{i-1} - y_i*x_{i-1}), the negative
    # of the standard CCW shoelace — so positive area means CW in math coords.
    if polygon_area(clip) > 0:
        clip = clip[::-1]
    output = list(np.asarray(subject, dtype=np.float64))
    n = len(clip)
    for i in range(n):
        if not output:
            return []
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        input_list, output = output, []
        prev = input_list[-1]
        prev_in = _cross2(edge, prev - a) >= 0
        for cur in input_list:
            cur_in = _cross2(edge, cur - a) >= 0
            if cur_in:
                if not prev_in:
                    output.append(_line_intersect(prev, cur, a, b))
                output.append(cur)
            elif prev_in:
                output.append(_line_intersect(prev, cur, a, b))
            prev, prev_in = cur, cur_in
    return output


def _line_intersect(p1, p2, a, b):
    d1 = p2 - p1
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return p2
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def _raster_intersection_area(poly_a, poly_b, scale=4):
    """Fallback for non-convex x non-convex: rasterize both at `scale`x."""
    pa = np.asarray(poly_a, dtype=np.float64)
    pb = np.asarray(poly_b, dtype=np.float64)
    lo = np.minimum(pa.min(axis=0), pb.min(axis=0))
    hi = np.maximum(pa.max(axis=0), pb.max(axis=0))
    size = np.maximum((hi - lo) * scale + 3, 1).astype(np.int64)
    if size[0] * size[1] > 16_000_000:  # keep memory bounded
        scale = max(1, int(scale * np.sqrt(16_000_000 / (size[0] * size[1]))))
        size = np.maximum((hi - lo) * scale + 3, 1).astype(np.int64)
    ma = np.zeros((int(size[1]), int(size[0])), dtype=np.uint8)
    mb = np.zeros_like(ma)
    cv2.fillPoly(ma, [np.round((pa - lo) * scale).astype(np.int32)], 1)
    cv2.fillPoly(mb, [np.round((pb - lo) * scale).astype(np.int32)], 1)
    return float(np.logical_and(ma, mb).sum()) / (scale * scale)


def poly_intersection_area(poly_a, poly_b):
    """Area of intersection of two simple polygons."""
    pa = np.asarray(poly_a, dtype=np.float64)
    pb = np.asarray(poly_b, dtype=np.float64)
    if len(pa) < 3 or len(pb) < 3:
        return 0.0
    if _is_convex(pb):
        clipped = _clip_sutherland_hodgman(pa, pb)
    elif _is_convex(pa):
        clipped = _clip_sutherland_hodgman(pb, pa)
    else:
        return _raster_intersection_area(pa, pb)
    if len(clipped) < 3:
        return 0.0
    return abs(polygon_area(np.array(clipped)))


def _segments_properly_intersect(p1, p2, p3, p4):
    d1 = _cross2(p4 - p3, p1 - p3)
    d2 = _cross2(p4 - p3, p2 - p3)
    d3 = _cross2(p2 - p1, p3 - p1)
    d4 = _cross2(p2 - p1, p4 - p1)
    return ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0))


def is_valid_simple_polygon(poly):
    """shapely's is_valid & is_simple stand-in: >=3 distinct vertices,
    nonzero area, no properly crossing non-adjacent edges."""
    poly = np.asarray(poly, dtype=np.float64)
    n = len(poly)
    if n < 3:
        return False
    if abs(polygon_area(poly)) <= 0:
        return False
    for i in range(n):
        a1, a2 = poly[i], poly[(i + 1) % n]
        for j in range(i + 1, n):
            # skip adjacent edges (shared vertex)
            if j == i or (j + 1) % n == i or (i + 1) % n == j:
                continue
            b1, b2 = poly[j], poly[(j + 1) % n]
            if _segments_properly_intersect(a1, a2, b1, b2):
                return False
    return True


def poly_union_area(poly_a, poly_b):
    inter = poly_intersection_area(poly_a, poly_b)
    return abs(polygon_area(poly_a)) + abs(polygon_area(poly_b)) - inter


def poly_iou(poly_a, poly_b):
    inter = poly_intersection_area(poly_a, poly_b)
    if inter <= 0:
        return 0.0
    area_a = abs(polygon_area(poly_a))
    area_b = abs(polygon_area(poly_b))
    union = area_a + area_b - inter
    if union <= 0:
        return 0.0
    return inter / union
