"""Box reading order, line crops and the padding-resize rescale — the port's
copy of pytorchocr_tpu/utils/utility.py:9-87, so that the port imports
nothing of the JAX package. Host-side numpy and cv2.
"""

import cv2
import numpy as np


def sort_boxes(dt_boxes):
    """Sort text boxes top-to-bottom, left-to-right (reading order), with a
    10px same-line tolerance. From utility.py:9."""
    dt_boxes = np.asarray(dt_boxes)
    num_boxes = dt_boxes.shape[0]
    sorted_boxes = sorted(dt_boxes, key=lambda x: (x[0][1], x[0][0]))
    _boxes = list(sorted_boxes)
    for i in range(num_boxes - 1):
        if abs(_boxes[i + 1][0][1] - _boxes[i][0][1]) < 10 and (
            _boxes[i + 1][0][0] < _boxes[i][0][0]
        ):
            _boxes[i], _boxes[i + 1] = _boxes[i + 1], _boxes[i]
    return _boxes


def get_part_img(img, pts):
    """Perspective-warp crop of a quad text region out of `img`. From
    utility.py:24."""
    pts = np.asarray(pts, dtype=np.float32).copy()
    left = int(np.min(pts[:, 0]))
    right = int(np.max(pts[:, 0]))
    top = int(np.min(pts[:, 1]))
    bottom = int(np.max(pts[:, 1]))
    img_crop = img[top:bottom, left:right].copy()
    pts -= np.array([left, top], dtype=np.float32)

    img_crop_w = int(right - left)
    img_crop_h = int(bottom - top)
    dst_pts = np.array(
        [
            [0, 0],
            [img_crop_w - 1, 0],
            [img_crop_w - 1, img_crop_h - 1],
            [0, img_crop_h - 1],
        ],
        dtype=np.float32,
    )
    M = cv2.getPerspectiveTransform(pts, dst_pts)
    return cv2.warpPerspective(
        img_crop,
        M,
        (img_crop_w, img_crop_h),
        borderMode=cv2.BORDER_REPLICATE,
        flags=cv2.INTER_LINEAR,
    )


def get_affine_transform(center, img_maxsize, target_size, inv=0):
    """Affine matrix of the padding resize of an image to a square target
    (and its inverse). From utility.py:57."""
    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center
    src[1, :] = center + np.array((0, img_maxsize / 2.0))
    dst[0, :] = np.array((target_size / 2.0, target_size / 2.0))
    dst[1, :] = dst[0, :] + np.array((0, target_size / 2.0))
    if center[0] >= center[1]:  # wider than tall
        src[2, :] = np.array((0, center[1] - center[0]))
    else:
        src[2, :] = np.array((center[0] - center[1], 0))
    if inv:
        return cv2.getAffineTransform(np.float32(dst), np.float32(src))
    return cv2.getAffineTransform(np.float32(src), np.float32(dst))


def affine_transform(pt, t):
    """From utility.py:76."""
    new_pt = np.array([pt[0], pt[1], 1.0], dtype=np.float32).T
    new_pt = np.dot(t, new_pt)
    return new_pt[:2]


def transform_preds(coords, center, img_maxsize, target_size):
    """From utility.py:82."""
    target_coords = np.zeros(coords.shape)
    trans = get_affine_transform(center, img_maxsize, target_size, inv=1)
    for p in range(coords.shape[0]):
        target_coords[p, 0:2] = affine_transform(coords[p, 0:2], trans)
    return target_coords
