"""TIA (text image augmentation): moving-least-squares warps — the port's
copy of pytorchocr_tpu/data/imaug/text_image_aug.py:12-168 (`WarpMLS`,
`tia_distort`, `tia_stretch`, `tia_perspective`), with the same
`np.random` draws in the same order.

Schaefer et al.'s similarity-MLS deformation, evaluated on a coarse grid and
bilinearly upsampled, as vectorized numpy.
"""

import cv2
import numpy as np


class WarpMLS:
    """Similarity-MLS image warp: maps dst control points to src control
    points, evaluates the displacement on a `grid_size`-spaced lattice and
    bilinearly interpolates per-pixel source coordinates."""

    def __init__(self, src, src_pts, dst_pts, dst_w, dst_h, trans_ratio=1.0):
        self.src = src
        self.src_pts = np.asarray(src_pts, dtype=np.float64)
        self.dst_pts = np.asarray(dst_pts, dtype=np.float64)
        self.dst_w = dst_w
        self.dst_h = dst_h
        self.trans_ratio = trans_ratio
        self.grid_size = 100

    def generate(self):
        gx = np.arange(0, self.dst_w, self.grid_size)
        if gx[-1] != self.dst_w - 1:
            gx = np.append(gx, self.dst_w - 1)
        gy = np.arange(0, self.dst_h, self.grid_size)
        if gy[-1] != self.dst_h - 1:
            gy = np.append(gy, self.dst_h - 1)

        # MLS displacement at the lattice nodes, vectorized over nodes.
        X, Y = np.meshgrid(gx.astype(np.float64), gy.astype(np.float64))
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)  # (G, 2)
        G = pts.shape[0]
        P = self.dst_pts[None, :, :]  # (1, K, 2) control pts in dst space
        Q = self.src_pts[None, :, :]  # (1, K, 2) control pts in src space
        d2 = np.sum((pts[:, None, :] - P) ** 2, axis=2)  # (G, K)
        exact = d2 < 1e-8
        w = 1.0 / np.maximum(d2, 1e-8)  # (G, K)
        sw = w.sum(axis=1, keepdims=True)
        pstar = (w[:, :, None] * P).sum(axis=1) / sw  # (G, 2)
        qstar = (w[:, :, None] * Q).sum(axis=1) / sw

        pi = P - pstar[:, None, :]  # (G, K, 2)
        qi = Q - qstar[:, None, :]
        mu = (w * np.sum(pi * pi, axis=2)).sum(axis=1)  # (G,)
        v = pts - pstar  # (G, 2)
        v_perp = np.stack([-v[:, 1], v[:, 0]], axis=1)
        pi_perp = np.stack([-pi[:, :, 1], pi[:, :, 0]], axis=2)

        # similarity-MLS transform: for each control point k,
        #   fx += w/mu * [ (pi.v) qx_k - (pi_perp.v) qy_k ]
        #   fy += w/mu * [ -(pi.v_perp) qx_k + (pi_perp.v_perp) qy_k ]
        a = np.sum(pi * v[:, None, :], axis=2)  # pi . v
        b = np.sum(pi * v_perp[:, None, :], axis=2)  # pi . v_perp
        c = np.sum(pi_perp * v[:, None, :], axis=2)  # pi_perp . v
        d = np.sum(pi_perp * v_perp[:, None, :], axis=2)  # pi_perp . v_perp
        fx = (w / np.maximum(mu[:, None], 1e-12)) * (a * Q[:, :, 0] - c * Q[:, :, 1])
        fy = (w / np.maximum(mu[:, None], 1e-12)) * (-b * Q[:, :, 0] + d * Q[:, :, 1])
        new_pts = np.stack([fx.sum(axis=1), fy.sum(axis=1)], axis=1) + qstar

        # nodes that coincide with a control point map exactly to its source
        hit = exact.any(axis=1)
        if hit.any():
            k_idx = exact.argmax(axis=1)
            new_pts[hit] = self.src_pts[k_idx[hit]]

        delta = (new_pts - pts).reshape(len(gy), len(gx), 2)

        # bilinear upsample of the lattice displacement to every dst pixel
        xs = np.arange(self.dst_w)
        ys = np.arange(self.dst_h)
        ix = np.clip(np.searchsorted(gx, xs, side="right") - 1, 0, len(gx) - 2)
        iy = np.clip(np.searchsorted(gy, ys, side="right") - 1, 0, len(gy) - 2)
        tx = (xs - gx[ix]) / np.maximum(gx[ix + 1] - gx[ix], 1)
        ty = (ys - gy[iy]) / np.maximum(gy[iy + 1] - gy[iy], 1)

        d00 = delta[iy[:, None], ix[None, :]]
        d01 = delta[iy[:, None], ix[None, :] + 1]
        d10 = delta[iy[:, None] + 1, ix[None, :]]
        d11 = delta[iy[:, None] + 1, ix[None, :] + 1]
        wx = tx[None, :, None]
        wy = ty[:, None, None]
        dxy = (
            d00 * (1 - wx) * (1 - wy)
            + d01 * wx * (1 - wy)
            + d10 * (1 - wx) * wy
            + d11 * wx * wy
        )

        src_h, src_w = self.src.shape[:2]
        map_x = np.clip(
            xs[None, :] + dxy[:, :, 0] * self.trans_ratio, 0, src_w - 1
        ).astype(np.float32)
        map_y = np.clip(
            ys[:, None] + dxy[:, :, 1] * self.trans_ratio, 0, src_h - 1
        ).astype(np.float32)

        return cv2.remap(
            self.src, map_x, map_y, interpolation=cv2.INTER_LINEAR
        )


def tia_distort(src, segment=4):
    img_h, img_w = src.shape[:2]
    cut = img_w // segment
    thresh = max(cut // 3, 1)

    src_pts = [[0, 0], [img_w, 0], [img_w, img_h], [0, img_h]]
    dst_pts = [
        [np.random.randint(thresh), np.random.randint(thresh)],
        [img_w - np.random.randint(thresh), np.random.randint(thresh)],
        [img_w - np.random.randint(thresh), img_h - np.random.randint(thresh)],
        [np.random.randint(thresh), img_h - np.random.randint(thresh)],
    ]
    half_thresh = thresh * 0.5
    for cut_idx in range(1, segment):
        src_pts.append([cut * cut_idx, 0])
        src_pts.append([cut * cut_idx, img_h])
        dst_pts.append(
            [
                cut * cut_idx + np.random.randint(thresh) - half_thresh,
                np.random.randint(thresh) - half_thresh,
            ]
        )
        dst_pts.append(
            [
                cut * cut_idx + np.random.randint(thresh) - half_thresh,
                img_h + np.random.randint(thresh) - half_thresh,
            ]
        )
    return WarpMLS(src, src_pts, dst_pts, img_w, img_h).generate()


def tia_stretch(src, segment=4):
    img_h, img_w = src.shape[:2]
    cut = img_w // segment
    thresh = max(cut * 4 // 5, 1)

    src_pts = [[0, 0], [img_w, 0], [img_w, img_h], [0, img_h]]
    dst_pts = [[0, 0], [img_w, 0], [img_w, img_h], [0, img_h]]
    half_thresh = thresh * 0.5
    for cut_idx in range(1, segment):
        move = np.random.randint(thresh) - half_thresh
        src_pts.append([cut * cut_idx, 0])
        src_pts.append([cut * cut_idx, img_h])
        dst_pts.append([cut * cut_idx + move, 0])
        dst_pts.append([cut * cut_idx + move, img_h])
    return WarpMLS(src, src_pts, dst_pts, img_w, img_h).generate()


def tia_perspective(src):
    img_h, img_w = src.shape[:2]
    thresh = max(1, img_h // 2)

    src_pts = [[0, 0], [img_w, 0], [img_w, img_h], [0, img_h]]
    dst_pts = [
        [0, np.random.randint(thresh)],
        [img_w, np.random.randint(thresh)],
        [img_w, img_h - np.random.randint(thresh)],
        [0, img_h - np.random.randint(thresh)],
    ]
    return WarpMLS(src, src_pts, dst_pts, img_w, img_h).generate()
