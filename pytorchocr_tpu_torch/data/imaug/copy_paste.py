"""CopyPaste detection augmentation — the port's copy of
pytorchocr_tpu/data/imaug/copy_paste.py: text crops of another sample
(`ext_data`, from SimpleDataSet.get_ext_data) rotated and pasted onto the
image where they overlap no polygon. Host numpy, cv2 and PIL; it draws from
`random` and `np.random` in the JAX op's order, so a seeded sample equals
the JAX one.
"""

import random

import cv2
import numpy as np
from PIL import Image

from .iaa_augment import IaaAugment
from .random_crop_data import is_poly_outside_rect


class CopyPaste:
    """From copy_paste.py:14."""

    def __init__(self, objects_paste_ratio=0.2, limit_paste=True, **kwargs):
        self.ext_data_num = 1
        self.objects_paste_ratio = objects_paste_ratio
        self.limit_paste = limit_paste
        augmenter_args = [{"type": "Resize", "args": {"size": [0.5, 3]}}]
        self.aug = IaaAugment(augmenter_args)

    def __call__(self, data):
        point_num = data["polys"].shape[1]
        src_img = data["image"]
        src_polys = data["polys"].tolist()
        src_ignores = np.asarray(data["ignore_tags"]).tolist()
        ext_data = data["ext_data"][0]
        ext_image = ext_data["image"]
        ext_polys = np.asarray(ext_data["polys"])
        ext_ignores = np.asarray(ext_data["ignore_tags"])

        indexs = [i for i in range(len(ext_ignores)) if not ext_ignores[i]]
        select_num = max(1, min(int(self.objects_paste_ratio * len(ext_polys)), 30))

        random.shuffle(indexs)
        select_idxs = indexs[:select_num]
        select_polys = ext_polys[select_idxs]
        select_ignores = ext_ignores[select_idxs]

        src_img = cv2.cvtColor(src_img, cv2.COLOR_BGR2RGB)
        ext_image = cv2.cvtColor(ext_image, cv2.COLOR_BGR2RGB)
        src_img = Image.fromarray(src_img).convert("RGBA")
        for poly, tag in zip(select_polys, select_ignores):
            box_img = self.get_rotate_crop_image(ext_image, poly.astype(np.float32))
            src_img, box = self.paste_img(src_img, box_img, src_polys)
            if box is not None:
                box = box.tolist()
                for _ in range(len(box), point_num):
                    box.append(box[-1])
                src_polys.append(box)
                src_ignores.append(bool(tag))
        src_img = cv2.cvtColor(np.array(src_img), cv2.COLOR_RGB2BGR)
        h, w = src_img.shape[:2]
        src_polys = np.array(src_polys)
        src_polys[:, :, 0] = np.clip(src_polys[:, :, 0], 0, w)
        src_polys[:, :, 1] = np.clip(src_polys[:, :, 1], 0, h)
        data["image"] = src_img
        data["polys"] = src_polys
        data["ignore_tags"] = np.array(src_ignores)
        return data

    def paste_img(self, src_img, box_img, src_polys):
        box_img_pil = Image.fromarray(box_img).convert("RGBA")
        src_w, src_h = src_img.size
        box_w, box_h = box_img_pil.size

        angle = np.random.randint(0, 360)
        box = np.array([[[0, 0], [box_w, 0], [box_w, box_h], [0, box_h]]])
        box = rotate_bbox(box_img, box, angle)[0]
        box_img_pil = box_img_pil.rotate(angle, expand=1)
        box_w, box_h = box_img_pil.width, box_img_pil.height
        if src_w - box_w < 0 or src_h - box_h < 0:
            return src_img, None

        paste_x, paste_y = self.select_coord(
            src_polys, box, src_w - box_w, src_h - box_h
        )
        if paste_x is None:
            return src_img, None
        box[:, 0] += paste_x
        box[:, 1] += paste_y
        _, _, _, A = box_img_pil.split()
        src_img.paste(box_img_pil, (paste_x, paste_y), mask=A)
        return src_img, box

    @staticmethod
    def get_rotate_crop_image(img, points):
        assert len(points) == 4, "shape of points must be 4*2"
        img_crop_width = int(
            max(
                np.linalg.norm(points[0] - points[1]),
                np.linalg.norm(points[2] - points[3]),
            )
        )
        img_crop_height = int(
            max(
                np.linalg.norm(points[0] - points[3]),
                np.linalg.norm(points[1] - points[2]),
            )
        )
        pts_std = np.float32(
            [
                [0, 0],
                [img_crop_width, 0],
                [img_crop_width, img_crop_height],
                [0, img_crop_height],
            ]
        )
        M = cv2.getPerspectiveTransform(points, pts_std)
        dst_img = cv2.warpPerspective(
            img,
            M,
            (img_crop_width, img_crop_height),
            borderMode=cv2.BORDER_REPLICATE,
            flags=cv2.INTER_CUBIC,
        )
        dst_img_height, dst_img_width = dst_img.shape[0:2]
        if dst_img_height * 1.0 / dst_img_width >= 1.5:
            dst_img = np.rot90(dst_img)
        return dst_img

    def select_coord(self, src_polys, box, endx, endy):
        if self.limit_paste:
            xmin, ymin = box[:, 0].min(), box[:, 1].min()
            xmax, ymax = box[:, 0].max(), box[:, 1].max()
            for _ in range(50):
                paste_x = random.randint(0, endx)
                paste_y = random.randint(0, endy)
                xmin1, xmax1 = xmin + paste_x, xmax + paste_x
                ymin1, ymax1 = ymin + paste_y, ymax + paste_y
                num_poly_in_rect = 0
                for poly in src_polys:
                    if not is_poly_outside_rect(
                        poly, xmin1, ymin1, xmax1 - xmin1, ymax1 - ymin1
                    ):
                        num_poly_in_rect += 1
                        break
                if num_poly_in_rect == 0:
                    return paste_x, paste_y
            return None, None
        return random.randint(0, endx), random.randint(0, endy)


def rotate_bbox(img, text_polys, angle, scale=1):
    """Rotate polys with the expanded-canvas rotation matrix used for the
    pasted crop."""
    w = img.shape[1]
    h = img.shape[0]

    rangle = np.deg2rad(angle)
    nw = abs(np.sin(rangle) * h) + abs(np.cos(rangle) * w)
    nh = abs(np.cos(rangle) * h) + abs(np.sin(rangle) * w)
    rot_mat = cv2.getRotationMatrix2D((nw * 0.5, nh * 0.5), angle, scale)
    rot_move = np.dot(rot_mat, np.array([(nw - w) * 0.5, (nh - h) * 0.5, 0]))
    rot_mat[0, 2] += rot_move[0]
    rot_mat[1, 2] += rot_move[1]

    rot_text_polys = []
    for bbox in text_polys:
        pts = [np.dot(rot_mat, np.array([p[0], p[1], 1])) for p in bbox[:4]]
        rot_text_polys.append(pts)
    return np.array(rot_text_polys, dtype=np.float32)
