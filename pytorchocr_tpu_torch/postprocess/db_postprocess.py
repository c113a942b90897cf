"""DB postprocess — port of pytorchocr_tpu/postprocess/db_postprocess.py.

Device path (score_mode "poly", boxes as quads, no padding resize): the
front half (threshold, optional 2x2 dilation, connected components, per-label
count/score/bbox; ops/cc_label.py) runs on the tensor's device for every image
of the batch, then the stacked stats cross to the host at once. The host tail
(minAreaRect + unclip over the surviving components) runs the port's
utils/geometry.py on numpy, as the JAX `_call_device` does.

Host path (out_polygon, score_mode "box", padding resize): the map goes to
numpy and through `boxes_from_bitmap` (contours, cv2), the port's copy of
the JAX class's host code (db_postprocess.py:163-245).

The JAX class picks its device path by `hasattr(pred, "device")`, which a
torch tensor (and a numpy 2 array) passes; the port decides by type. Not
ported: DistillationDBPostProcess (ROADMAP.md A.12).
"""

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cc_label import db_front_half
from ..utils import geometry
from ..utils.utility import transform_preds


class DBPostProcess:
    def __init__(self, thresh=0.3, box_thresh=0.5, max_candidates=1000,
                 unclip_ratio=1.5, use_dilation=False, score_mode="poly",
                 cpp_speedup=False, out_polygon=False, **kwargs):
        if score_mode not in ("box", "poly"):
            raise ValueError("Score mode must be in [box, poly] but got: %s" % score_mode)
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio
        self.min_size = 3
        self.use_dilation = use_dilation
        self.score_mode = score_mode
        self.out_polygon = out_polygon

    def __call__(self, outs_dict, shape_list, use_padding_resize=False):
        pred = outs_dict["maps"]
        if not torch.is_tensor(pred):
            pred = torch.from_numpy(np.asarray(pred, np.float32))
        prob = pred[..., 0] if pred.dim() == 4 else pred
        if not self.out_polygon and not use_padding_resize and self.score_mode == "poly":
            return self._call_device(prob, shape_list)
        return self._call_host(prob.float().cpu().numpy(), shape_list, use_padding_resize)

    def _call_host(self, pred, shape_list, use_padding_resize):
        segmentation = pred > self.thresh
        res = []
        for i in range(pred.shape[0]):
            src_h, src_w = int(shape_list[i][0]), int(shape_list[i][1])
            mask = segmentation[i]
            if self.use_dilation:
                mask = cv2.dilate(mask.astype(np.uint8), np.ones((2, 2), np.uint8))
            boxes, scores = self.boxes_from_bitmap(
                pred[i], mask, src_w, src_h, use_padding_resize
            )
            res.append({"points": boxes, "scores": scores})
        return res

    def _call_device(self, prob, shape_list):
        prob = prob.float()
        if self.use_dilation:
            binary = (prob > self.thresh).float()[:, None]
            dil = F.max_pool2d(F.pad(binary, (0, 1, 0, 1)), 2, stride=1)[:, 0]
            # a map whose thresholding gives the dilated mask; pixels the
            # dilation adds score at thresh + 1e-6, as in the JAX device
            # path (its host path scores them at their own probability)
            prob = torch.maximum(prob, torch.where(dil > 0, self.thresh + 1e-6, 0.0))
        n, height, width = prob.shape
        stats = [
            db_front_half(prob[i], self.thresh, max_labels=self.max_candidates)
            for i in range(n)
        ]
        # one transfer per field for the whole batch
        labels_all = torch.stack([s["labels"] for s in stats]).cpu().numpy()
        packed = torch.stack([
            torch.cat([s["count"][:, None], s["score"][:, None],
                       s["bbox"].to(torch.float64)], dim=1)
            for s in stats
        ]).cpu().numpy()  # (N, L, 6) f64: count, score, bbox (exact in f64)

        res = []
        for i in range(n):
            labels = labels_all[i]
            count, score_arr = packed[i, :, 0], packed[i, :, 1].astype(np.float32)
            bbox = packed[i, :, 2:].astype(np.int64)
            src_h, src_w = int(shape_list[i][0]), int(shape_list[i][1])
            boxes, scores = [], []
            for lbl in range(1, len(count)):
                if count[lbl] <= 0:
                    continue
                score = float(score_arr[lbl])
                if self.box_thresh > score:
                    continue
                x0, y0, x1, y1 = bbox[lbl]
                pts = np.argwhere(labels[y0:y1 + 1, x0:x1 + 1] == lbl)[:, ::-1]
                pts = pts + np.array([[x0, y0]])
                points, sside = geometry.min_area_rect_points(pts.astype(np.float32))
                if sside < self.min_size:
                    continue
                distance = geometry.unclip_distance(points, self.unclip_ratio)
                cloud = geometry.unclip_points(points, distance)
                box, sside = geometry.min_area_rect_points(cloud)
                if sside < self.min_size + 2:
                    continue
                box = np.array(box).reshape(-1, 2)
                box[:, 0] = np.clip(np.round(box[:, 0] / width * src_w), 0, src_w)
                box[:, 1] = np.clip(np.round(box[:, 1] / height * src_h), 0, src_h)
                boxes.append(box.astype(np.int16))
                scores.append(score)
            res.append({"points": np.array(boxes, dtype=np.int16), "scores": scores})
        return res

    def boxes_from_bitmap(self, pred, _bitmap, dest_width, dest_height,
                          use_padding_resize=False):
        """Boxes of the contours of a host bitmap, scored on `pred`. From
        pytorchocr_tpu/postprocess/db_postprocess.py:163."""
        bitmap = _bitmap
        height, width = bitmap.shape

        outs = cv2.findContours(
            (bitmap * 255).astype(np.uint8), cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE
        )
        contours = outs[0] if len(outs) == 2 else outs[1]

        num_contours = min(len(contours), self.max_candidates)

        boxes = []
        scores = []
        for index in range(num_contours):
            contour = contours[index]
            if self.out_polygon:
                epsilon = 0.005 * cv2.arcLength(contour, True)
                approx = cv2.approxPolyDP(contour, epsilon, True)
                points = approx.reshape((-1, 2))
                if points.shape[0] < 4:
                    continue
            else:
                points, sside = geometry.min_area_rect_points(contour)
                if sside < self.min_size:
                    continue
            if self.score_mode == "box":
                score = self.box_score(pred, points)
            else:
                score = self.box_score(pred, contour.reshape(-1, 2))
            if self.box_thresh > score:
                continue

            distance = geometry.unclip_distance(points, self.unclip_ratio)
            if self.out_polygon:
                expanded = geometry.unclip_polygon(points, distance)
                if expanded is None:
                    continue
                box = expanded
                _, sside = geometry.min_area_rect_points(box)
            else:
                cloud = geometry.unclip_points(points, distance)
                box, sside = geometry.min_area_rect_points(cloud)
            if sside < self.min_size + 2:
                continue
            box = np.array(box).reshape(-1, 2)
            if use_padding_resize:
                center = np.array([dest_width / 2.0, dest_height / 2.0], dtype=np.float32)
                src_maxsize = max(dest_width, dest_height) * 1.0
                target_size = height
                box = transform_preds(box, center, src_maxsize, target_size)
                box[:, 0] = np.clip(np.round(box[:, 0]), 0, dest_width)
                box[:, 1] = np.clip(np.round(box[:, 1]), 0, dest_height)
            else:
                box[:, 0] = np.clip(np.round(box[:, 0] / width * dest_width), 0, dest_width)
                box[:, 1] = np.clip(np.round(box[:, 1] / height * dest_height), 0, dest_height)
            boxes.append(box.astype(np.int16))
            scores.append(score)
        boxes = np.array(boxes, dtype=np.int16)
        return boxes, scores

    @staticmethod
    def box_score(bitmap, _pts):
        """Mean prob inside the box or contour. From
        pytorchocr_tpu/postprocess/db_postprocess.py:231."""
        h, w = bitmap.shape[:2]
        pts = _pts.copy().astype(np.float32)
        xmin = np.clip(np.floor(pts[:, 0].min()).astype(np.int32), 0, w - 1)
        xmax = np.clip(np.ceil(pts[:, 0].max()).astype(np.int32), 0, w - 1)
        ymin = np.clip(np.floor(pts[:, 1].min()).astype(np.int32), 0, h - 1)
        ymax = np.clip(np.ceil(pts[:, 1].max()).astype(np.int32), 0, h - 1)

        mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), dtype=np.uint8)
        pts[:, 0] = pts[:, 0] - xmin
        pts[:, 1] = pts[:, 1] - ymin
        cv2.fillPoly(mask, pts.reshape(1, -1, 2).astype(np.int32), 1)
        return cv2.mean(bitmap[ymin : ymax + 1, xmin : xmax + 1], mask)[0]
