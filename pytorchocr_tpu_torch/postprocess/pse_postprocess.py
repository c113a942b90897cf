"""PSE postprocess — port of pytorchocr_tpu/postprocess/pse_postprocess.py.

Maps are NHWC (N, H/4, W/4, 7) logits. On the tensor's device: nearest
upsample by 4 // scale, the sigmoid of map 0 (after the upsample, as the JAX
class orders it), the kernels as pred > thresh masked by the text map, and
ops/cc_label.py:pse_expand_device per image (K1 and K2 on the card). Then
the int32 labels and the float32 score cross to the host at once, and
`generate_box` (a copy of the JAX host loop: label == i in raster order, the
min_area and box_thresh filters, minAreaRect or the out_polygon contour)
makes the boxes. `use_device_expand=False` expands on the host with the JAX
package's framework-free `pse_np` instead.
"""

import cv2
import numpy as np
import torch

from pytorchocr_tpu.ops.propagate import pse_np
from pytorchocr_tpu.utils.geometry import order_points_clockwise

from ..modeling.common import resize_nearest
from ..ops.cc_label import pse_expand_device

__all__ = ["PSEPostProcess", "generate_box"]


def as_maps(pred):
    """The head's NHWC maps as a float32 tensor (numpy is accepted too)."""
    if not torch.is_tensor(pred):
        pred = torch.from_numpy(np.asarray(pred, np.float32))
    return pred.float()


def generate_box(score, label, shape, min_area, box_thresh, out_polygon):
    """Boxes and scores of the components of an int32 label map, in label
    order, as the JAX PSE/PAN postprocesses make them."""
    src_h, src_w, ratio_h, ratio_w = shape
    label = label.copy()  # rejected components are zeroed in place
    label_num = np.max(label) + 1

    boxes = []
    scores = []
    for i in range(1, label_num):
        ind = label == i
        points = np.array(np.where(ind)).transpose((1, 0))[:, ::-1]

        if points.shape[0] < min_area:
            label[ind] = 0
            continue
        score_i = np.mean(score[ind])
        if score_i < box_thresh:
            label[ind] = 0
            continue

        if not out_polygon:
            rect = cv2.minAreaRect(points)
            bbox = cv2.boxPoints(rect)
            bbox = order_points_clockwise(bbox)
        else:
            box_height = np.max(points[:, 1]) + 10
            box_width = np.max(points[:, 0]) + 10
            mask = np.zeros((box_height, box_width), dtype=np.uint8)
            mask[points[:, 1], points[:, 0]] = 255
            contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            bbox = np.squeeze(contours[0], 1)

        bbox[:, 0] = np.clip(np.round(bbox[:, 0] / ratio_w), 0, src_w)
        bbox[:, 1] = np.clip(np.round(bbox[:, 1] / ratio_h), 0, src_h)
        boxes.append(bbox.astype(np.int16))
        scores.append(score_i)
    boxes = np.array(boxes, dtype=np.int16)
    return boxes, scores


class PSEPostProcess:
    def __init__(self, thresh=0.5, box_thresh=0.85, min_area=16, scale=4,
                 out_polygon=False, use_device_expand=True, **kwargs):
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.min_area = min_area
        self.out_polygon = out_polygon
        self.scale = scale
        self.use_device_expand = use_device_expand

    def front_half(self, maps):
        """Device part: (score (N, H, W) f32, kernels (N, K, H, W) bool,
        labels (N, H, W) int32 or None) on the maps' device."""
        pred = as_maps(maps)
        if self.scale != 4:
            pred = resize_nearest(pred.permute(0, 3, 1, 2), 4 // self.scale).permute(0, 2, 3, 1)
        score = torch.sigmoid(pred[..., 0])
        kernels = (pred > self.thresh) & (pred[..., 0:1] > self.thresh)
        kernels = kernels.permute(0, 3, 1, 2).contiguous()
        labels = None
        if self.use_device_expand:
            min_area = self.min_area / (self.scale ** 2)
            labels = torch.stack([pse_expand_device(k, min_area) for k in kernels])
        return score, kernels, labels

    def __call__(self, outs_dict, shape_list):
        maps = outs_dict["maps"]
        self.img_h, self.img_w = maps.shape[1] * 4, maps.shape[2] * 4
        score, kernels, labels = self.front_half(maps)
        score = score.cpu().numpy()
        if labels is not None:
            labels = labels.cpu().numpy()
        else:
            kernels = kernels.to(torch.uint8).cpu().numpy()
        res_batch = []
        for i in range(score.shape[0]):
            label = labels[i] if labels is not None else None
            boxes, scores = self.boxes_from_bitmap(score[i], kernels[i], shape_list[i], label)
            res_batch.append({"points": boxes, "scores": scores})
        return res_batch

    def boxes_from_bitmap(self, score, kernels, shape, label=None):
        if label is None:
            label = pse_np(kernels, self.min_area / (self.scale ** 2))
        if self.scale != 1:
            label = cv2.resize(label, (self.img_w, self.img_h), interpolation=cv2.INTER_NEAREST)
            score = cv2.resize(score, (self.img_w, self.img_h), interpolation=cv2.INTER_NEAREST)
        return generate_box(score, label, shape, self.min_area, self.box_thresh,
                            self.out_polygon)
