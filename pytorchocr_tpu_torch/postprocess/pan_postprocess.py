"""PAN postprocess — port of pytorchocr_tpu/postprocess/pan_postprocess.py.

Maps are NHWC (N, H/4, W/4, 6) = [text, kernel, emb x4] logits. On the
tensor's device: nearest upsample by 4 // scale, the sigmoid of the text map,
text and kernel as pred > thresh (the kernel masked by the text), the
embeddings masked by the text, and ops/cc_label.py:pa_aggregate_device per
image (K1 labels the components). The labels and the score cross to the
host, are resized to the page by cv2 INTER_NEAREST when scale != 1, and
pse_postprocess.generate_box makes the boxes. `use_device_aggregate=False`
aggregates on the host with the JAX package's framework-free `pa_np`.
"""

import cv2
import numpy as np
import torch

from pytorchocr_tpu.ops.propagate import pa_np

from ..modeling.common import resize_nearest
from ..ops.cc_label import pa_aggregate_device
from .pse_postprocess import as_maps, generate_box

__all__ = ["PANPostProcess"]


class PANPostProcess:
    def __init__(self, thresh=0.5, box_thresh=0.85, min_area=16, min_kernel_area=2.6,
                 scale=4, out_polygon=False, use_device_aggregate=True, **kwargs):
        self.use_device_aggregate = use_device_aggregate
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.min_area = min_area
        self.min_kernel_area = min_kernel_area / float(scale ** 2)
        self.out_polygon = out_polygon
        self.scale = scale

    def front_half(self, maps):
        """Device part: (score (N, H, W) f32, kernels (N, 2, H, W) bool,
        emb (N, 4, H, W) f32, labels (N, H, W) int32 or None)."""
        pred = as_maps(maps)
        if self.scale != 4:
            pred = resize_nearest(pred.permute(0, 3, 1, 2), 4 // self.scale).permute(0, 2, 3, 1)
        score = torch.sigmoid(pred[..., 0])
        text = pred[..., 0] > self.thresh
        kernels = torch.stack([text, (pred[..., 1] > self.thresh) & text], dim=1)
        emb = (pred[..., 2:] * text[..., None].float()).permute(0, 3, 1, 2).contiguous()
        labels = None
        if self.use_device_aggregate:
            labels = torch.stack([
                pa_aggregate_device(k, e, self.min_kernel_area) for k, e in zip(kernels, emb)
            ])
        return score, kernels, emb, labels

    def __call__(self, outs_dict, shape_list):
        maps = outs_dict["maps"]
        self.img_h, self.img_w = maps.shape[1] * 4, maps.shape[2] * 4
        score, kernels, emb, labels = self.front_half(maps)
        score = score.cpu().numpy()
        if labels is not None:
            labels = labels.cpu().numpy()
        else:
            kernels = kernels.to(torch.uint8).cpu().numpy()
            emb = emb.cpu().numpy()
        res_batch = []
        for i in range(score.shape[0]):
            if labels is not None:
                label = labels[i]
            else:
                label = pa_np(kernels[i], emb[i], self.min_kernel_area)
            boxes, scores = self.boxes_from_bitmap(score[i], label, shape_list[i])
            res_batch.append({"points": boxes, "scores": scores})
        return res_batch

    def boxes_from_bitmap(self, score, label, shape):
        if self.scale != 1:
            label = cv2.resize(label.astype(np.int32), (self.img_w, self.img_h),
                               interpolation=cv2.INTER_NEAREST)
            score = cv2.resize(score, (self.img_w, self.img_h), interpolation=cv2.INTER_NEAREST)
        return generate_box(score, label, shape, self.min_area, self.box_thresh,
                            self.out_polygon)
