"""Detection inference — port of deploy/infer_det.py.

Usage:
  python -m pytorchocr_tpu_torch.deploy.infer_det --config configs/det/det_r18_db.yml \
      --model_path det.pt --img_path imgs/ --out_dir output/ [--quant --calib_n 8]

`--quant`: int8 PTQ detection (ops/quant.py), calibrated on the first
`--calib_n` input images (sorted by name) before inference. Writes
res_<name>.txt (one line of box coordinates a box) and res_<name>.jpg (the
boxes drawn on the page; `--show` shows it where a display is).
"""

import argparse
import os
from pathlib import Path

import cv2
import numpy as np

from ..data import create_operators, transform
from ..postprocess import build_post_process
from ..utils.config import load_config
from ..utils.utility import sort_boxes
from ..ops import quant as _quant
from .common import build_runner, padded_pow2_batch
from .utils import draw_det_res, show_image

MAX_BS = 16


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no card is present")


def list_images(img_path):
    if not os.path.exists(img_path):
        raise FileNotFoundError(img_path)
    if os.path.isfile(img_path):
        return [Path(img_path)]
    return sorted(Path(img_path).glob("*.[jp][pn]g"))


def parse_args():
    parser = argparse.ArgumentParser(description="pytorchocr_tpu_torch det_model infer")
    parser.add_argument("--config", type=str, help="configuration file to use")
    parser.add_argument("--model_path", type=str,
                        help=".pt state_dict or training checkpoint directory (OUT/best_accuracy)")
    parser.add_argument("--img_path", type=str, help="test img-path or img-dir")
    parser.add_argument("--out_dir", type=str, help="output directory")
    parser.add_argument("--quant", action="store_true",
                        help="int8 PTQ inference, calibrated on the first --calib_n images")
    parser.add_argument("--calib_n", type=int, default=8,
                        help="number of input images used for int8 calibration")
    parser.add_argument("--show", action="store_true", help="show results")
    add_device_arg(parser)
    return parser.parse_args()


class Deter:
    """Detection over decoded pages. With `quant`, the forward runs int8
    PTQ, calibrated by `calibrate_on` or, lazily, on the pages of the first
    call (`run`: its page; `run_batch`: the first half of its pages), as the
    JAX Deter does."""

    def __init__(self, det_cfg, det_ckpt, device="cuda", dtype=None, quant=False):
        self._want_quant = quant
        det_cfg = load_config(det_cfg)
        det_cfg["Global"]["distributed"] = False
        self.det_post_process_class = build_post_process(
            det_cfg["PostProcess"], det_cfg["Global"]
        )
        # Eval ops minus label ops, KeepKeys -> [image, shape]; ToTensor and
        # Normalize are folded into the device forward (Runner mean/std)
        det_transforms = []
        self.det_img_mode = "RGB"
        mean = std = None
        saw_totensor = False
        for op in det_cfg["Eval"]["dataset"]["transforms"]:
            op_name = list(op)[0]
            if "DecodeImage" in op_name:
                self.det_img_mode = op[op_name]["img_mode"]
                continue
            if "Label" in op_name:
                continue
            if op_name == "ToTensor":
                saw_totensor = True
                continue
            if op_name == "Normalize":
                mean, std = op[op_name]["mean"], op[op_name]["std"]
                continue
            if op_name == "KeepKeys":
                op[op_name]["keep_keys"] = ["image", "shape"]
            det_transforms.append(op)
        if saw_totensor and mean is None:
            mean, std = [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]  # bare /255
        self.det_ops = create_operators(det_transforms, det_cfg["Global"])
        self.runner = build_runner(det_cfg, det_ckpt, device, mean=mean, std=std,
                                   dtype=dtype)
        reason = _quant.unsupported(self.runner.model) if quant else None
        if reason:
            raise NotImplementedError(reason)

    def _preprocess(self, img):
        """A path or an already-decoded BGR array -> (1, H, W, C) image and
        its (1, 4) shape row."""
        if not isinstance(img, np.ndarray):
            img = cv2.imdecode(np.fromfile(str(img), dtype=np.uint8), cv2.IMREAD_COLOR)
        if self.det_img_mode == "RGB":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            img = img.copy()
        det_batch = transform({"image": img}, self.det_ops)
        return det_batch[0][None], np.expand_dims(det_batch[1], axis=0)

    def calibrate_on(self, imgs):
        """int8 calibration over a sample of pages (paths or BGR arrays):
        running absmax across all of them."""
        batches = [self._preprocess(im)[0] for im in imgs]
        if batches:
            self.runner.calibrate(batches)

    def run(self, img):
        det_img, shape_list = self._preprocess(img)
        if self._want_quant and not self.runner.quant:
            self.runner.calibrate([det_img])
        post = self.det_post_process_class(self.runner(det_img), shape_list)
        return sort_boxes(post[0]["points"])

    def run_batch(self, imgs):
        """Batched detection over decoded BGR arrays: one forward per distinct
        post-resize shape (in chunks of MAX_BS, padded to a power of two).
        Returns one sorted box array per image, in input order."""
        pre = [self._preprocess(im) for im in imgs]
        if pre and self._want_quant and not self.runner.quant:
            self.runner.calibrate([p[0] for p in pre[: max(1, len(pre) // 2)]])
        groups = {}
        for i, (det_img, _) in enumerate(pre):
            groups.setdefault(det_img.shape, []).append(i)
        results = [None] * len(imgs)
        for idxs in groups.values():
            for c in range(0, len(idxs), MAX_BS):
                chunk = idxs[c : c + MAX_BS]
                det_imgs, _ = padded_pow2_batch([pre[i][0] for i in chunk],
                                                combine=np.concatenate)
                shape_list, _ = padded_pow2_batch([pre[i][1] for i in chunk],
                                                  combine=np.concatenate)
                post = self.det_post_process_class(self.runner(det_imgs), shape_list)
                for j, i in enumerate(chunk):
                    results[i] = sort_boxes(post[j]["points"])
        return results


def main():
    args = parse_args()
    deter = Deter(args.config, args.model_path, device=args.device, quant=args.quant)
    out_dir = Path(args.out_dir or "./output")
    out_dir.mkdir(exist_ok=True, parents=True)
    img_paths = list_images(args.img_path)
    if args.quant:
        deter.calibrate_on([str(p) for p in img_paths[: max(args.calib_n, 1)]])
    for img_path in img_paths:
        boxes = deter.run(str(img_path))
        with open(out_dir / ("res_%s.txt" % img_path.stem), "w", encoding="UTF-8") as fp:
            for box in boxes:
                fp.write(",".join(str(v) for v in np.asarray(box).reshape(-1).tolist()) + "\n")
        res_img = draw_det_res(boxes, str(img_path), str(out_dir / ("res_%s.jpg" % img_path.stem)))
        if args.show:
            show_image("det_res", res_img)


if __name__ == "__main__":
    main()
