"""End-to-end OCR — port of deploy/run_ocr.py: det -> sorted boxes ->
perspective crops -> rec, with every stage batched over all pages.

Usage:
  python -m pytorchocr_tpu_torch.deploy.run_ocr \
      --det_config configs/det/det_r18_db.yml --det_model_path det.pt \
      --rec_config configs/rec/rec_vgg_bilstm_ctc.yml --rec_model_path rec.pt \
      --img_path imgs/ --out_dir output/ [--device cuda]

Writes res_<name>.txt (one line per box: coords, text, prob) as the JAX CLI
does. Not ported yet: the direction classifier (--cls_*, ROADMAP.md A.5), int8
detection (--det_quant, A.9), and the result images (--show, --font_path).
"""

import argparse
from pathlib import Path

import cv2
import numpy as np

from ..utils.utility import get_part_img
from .infer_det import Deter, add_device_arg, list_images
from .infer_rec import Recer


def parse_args():
    parser = argparse.ArgumentParser(description="pytorchocr_tpu_torch end-to-end OCR")
    parser.add_argument("--det_config", type=str, required=True)
    parser.add_argument("--det_model_path", type=str, required=True)
    parser.add_argument("--rec_config", type=str, required=True)
    parser.add_argument("--rec_model_path", type=str, required=True)
    parser.add_argument("--character_dict_path", type=str, default=None)
    parser.add_argument("--img_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str)
    add_device_arg(parser)
    return parser.parse_args()


def crop_lines(img, boxes):
    """Perspective crops of `boxes` out of a BGR page; tall crops turn 90°."""
    parts = []
    for box in boxes:
        part = get_part_img(img, np.asarray(box, dtype=np.float32))
        h, w = part.shape[:2]
        if h >= 1.5 * w:
            part = np.rot90(part, 1)
        parts.append(part)
    return parts


class OCRer:
    def __init__(self, det_config, det_model_path, rec_config, rec_model_path,
                 character_dict_path=None, device="cuda", dtype=None):
        self.deter = Deter(det_config, det_model_path, device=device, dtype=dtype)
        self.recer = Recer(rec_config, rec_model_path, character_dict_path,
                           device=device, dtype=dtype)

    def run(self, img_path):
        img = cv2.imdecode(np.fromfile(str(img_path), dtype=np.uint8), cv2.IMREAD_COLOR)
        boxes = self.deter.run(img)
        rec = self.recer.run_batch(crop_lines(img, boxes))
        return [[np.asarray(box), text, prob] for box, (text, prob) in zip(boxes, rec)]

    def run_many(self, img_paths):
        """One padded det forward per page-shape bucket, then one rec batch
        over the text lines of all pages. Returns one result list per page,
        in the format of run()."""
        imgs = [
            cv2.imdecode(np.fromfile(str(p), dtype=np.uint8), cv2.IMREAD_COLOR)
            for p in img_paths
        ]
        boxes_per_page = self.deter.run_batch(imgs)
        parts = []
        for img, boxes in zip(imgs, boxes_per_page):
            parts.extend(crop_lines(img, boxes))
        rec = iter(self.recer.run_batch(parts))
        return [
            [[np.asarray(box), *next(rec)] for box in boxes]
            for boxes in boxes_per_page
        ]


def main():
    args = parse_args()
    ocrer = OCRer(args.det_config, args.det_model_path, args.rec_config,
                  args.rec_model_path, args.character_dict_path, device=args.device)
    img_paths = list_images(args.img_path)
    out_dir = Path(args.out_dir or "./output")
    out_dir.mkdir(exist_ok=True, parents=True)
    for img_path, ocr_res in zip(img_paths, ocrer.run_many([str(p) for p in img_paths])):
        with open(out_dir / ("res_%s.txt" % img_path.stem), "w", encoding="UTF-8") as fp:
            for box, text, prob in ocr_res:
                row = [str(v) for v in box.reshape(-1).tolist()] + [text, str(prob)]
                fp.write(",".join(row) + "\n")
        if not ocr_res:
            print("[info] 0 text boxes detected in {}".format(img_path))


if __name__ == "__main__":
    main()
