"""Direction-classifier inference — port of deploy/infer_cls.py.

Usage:
  python -m pytorchocr_tpu_torch.deploy.infer_cls --config configs/cls/cls_mbv3small.yml \
      --model_path cls.pt --img_path crops/ --out_dir output/ [--show]

Writes res_<name>.txt with one line `label,prob` and res_<name>.jpg (the
crop with its label drawn on it) per image, as the JAX CLI does.
"""

import argparse
from pathlib import Path

import cv2
import numpy as np

from ..data import create_operators, transform
from ..postprocess import build_post_process
from ..utils.config import load_config
from .common import build_runner, padded_pow2_batch
from .infer_det import add_device_arg, list_images
from .utils import draw_cls_res, show_image

MAX_BS = 512


def parse_args():
    parser = argparse.ArgumentParser(description="pytorchocr_tpu_torch cls_model infer")
    parser.add_argument("--config", type=str, help="configuration file to use")
    parser.add_argument("--model_path", type=str,
                        help=".pt state_dict or training checkpoint directory (OUT/best_accuracy)")
    parser.add_argument("--img_path", type=str, help="test img-path or img-dir")
    parser.add_argument("--out_dir", type=str, help="output directory")
    parser.add_argument("--show", action="store_true", help="show results")
    add_device_arg(parser)
    return parser.parse_args()


class Clser:
    def __init__(self, cls_cfg, cls_ckpt, device="cuda", dtype=None):
        cls_cfg = load_config(cls_cfg)
        cls_cfg["Global"]["distributed"] = False
        self.cls_post_process_class = build_post_process(
            cls_cfg["PostProcess"], cls_cfg["Global"]
        )
        # ClsResizeImg normalises on the host, as in JAX: no device mean/std
        cls_transforms = []
        self.cls_img_mode = "RGB"
        for op in cls_cfg["Eval"]["dataset"]["transforms"]:
            op_name = list(op)[0]
            if "DecodeImage" in op_name:
                self.cls_img_mode = op[op_name]["img_mode"]
                continue
            if "Label" in op_name:
                continue
            if op_name == "KeepKeys":
                op[op_name]["keep_keys"] = ["image"]
            cls_transforms.append(op)
        self.cls_ops = create_operators(cls_transforms, cls_cfg["Global"])
        self.runner = build_runner(cls_cfg, cls_ckpt, device, dtype=dtype)

    def _prep(self, bgr_img):
        if self.cls_img_mode == "GRAY":
            img = cv2.cvtColor(bgr_img, cv2.COLOR_BGR2GRAY)
        elif self.cls_img_mode == "RGB":
            img = cv2.cvtColor(bgr_img, cv2.COLOR_BGR2RGB)
        else:
            img = bgr_img.copy()
        return transform({"image": img}, self.cls_ops)[0]

    def run(self, img_path):
        img = cv2.imdecode(np.fromfile(str(img_path), dtype=np.uint8), cv2.IMREAD_COLOR)
        label, prob = self.cls_post_process_class(self.runner(self._prep(img)[None]))[0]
        return label, round(float(prob), 2)

    def run_batch(self, bgr_imgs):
        """Padded-batch classification over many crops (chunks of MAX_BS,
        padded to a power of two). Returns (label, prob) per crop."""
        out = []
        for c in range(0, len(bgr_imgs), MAX_BS):
            chunk = [self._prep(im) for im in bgr_imgs[c : c + MAX_BS]]
            batch, _ = padded_pow2_batch(chunk)
            res = self.cls_post_process_class(self.runner(batch))
            out.extend((label, round(float(p), 2)) for label, p in res[: len(chunk)])
        return out


def main():
    args = parse_args()
    clser = Clser(args.config, args.model_path, device=args.device)
    out_dir = Path(args.out_dir or "./output")
    out_dir.mkdir(exist_ok=True, parents=True)
    for img_path in list_images(args.img_path):
        label, prob = clser.run(str(img_path))
        with open(out_dir / ("res_%s.txt" % img_path.stem), "w", encoding="UTF-8") as fp:
            fp.write(label + "," + str(prob) + "\n")
        res_img = draw_cls_res(label, prob, str(img_path),
                               str(out_dir / ("res_%s.jpg" % img_path.stem)))
        if args.show:
            show_image("cls_res", res_img)


if __name__ == "__main__":
    main()
