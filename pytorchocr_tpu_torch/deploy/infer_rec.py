"""Recognition inference — port of deploy/infer_rec.py.

Usage:
  python -m pytorchocr_tpu_torch.deploy.infer_rec --config configs/rec/rec_vgg_bilstm_ctc.yml \
      --model_path rec.pt --img_path line.png [--show]

Writes res_<name>.txt (text,prob) and res_<name>.jpg (the line with its
text drawn on it) per image, as the JAX CLI does.
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
from .utils import draw_rec_res, show_image

MAX_BS = 512


def parse_args():
    parser = argparse.ArgumentParser(description="pytorchocr_tpu_torch rec_model infer")
    parser.add_argument("--config", type=str, help="configuration file to use")
    parser.add_argument("--model_path", type=str,
                        help=".pt state_dict or training checkpoint directory (OUT/best_accuracy)")
    parser.add_argument("--img_path", type=str, help="test img-path or img-dir")
    parser.add_argument("--character_dict_path", type=str, default=None)
    parser.add_argument("--out_dir", type=str, help="output directory")
    parser.add_argument("--show", action="store_true", help="show results")
    add_device_arg(parser)
    return parser.parse_args()


class Recer:
    def __init__(self, rec_cfg, rec_ckpt, character_dict_path=None, device="cuda",
                 dtype=None):
        rec_cfg = load_config(rec_cfg)
        rec_cfg["Global"]["distributed"] = False
        if character_dict_path is not None:
            rec_cfg["Global"]["character_dict_path"] = character_dict_path
        self.rec_post_process_class = build_post_process(
            rec_cfg["PostProcess"], rec_cfg["Global"]
        )
        rec_cfg["Architecture"]["Head"]["out_channels"] = len(
            self.rec_post_process_class.character
        )
        # the rec transforms normalise on the host (RecResizeImg), as in JAX
        rec_transforms = []
        self.rec_img_mode = "GRAY"
        for op in rec_cfg["Eval"]["dataset"]["transforms"]:
            op_name = list(op)[0]
            if "DecodeImage" in op_name:
                self.rec_img_mode = op[op_name]["img_mode"]
                continue
            if "Label" in op_name:
                continue
            if op_name == "KeepKeys":
                op[op_name]["keep_keys"] = ["image"]
            rec_transforms.append(op)
        self.rec_ops = create_operators(rec_transforms, rec_cfg["Global"])
        self.runner = build_runner(rec_cfg, rec_ckpt, device, dtype=dtype)

    def _prep(self, bgr_img):
        if self.rec_img_mode == "GRAY":
            img = cv2.cvtColor(bgr_img, cv2.COLOR_BGR2GRAY)
        elif self.rec_img_mode == "RGB":
            img = cv2.cvtColor(bgr_img, cv2.COLOR_BGR2RGB)
        else:
            img = bgr_img.copy()
        return transform({"image": img}, self.rec_ops)[0]

    def run(self, img_path):
        img = cv2.imdecode(np.fromfile(str(img_path), dtype=np.uint8), cv2.IMREAD_COLOR)
        text, prob = self.rec_post_process_class(self.runner(self._prep(img)[None]))[0]
        return text, round(float(prob), 2)

    def run_batch(self, bgr_imgs):
        """Padded-batch recognition over many line crops (chunks of MAX_BS,
        padded to a power of two)."""
        out = []
        for c in range(0, len(bgr_imgs), MAX_BS):
            chunk = [self._prep(im) for im in bgr_imgs[c : c + MAX_BS]]
            batch, _ = padded_pow2_batch(chunk)
            res = self.rec_post_process_class(self.runner(batch))
            out.extend((text, round(float(p), 2)) for text, p in res[: len(chunk)])
        return out


def main():
    args = parse_args()
    recer = Recer(args.config, args.model_path, args.character_dict_path, device=args.device)
    out_dir = Path(args.out_dir or "./output")
    out_dir.mkdir(exist_ok=True, parents=True)
    for img_path in list_images(args.img_path):
        text, prob = recer.run(str(img_path))
        with open(out_dir / ("res_%s.txt" % img_path.stem), "w", encoding="UTF-8") as fp:
            fp.write(text + "," + str(prob) + "\n")
        res_img = draw_rec_res(text, prob, str(img_path),
                               str(out_dir / ("res_%s.jpg" % img_path.stem)))
        if args.show:
            show_image("rec_res", res_img)


if __name__ == "__main__":
    main()
