"""Export a model's eval forward as a file — port of deploy/export_model.py.

  # export (shapes fixed at export time, as in the JAX package)
  python -m pytorchocr_tpu_torch.deploy.export_model --config configs/det/det_r18_db.yml \
      --model_path output/det_r18_db/best_accuracy --shape 1,736,1280,3 --out det_r18_db.pt2

  # load the file and time one warm call
  python -m pytorchocr_tpu_torch.deploy.export_model --run det_r18_db.pt2 --shape 1,736,1280,3

The JAX CLI serializes an XLA executable with jax.export; this one traces
the forward with torch.export into a .pt2 file (deploy/common.py:
`export_program`, `save_program`, `load_program`). The exported function
takes float32 NHWC images, as the JAX one does (no normalisation), and
returns the maps (det) or the head's output (rec, cls) in the compute dtype:
bf16 autocast on the card, as the JAX package builds its deploy models in
bf16; float32 on the CPU. A rec config's head takes
`out_channels` from its post process's character table, as there.
"""

import argparse
import subprocess
import time

import torch

from ..postprocess import build_post_process
from ..utils.config import load_config
from .common import build_runner, export_program, load_program, save_program
from .infer_det import add_device_arg

def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="pytorchocr_tpu_torch model export")
    parser.add_argument("--config", type=str)
    parser.add_argument("--model_path", type=str)
    parser.add_argument("--shape", type=str, default="1,736,1280,3",
                        help="NHWC input shape, comma separated")
    parser.add_argument("--out", type=str, default="model.pt2")
    parser.add_argument("--run", type=str, default=None,
                        help="load an exported .pt2 file and time one warm call")
    add_device_arg(parser)
    return parser.parse_args(argv)


def export(config_path, model_path, shape, out_path, device="cuda", dtype=None):
    """Build, load and export the config's model in `dtype` (the Runner's
    default when None); returns the file's size in bytes."""
    config = load_config(config_path)
    config["Global"]["distributed"] = False
    post = build_post_process(config["PostProcess"], config["Global"])
    if hasattr(post, "character"):
        config["Architecture"]["Head"]["out_channels"] = len(post.character)
    runner = build_runner(config, model_path, device, dtype=dtype)
    size = save_program(export_program(runner.model, shape, runner.device, runner.dtype),
                        out_path)
    print("exported %s (%.2f MB) for input %s, %s" % (out_path, size / 1e6, shape,
                                                      str(runner.dtype).split(".")[-1]))
    return size


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def run(path, shape, device="cuda"):
    """Load the file, make one call to warm it, then time one call. Returns
    (output, ms)."""
    fn = load_program(path)
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    with torch.no_grad():
        fn(x)
        sync()
        t0 = time.perf_counter()
        out = fn(x)
        sync()
    ms = (time.perf_counter() - t0) * 1e3
    where = card_line() if torch.device(device).type == "cuda" else "the CPU"
    print("ran %s: output %s %s in %.2f ms on %s" % (
        path, tuple(out.shape), str(out.dtype).split(".")[-1], ms, where))
    return out, ms


def main(argv=None):
    args = parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    if args.run:
        run(args.run, shape, args.device)
    else:
        if not (args.config and args.model_path):
            raise SystemExit("--config and --model_path required")
        export(args.config, args.model_path, shape, args.out, args.device)


if __name__ == "__main__":
    main()
