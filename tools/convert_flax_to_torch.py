"""Convert a pytorchocr_tpu (JAX/orbax) checkpoint into a .pt state_dict for
the PyTorch port, pytorchocr_tpu_torch.

Reads the checkpoint with utils/save_load.py:_restore_pytree, maps pre-fusion
BiLSTM trees with migrate_fused_bilstm, builds the port's model from the same
YAML config, and passes {params, batch_stats} through the weight bridge
(pytorchocr_tpu_torch/utils/weights.py). A checkpoint that holds an int8 PTQ
`quant` collection also gets <out>.quant.pt beside the .pt: the calibrated
absmax of every `AbsMax` module by name (load it with
`pytorchocr_tpu_torch.utils.weights.load_absmax`).

Usage:
  python tools/convert_flax_to_torch.py -c configs/det/det_r18_db.yml \
      --ckpt output/det/det_r18_db/best_accuracy --out det.pt
"""

import argparse
import copy
import os
import sys

__dir__ = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.abspath(os.path.join(__dir__, "..")))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorchocr_tpu.utils.config import load_config  # noqa: E402
from pytorchocr_tpu.utils.save_load import _restore_pytree, migrate_fused_bilstm  # noqa: E402
from pytorchocr_tpu_torch.modeling import build_model  # noqa: E402
from pytorchocr_tpu_torch.postprocess import build_post_process  # noqa: E402
from pytorchocr_tpu_torch.utils.weights import (  # noqa: E402
    flax_quant_to_torch, flax_to_state_dict,
)


def port_architecture(config):
    """The Architecture section as the deploy runners build it: a CTC head
    gets its class count from the character table."""
    arch = copy.deepcopy(config["Architecture"])
    head = arch.get("Head") or {}
    if head.get("name") == "CTCHead" and "out_channels" not in head:
        post = build_post_process(config["PostProcess"], config["Global"])
        head["out_channels"] = len(post.character)
    return arch


def convert(config_path, ckpt_path, out_path):
    config = load_config(config_path)
    restored = jax.device_get(_restore_pytree(os.path.abspath(ckpt_path)))
    variables = {
        "params": migrate_fused_bilstm(restored["params"]),
        "batch_stats": restored.get("batch_stats") or {},
    }
    variables = jax.tree.map(np.asarray, variables)
    model = build_model(port_architecture(config))
    state = flax_to_state_dict(model, variables)
    torch.save(state, out_path)
    if restored.get("quant"):
        absmax = flax_quant_to_torch(model, jax.tree.map(np.asarray, restored["quant"]))
        torch.save(absmax, quant_path(out_path))
    return state


def quant_path(out_path):
    """Where `convert` writes the int8 calibration state beside `out_path`."""
    return os.path.splitext(out_path)[0] + ".quant.pt"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt", required=True, help="orbax checkpoint directory")
    parser.add_argument("--out", required=True, help="output .pt path")
    args = parser.parse_args()
    state = convert(args.config, args.ckpt, args.out)
    print("saved %d tensors to %s" % (len(state), args.out))


if __name__ == "__main__":
    main()
