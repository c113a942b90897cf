"""Check RepVGG's deploy fold on a trained checkpoint — port of
tools/check_repvgg_deploy.py.

Loads the train-form model from Global.checkpoints, folds every block's
dense 3x3 + 1x1 + identity-BN branches into one `reparam` conv
(modeling/backbones/det_repvgg.reparameterize_state_dict, in float64 on the
CPU), loads the fold into the same architecture built with
`Backbone.deploy: True`, and compares the two models' prob maps on the first
`Global.deploy_check_batches` (default 4) eval batches. It prints
`REPVGG_DEPLOY_PARITY OK|FAIL max_abs=...` and exits 1 when the largest
|prob_train - prob_deploy| passes `Global.deploy_check_tol` (default 0.05,
the JAX tool's: the fold is exact in float64, and float32 / bf16 reorder the
BN scaling across the stacked blocks).

Usage:
  python -m pytorchocr_tpu_torch.tools.check_repvgg_deploy \
      -c configs/det/det_repvgg_db_synth.yml \
      -o Global.checkpoints=./output/quality/det_repvgg_db_synth/best_accuracy \
         Global.device_normalize=False
"""

import copy
import sys

import numpy as np
import torch

from ..data import build_dataloader
from ..modeling import build_model
from ..modeling.backbones.det_repvgg import reparameterize_state_dict
from ..trainer import build_input_transform, make_eval_step
from ..utils.save_load import load_model
from . import program
from .train import build_train_model


def deploy_model(config, model, device):
    """The architecture of `config` with `Backbone.deploy: True`, holding the
    fold of the train-form `model`, on `device` (channels_last on a card)."""
    arch = copy.deepcopy(config["Architecture"])
    arch["Backbone"]["deploy"] = True
    folded = build_model(arch)
    folded.load_state_dict(reparameterize_state_dict(model), strict=True)
    folded = folded.to(device)
    if device.type == "cuda":
        folded = folded.to(memory_format=torch.channels_last)
    return folded


def main(config, device, logger, tsb_writer=None):
    global_config = config["Global"]
    valid_dataloader, _ = build_dataloader(config, "Eval", logger, seed=global_config.get("seed"))
    model = build_train_model(config, device)
    load_model(config, model, None, logger)
    model.eval()
    amp = bool(global_config.get("use_amp", False))
    transform = build_input_transform(global_config.get("_device_normalize_spec", {}).get("Eval"))
    eval_train_form = make_eval_step(model, input_transform=transform, amp=amp)
    eval_deploy_form = make_eval_step(deploy_model(config, model, device),
                                      input_transform=transform, amp=amp)

    n, max_abs, max_rel = 0, 0.0, 0.0
    for i, batch in enumerate(valid_dataloader):
        if i >= int(global_config.get("deploy_check_batches", 4)):
            break
        images = torch.from_numpy(batch[0]).to(device)
        a = eval_train_form(images)["maps"].float().cpu().numpy()
        d = eval_deploy_form(images)["maps"].float().cpu().numpy()
        max_abs = max(max_abs, float(np.max(np.abs(a - d))))
        max_rel = max(max_rel, float(np.max(np.abs(a - d) / np.maximum(np.abs(a), 1e-3))))
        n += 1

    tol = float(global_config.get("deploy_check_tol", 0.05))
    ok = max_abs <= tol
    logger.info("repvgg deploy-parity on the checkpoint: %d batches, max|prob_train - "
                "prob_deploy| = %.5f (rel %.4f), tol %.3f -> %s",
                n, max_abs, max_rel, tol, "OK" if ok else "FAIL")
    print("REPVGG_DEPLOY_PARITY %s max_abs=%.5f" % ("OK" if ok else "FAIL", max_abs))
    return ok, max_abs


def run(argv=None):
    return main(*program.preprocess(is_train=False, argv=argv))


if __name__ == "__main__":
    sys.exit(0 if run()[0] else 1)
