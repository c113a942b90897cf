"""Standalone evaluation — port of tools/eval.py.

Usage:
  python -m pytorchocr_tpu_torch.tools.eval -c configs/det/det_r18_db_synth.yml \
      -o Global.checkpoints=./output/quality/det_r18_db_synth/best_accuracy

int8 PTQ evaluation: `-o Global.quant=true [Global.quant_calib_n=8]`
calibrates on the first `quant_calib_n` eval batches (ops/quant.py), then
evaluates in int8 mode. `Global.metric_json=path` writes the metric and its
provenance as JSON.
"""

import contextlib
import datetime
import json
import os

import torch

from ..data import build_dataloader
from ..metrics import build_metric
from ..ops import quant
from ..postprocess import build_post_process
from ..trainer import build_input_transform, make_eval_step
from ..utils.save_load import load_model
from . import program
from .train import build_train_model


def main(config, device, logger, tsb_writer=None):
    global_config = config["Global"]
    valid_dataloader, _ = build_dataloader(config, "Eval", logger, seed=global_config.get("seed"))
    post_process_class = build_post_process(config["PostProcess"], global_config)
    model = build_train_model(config, device)
    load_model(config, model, None, logger)
    eval_step = make_eval_step(
        model, input_transform=build_input_transform(
            global_config.get("_device_normalize_spec", {}).get("Eval")),
        amp=bool(global_config.get("use_amp", False)))

    quant_ctx = contextlib.nullcontext()
    if global_config.get("quant", False):
        calib_n = int(global_config.get("quant_calib_n", 8))
        calib = []
        for i, b in enumerate(valid_dataloader):
            calib.append(torch.from_numpy(b[0]).to(device))
            if i + 1 >= calib_n:
                break
        logger.info("int8 PTQ: calibrating on %d eval batches", len(calib))
        quant.calibrate(model, calib, forward=eval_step)
        quant_ctx = quant.quantized(model, "int8")
    with quant_ctx:
        metric = program.evaluate(eval_step, valid_dataloader, post_process_class,
                                  build_metric(config["Metric"]),
                                  config["Architecture"].get("model_type"), device)
    logger.info("metric eval ***************\n%s",
                "\n".join("{}: {}".format(k, v) for k, v in metric.items()))

    metric_json = global_config.get("metric_json")
    if metric_json:
        payload = {
            "metric": {k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metric.items()},
            "config": global_config.get("_config_path"),
            "checkpoints": global_config.get("checkpoints"),
            "quant": bool(global_config.get("quant", False)),
            "eval_label_file_list": config.get("Eval", {}).get("dataset", {})
            .get("label_file_list"),
            "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        }
        os.makedirs(os.path.dirname(metric_json) or ".", exist_ok=True)
        with open(metric_json, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        logger.info("metric json written to %s", metric_json)
    return metric


def run(argv=None):
    return main(*program.preprocess(is_train=False, argv=argv))


if __name__ == "__main__":
    run()
