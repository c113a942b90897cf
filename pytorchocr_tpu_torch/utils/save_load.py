"""Checkpoint save/load — port of pytorchocr_tpu/utils/save_load.py
(`_swap_dirs` :37, `save_model` :69, `load_model` :105,
`load_backbone_pretrained` :231, `load_submodel_pretrained` :264,
`load_pretrained_params` :305).

A checkpoint prefix (latest / best_accuracy / epoch_N) is a directory holding
`state.pt` (torch.save of the model's state_dict, the optimizer's state_dict
and the step) and `global_state.json` ({start_epoch, best_model,
global_step}), the JAX checkpoint's two parts. It is written into
`<prefix>.staging` and swapped in (`_swap_dirs`), so a crash mid-save leaves
the previous `<prefix>` or `<prefix>.old` whole, never a half-written one.
Across ranks (tools/program.py under torchrun) rank 0 alone writes
(`save_model` returns at once on the others, and the training loop's
barrier after each save holds them until the directory is whole); every
rank reads a checkpoint to resume, and a checkpoint written by N ranks
loads in one process (the model is not wrapped, so its names are its own).
`pretrained_model` and the backbone's `ckpt_path` load parameters only, by
name and shape, from a port checkpoint directory or a `.pt` state_dict (the
JAX package reads orbax directories, which the port cannot).
"""

import json
import os
import shutil

import torch

from .logging import get_logger, process_rank

STATE_FILE = "state.pt"


def _swap_dirs(staging, path):
    """Replace directory `path` with `staging`, never leaving a window with
    neither present: path -> path.old, staging -> path, drop path.old. From
    save_load.py:37."""
    old = path + ".old"
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(staging, path)
    if os.path.isdir(old):
        shutil.rmtree(old)


def save_model(model, optimizer, global_state, model_dir, logger=None, is_best=False,
               prefix="pytorchocr_tpu_torch"):
    """Save model, optimizer and global_state under model_dir/prefix/. From
    save_load.py:69."""
    if process_rank() != 0:
        return
    logger = logger or get_logger()
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(model_dir, prefix))
    staging = path + ".staging"
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": optimizer.param_groups[0].get("count", 0)},
               os.path.join(staging, STATE_FILE))
    with open(os.path.join(staging, "global_state.json"), "w") as f:
        json.dump(global_state, f)
    _swap_dirs(staging, path)
    logger.info("save %s in %s" % ("best model" if is_best else "model", path))


def _read_state(path, device):
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location=device, weights_only=True)


def model_state(path, device):
    """The model's state_dict from a checkpoint directory (its `state.pt`'s
    "model") or from a bare .pt state_dict."""
    state = _read_state(path, device)
    return state["model"] if os.path.isdir(path) else state


def load_model(config, model, optimizer=None, logger=None):
    """Resume from Global.checkpoints (model, optimizer and global_state) or
    finetune from Global.pretrained_model (parameters only). Returns
    global_state. From save_load.py:105."""
    logger = logger or get_logger()
    global_config = config["Global"]
    checkpoints = global_config.get("checkpoints")
    pretrained_model = global_config.get("pretrained_model")
    device = next(model.parameters()).device
    if checkpoints:
        path = os.path.abspath(checkpoints)
        if not os.path.isdir(path) and os.path.isdir(path + ".old"):
            logger.warning("checkpoint {} missing; falling back to {}.old (interrupted save)"
                           .format(path, path))
            path = path + ".old"
        state = _read_state(path, device)
        model.load_state_dict(state["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        global_state = {}
        gs_path = os.path.join(path, "global_state.json")
        if os.path.exists(gs_path):
            with open(gs_path) as f:
                global_state = json.load(f)
        logger.info("resume from {}".format(checkpoints))
        return global_state
    if pretrained_model:
        load_pretrained_params(model, pretrained_model, logger)
    else:
        logger.info("train from scratch")
    return {}


def _merge_into(module, source, logger, what):
    """Load the entries of `source` whose name and shape match `module`'s
    state_dict; keep the rest at init, with a warning each (the JAX
    `_merge_trees`, save_load.py:198)."""
    target = module.state_dict()
    merged = {}
    for k, v in target.items():
        if k not in source:
            logger.warning("%s missing key %s", what, k)
        elif tuple(source[k].shape) != tuple(v.shape):
            logger.warning("shape mismatch at %s: %s vs %s — keeping init", k,
                           tuple(v.shape), tuple(source[k].shape))
        else:
            merged[k] = source[k]
    module.load_state_dict(merged, strict=False)


def load_pretrained_params(model, path, logger=None):
    """Parameters (and BN statistics) of a port checkpoint or .pt state_dict
    into `model`, by name and shape. From save_load.py:305."""
    logger = logger or get_logger()
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError("The {} does not exist!".format(path))
    state = _read_state(path, next(model.parameters()).device)
    _merge_into(model, state.get("model", state), logger, "pretrained")
    logger.info("load pretrain successful from {}".format(path))
    return model


def _sub_models(model, arch_config):
    """(name, sub-model, its config) of each model of a DistillationModel,
    in the config's order; the whole model alone otherwise."""
    if "Models" not in arch_config:
        return [("model", model, arch_config)]
    return [(key, model.sub_model(key), arch_config["Models"][key])
            for key in arch_config["Models"]]


def load_backbone_pretrained(model, arch_config, logger=None):
    """Architecture.Backbone.{pretrained, ckpt_path} (each
    Architecture.Models.<Name>.Backbone's for distillation): ImageNet
    weights for the backbone, from a port checkpoint or a .pt state_dict of
    the backbone module; a missing path is logged and skipped, as in JAX.
    From save_load.py:231."""
    logger = logger or get_logger()
    for _, sub, cfg in _sub_models(model, arch_config):
        bcfg = cfg.get("Backbone") or {}
        path = bcfg.get("ckpt_path")
        if not bcfg.get("pretrained") or not path:
            continue
        if not os.path.exists(path):
            logger.info("imagenet ckpt_path not exists: %s", path)
            continue
        state = _read_state(os.path.abspath(path), next(sub.parameters()).device)
        _merge_into(sub.backbone, state.get("model", state), logger, "imagenet")
        logger.info("load imagenet weights from %s", path)
    return model


def load_submodel_pretrained(model, arch_config, logger=None):
    """Architecture.Models.<Name>.pretrained of a DistillationModel: a port
    checkpoint directory (e.g. the teacher's best_accuracy) or a .pt
    state_dict of a single model, grafted onto that model by name and shape
    (the JAX `_merge_trees`); the other models keep their init, and entries
    the model lacks (a frozen DB model's threshold tower) are left out. The
    path must exist. From save_load.py:264."""
    logger = logger or get_logger()
    if "Models" not in arch_config:
        return model
    for key, sub, cfg in _sub_models(model, arch_config):
        path = cfg.get("pretrained")
        if not path:
            continue
        path = os.path.abspath(path)
        if not os.path.exists(path):  # an AssertionError, as the JAX package's assert raises
            raise AssertionError("Models.%s.pretrained does not exist: %s" % (key, path))
        state = _read_state(path, next(sub.parameters()).device)
        _merge_into(sub, state.get("model", state), logger, "pretrained %s" % key)
        logger.info("load %s pretrained from %s", key, path)
    return model
