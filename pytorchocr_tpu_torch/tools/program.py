"""The training loop — port of tools/program.py (`extract_device_normalize`
:78, `preprocess` :114, `train` :291, `evaluate` :771-897).

The loop, the eval gate (`eval_epoch_step`), the HighestAcc / FixedEpochStep
checkpoints, the median-smoothed stats and the rank-0-only side effects are
the JAX loop's. A train step is trainer.make_train_step on one card; the
losses stay on the card and are read only at log steps, as the JAX loop
fetches them. `Global.cal_metric_during_train` (rec and cls) runs the eval
forward on each train batch after its step, then the post process and the
metric, every step, as the JAX loop does (:605-613); the post process reads
the predictions on the host, so that step waits for the card.

Not carried over (ROADMAP.md A.15): `steps_per_dispatch`, the bf16 "wire
dtype" (the port sends uint8 images and float32 label maps to the card),
`StallWatchdog`, the save-hang and host-RSS re-exec watchdogs
(`_resume_reexec`), `Global.use_profiler`, and the XLA compile cache.
`use_tensorboard` writes through torch.utils.tensorboard when it imports,
else nothing, as the JAX writer does without tensorflow.
"""

import os
import random
import time

import numpy as np
import torch

from ..trainer import (batch_to_device, build_input_transform, make_eval_step,
                       make_train_step, set_matmul_precision)
from ..utils.config import ArgsParser, load_config, merge_config, save_config
from ..utils.logging import get_logger, print_dict, process_rank
from ..utils.save_load import save_model
from ..utils.stats import TrainingStats

SUPPORTED_ALGS = ["DB", "PSE", "PAN", "CRNN", "CLS"]
_LATER_ALGS = {"STARNet": "A.11",
               "Distillation": "A.12", "SLANet": "A.13"}


def set_random_seed(seed):
    """Seed Python's random, numpy's and torch's generators. From
    program.py:46."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class TensorboardWriter:
    """Scalar writer through torch.utils.tensorboard; writes nothing when
    that does not import. From program.py:54."""

    def __init__(self, logdir):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except Exception:
            self._writer = None

    def add_scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._writer is not None:
            self._writer.close()


def extract_device_normalize(config):
    """Strip trailing host ToTensor/Normalize/NormalizeImage from the Train
    and Eval transform lists and record their params in
    Global._device_normalize_spec for trainer.build_input_transform. From
    program.py:78."""
    norm_ops = ("ToTensor", "Normalize", "NormalizeImage")
    specs = {}
    for mode in ("Train", "Eval"):
        tlist = config.get(mode, {}).get("dataset", {}).get("transforms") or []
        names = [next(iter(e)) for e in tlist]
        norm_idx = [i for i, n in enumerate(names) if n in norm_ops]
        if not norm_idx:
            continue
        # only TRAILING norm ops: an image op after Normalize would see
        # normalized floats on the host but raw uint8 here
        if any(n not in norm_ops and n != "KeepKeys" for n in names[norm_idx[0]:]):
            get_logger().warning(
                "device_normalize: %s transforms have image ops after %s — "
                "leaving them on host for this mode", mode, names[norm_idx[0]])
            continue
        config[mode]["dataset"]["transforms"] = [
            e for i, e in enumerate(tlist) if i not in norm_idx]
        specs[mode] = [{"op": names[i], "params": tlist[i][names[i]]} for i in norm_idx]
    config["Global"]["_device_normalize_spec"] = specs
    return specs


def select_device(global_config):
    """Global.use_gpu: True -> the first card, and no card raises; False ->
    the CPU."""
    if not global_config.get("use_gpu", True):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("Global.use_gpu is True but torch.cuda.is_available() is False; "
                           "pass -o Global.use_gpu=False to run on the CPU")
    return torch.device("cuda:0")


def preprocess(is_train=False, argv=None):
    """Parse `-c cfg.yml -o K=v`, load and merge the config, set up logging,
    the device, seeds and TF32. Returns (config, device, logger,
    tsb_writer). From program.py:114."""
    args = ArgsParser().parse_args(argv)
    config = load_config(args.config)
    merge_config(config, args.opt)
    global_config = config["Global"]
    global_config["_config_path"] = args.config

    log_file = None
    if is_train:
        save_model_dir = global_config["save_model_dir"]
        os.makedirs(save_model_dir, exist_ok=True)
        save_config(config, os.path.join(save_model_dir, "config.yml"))
        log_file = "{}/train.log".format(save_model_dir)
    logger = get_logger(name="root", log_file=log_file)

    alg = config["Architecture"]["algorithm"]
    if alg in _LATER_ALGS:
        raise NotImplementedError("training %s is not ported yet (ROADMAP.md %s)"
                                  % (alg, _LATER_ALGS[alg]))
    if alg not in SUPPORTED_ALGS:
        raise ValueError("algorithm must be in {}".format(SUPPORTED_ALGS))

    if global_config.get("device_normalize", False):
        extract_device_normalize(config)

    device = select_device(global_config)
    if global_config.get("distributed", False):
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if world == 1:
            logger.info("Global.distributed: True with one process: training runs as a single "
                        "process (multi-GPU data parallel is ROADMAP.md A.8)")
        global_config["distributed"] = world > 1

    tsb_writer = None
    if global_config.get("use_tensorboard", False) and process_rank() == 0:
        tsb_path = "{}/tensorboard/".format(global_config["save_model_dir"])
        os.makedirs(tsb_path, exist_ok=True)
        tsb_writer = TensorboardWriter(tsb_path)

    set_random_seed(global_config.get("seed", 2022))
    set_matmul_precision()
    print_dict(config, logger)
    logger.info("train with torch {} on {} ({}); TF32 off for cuDNN and cuBLAS; {}".format(
        torch.__version__, device,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "host",
        "bf16 autocast (use_amp)" if global_config.get("use_amp") else "float32"))
    return config, device, logger, tsb_writer


def train(config, device, train_dataloader, valid_dataloader, model, loss_class, optimizer,
          global_state, post_process_class, eval_class, logger, tsb_writer=None):
    """The epoch loop with eval and checkpoints. Returns a report: steps,
    samples, the wall, loader-wait, copy and per-step metric seconds of the
    train iterations, and every step's loss (one sync at the end). From
    program.py:291."""
    global_config = config["Global"]
    cal_metric_during_train = global_config.get("cal_metric_during_train", False)
    log_smooth_window = global_config["log_smooth_window"]
    epoch_num = global_config["epoch_num"]
    print_batch_step = global_config["print_batch_step"]
    eval_epoch_step = global_config["eval_epoch_step"]
    amp = bool(global_config.get("use_amp", False))
    rank0 = process_rank() == 0

    main_indicator = eval_class.main_indicator
    if global_state:
        best_model_dict = global_state["best_model"]
        start_epoch = global_state["start_epoch"]
        global_step = global_state["global_step"]
    else:
        best_model_dict = {main_indicator: 0}
        start_epoch = 0
        global_step = 0

    start_eval_step = 0
    if isinstance(eval_epoch_step, (list, tuple)) and len(eval_epoch_step) >= 2:
        start_eval_step, eval_epoch_step = eval_epoch_step[0], eval_epoch_step[1]
        if rank0:
            if valid_dataloader is None or len(valid_dataloader) == 0:
                logger.info("No Images in eval dataset, evaluation during training will be "
                            "disabled")
                start_eval_step = 1e111
            logger.info("During the training process, after the {}th epoch, an evaluation is "
                        "run every {} epochs".format(start_eval_step, eval_epoch_step))

    ckpt_save_type = global_config["ckpt_save_type"]
    save_epoch_step = global_config["save_epoch_step"]
    save_model_dir = global_config["save_model_dir"]
    os.makedirs(save_model_dir, exist_ok=True)
    train_stats = TrainingStats(log_smooth_window, ["lr"])
    model_type = config["Architecture"].get("model_type", None)

    dn_spec = global_config.get("_device_normalize_spec", {})
    frozen = ()
    freeze_tf_epochs = int(global_config.get("freeze_transform_epochs", 0))
    if freeze_tf_epochs > 0:
        frozen = (("transform", freeze_tf_epochs * len(train_dataloader)),)
    train_step = make_train_step(model, loss_class, optimizer,
                                 input_transform=build_input_transform(dn_spec.get("Train")),
                                 amp=amp, frozen=frozen)
    eval_step = make_eval_step(model, input_transform=build_input_transform(dn_spec.get("Eval")),
                               amp=amp)

    def state(epoch):
        global_state["start_epoch"] = epoch + 1  # resume AFTER this epoch
        global_state["best_model"] = best_model_dict
        global_state["global_step"] = global_step
        return global_state

    loss_window = []  # device loss dicts, read at log steps only
    history = []  # every step's device loss, read once at the end
    # reader_s: waits on the loader; copy_s: the host-to-device copies of the
    # batches, which also wait for the step before them on the stream;
    # metric_s: cal_metric_during_train's eval forward, post process and
    # metric, which wait for the step
    report = dict(steps=0, samples=0, wall_s=0.0, reader_s=0.0, copy_s=0.0, metric_s=0.0)

    def drain_loss_window():
        for losses_dev, lr_val in loss_window:
            stats = {k: float(v) for k, v in losses_dev.items()}
            stats["lr"] = lr_val
            train_stats.update(stats)
        loss_window.clear()

    for epoch in range(start_epoch, epoch_num):
        train_dataloader.set_epoch(epoch)
        train_reader_cost = train_run_cost = 0.0
        total_samples = 0
        epoch_start = reader_start = time.time()
        for idx, batch_np in enumerate(train_dataloader):
            train_start = time.time()
            wait = train_start - reader_start
            train_reader_cost += wait
            report["reader_s"] += wait
            batch = batch_to_device(batch_np, device)
            report["copy_s"] += time.time() - train_start
            lr = optimizer.current_lr()
            losses = train_step(batch)
            history.append(losses["loss"])
            loss_window.append((losses, lr))
            if len(loss_window) > log_smooth_window:
                loss_window.pop(0)
            train_run_cost += time.time() - train_start
            total_samples += len(batch_np[0])
            report["samples"] += len(batch_np[0])

            if cal_metric_during_train and model_type != "det":
                metric_start = time.time()
                post_result = post_process_class(eval_step(batch[0]), batch_np[1])
                eval_class(post_result, batch_np)
                train_stats.update(eval_class.get_metric())
                report["metric_s"] += time.time() - metric_start

            if rank0 and ((global_step > 0 and global_step % print_batch_step == 0)
                          or idx == len(train_dataloader) - 1):
                drain_loss_window()
                if tsb_writer is not None:
                    for k, v in train_stats.get().items():
                        tsb_writer.add_scalar("TRAIN/{}".format(k), v, global_step)
                logger.info(
                    "epoch: [{}/{}], iter: {}, {}, reader_cost: {:.5f} s, batch_cost: {:.5f} s, "
                    "samples: {}, ips: {:.5f}".format(
                        epoch + 1, epoch_num, global_step, train_stats.log(),
                        train_reader_cost / print_batch_step,
                        (train_reader_cost + train_run_cost) / print_batch_step, total_samples,
                        total_samples / (train_reader_cost + train_run_cost + 1e-9)))
                train_reader_cost = train_run_cost = 0.0
                total_samples = 0
            global_step += 1
            report["steps"] += 1
            reader_start = time.time()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["wall_s"] += time.time() - epoch_start

        if rank0 and epoch + 1 > start_eval_step and \
                (epoch - start_eval_step + 1) % eval_epoch_step == 0:
            cur_metric = evaluate(eval_step, valid_dataloader, post_process_class, eval_class,
                                  model_type, device)
            logger.info("cur metric, {}".format(
                ", ".join("{}: {}".format(k, v) for k, v in cur_metric.items())))
            if tsb_writer is not None:
                for k, v in cur_metric.items():
                    if isinstance(v, (float, int)):
                        tsb_writer.add_scalar("EVAL/{}".format(k), v, global_step)
            if cur_metric[main_indicator] >= best_model_dict[main_indicator]:
                best_model_dict.update(cur_metric)
                best_model_dict["best_model_epoch"] = epoch + 1
                save_model(model, optimizer, state(epoch), save_model_dir, logger,
                           is_best=True, prefix="best_accuracy")
            logger.info("best metric, {}".format(
                ", ".join("{}: {}".format(k, v) for k, v in best_model_dict.items())))
            if tsb_writer is not None:
                tsb_writer.add_scalar("EVAL/best_{}".format(main_indicator),
                                      best_model_dict[main_indicator], global_step)

        if rank0 and ((epoch + 1) % int(global_config.get("save_latest_epoch_step", 1)) == 0
                      or epoch + 1 == epoch_num):
            save_model(model, optimizer, state(epoch), save_model_dir, logger,
                       is_best=False, prefix="latest")
        if ckpt_save_type == "FixedEpochStep" and (epoch + 1) % save_epoch_step == 0:
            save_model(model, optimizer, state(epoch), save_model_dir, logger,
                       is_best=False, prefix="epoch_{}".format(epoch))

    if rank0:
        logger.info("best metric, {}".format(
            ", ".join("{}: {}".format(k, v) for k, v in best_model_dict.items())))
        if tsb_writer is not None:
            tsb_writer.close()
    report["losses"] = torch.stack(history).float().cpu().tolist() if history else []
    report["best"] = dict(best_model_dict)
    return report


def _first_rows(preds, n):
    """The first `n` samples of a batch of predictions (a tensor, or a dict
    or tuple of them)."""
    if torch.is_tensor(preds):
        return preds[:n]
    if isinstance(preds, dict):
        return {k: _first_rows(v, n) for k, v in preds.items()}
    if isinstance(preds, (list, tuple)):
        return type(preds)(_first_rows(v, n) for v in preds)
    return preds


def _slice_post(post_result, j):
    """One sample of a batched postprocess output as a length-1 batch. From
    program.py:771."""
    if isinstance(post_result, dict):
        return {k: v[j : j + 1] for k, v in post_result.items()}
    if isinstance(post_result, tuple):
        return tuple(v[j : j + 1] for v in post_result)
    return post_result[j : j + 1]


MAX_EVAL_BS = 16


def evaluate(eval_step, valid_dataloader, post_process_class, eval_class, model_type=None,
             device="cpu"):
    """Eval loop. From program.py:785.

    Batch-size-1 loaders (det eval): samples are grouped by exact
    post-resize shape and forwarded in padded-pow2 batches of up to 16; the
    postprocess of chunk k runs after chunk k+1's forward has been queued,
    on the chunk's own rows only: the padding rows, copies of its first
    page, would repeat that page's front half (DB, PAN: K1; PSE: K1 and a
    K2 fixpoint per kernel level) for nothing, which the JAX loop pays.
    On one CUDA stream the postprocess's device front half (K1) queues behind
    that forward, so what overlaps is the host: the next forward's launches
    and the previous chunk's host tail. The metric is fed per sample in input
    order. Pre-batched loaders take the per-batch path."""
    import itertools

    batch_iter = iter(valid_dataloader)
    first = next(batch_iter, None)
    if first is None:
        return eval_class.get_metric()
    if np.asarray(first[0]).shape[0] != 1 or model_type == "table":
        total_frame = total_time = 0.0
        for batch_np in itertools.chain([first], batch_iter):
            start = time.time()
            preds = eval_step(torch.from_numpy(np.asarray(batch_np[0])).to(device))
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            total_time += time.time() - start
            eval_class(post_process_class(preds, batch_np[1]), batch_np)
            total_frame += len(batch_np[0])
        metric = eval_class.get_metric()
        metric["fps"] = total_frame / max(total_time, 1e-9)
        return metric

    samples = [first] + list(batch_iter)
    groups = {}
    for i, b in enumerate(samples):
        groups.setdefault(np.asarray(b[0]).shape[1:], []).append(i)
    chunks = [idxs[c : c + MAX_EVAL_BS] for idxs in groups.values()
              for c in range(0, len(idxs), MAX_EVAL_BS)]

    per_sample = [None] * len(samples)
    loop_start = time.time()
    pending = None

    def finish(chunk, preds, shapes):
        post_result = post_process_class(_first_rows(preds, len(chunk)), shapes)
        for j, i in enumerate(chunk):
            per_sample[i] = _slice_post(post_result, j)

    for chunk in chunks:
        n = len(chunk)
        bs = 1 << (n - 1).bit_length()  # pow2 pad: few shapes per bucket
        imgs = [np.asarray(samples[i][0]) for i in chunk]
        shp = [np.asarray(samples[i][1]) for i in chunk]
        images = torch.from_numpy(np.concatenate(imgs + [imgs[0]] * (bs - n))).to(device)
        preds = eval_step(images)
        if pending is not None:
            finish(*pending)
        pending = (chunk, preds, np.concatenate(shp))
    if pending is not None:
        finish(*pending)

    for i, b in enumerate(samples):
        if per_sample[i] is not None:
            eval_class(per_sample[i], b)
    metric = eval_class.get_metric()
    metric["fps"] = len(samples) / max(time.time() - loop_start, 1e-9)
    return metric
