"""The training loop — port of tools/program.py (`extract_device_normalize`
:78, `preprocess` :114, `train` :291, `evaluate` :771-897).

The loop, the eval gate (`eval_epoch_step`), the HighestAcc / FixedEpochStep
checkpoints, the median-smoothed stats and the rank-0-only side effects are
the JAX loop's. A train step is trainer.make_train_step; the losses stay
on the card and are read only at log steps, as the JAX loop fetches them.
`Global.cal_metric_during_train` (rec, cls and table) runs the eval
forward on each train batch after its step, then the post process and the
metric, every step, as the JAX loop does (:605-613; the table post process
takes the whole batch, the others its labels); the post process reads the
predictions on the host, so that step waits for the card.

Data parallel: under `python -m torch.distributed.run --nproc_per_node N`
with `Global.distributed: True`, `preprocess` initialises the process group
(parallel/mesh.py; `Global.dist_backend`, nccl on cards and gloo on the
CPU by default, and `Global.ranks_per_card`, which puts several ranks on
one card over gloo) before the logger, so rank 0 alone logs, writes the
config, TensorBoard and checkpoints. Each rank loads `batch_size_per_card`
samples of its shard, so the global batch is N times that, as in the JAX
multi-process contract. Rank 0 evaluates the whole eval set and broadcasts
the metric, so every rank takes the same best-model decision; a save is
followed by a barrier. The report is per rank, with `world` and the global
samples. Without the torchrun environment one process trains, as before.

`Global.remat` recomputes the forward in the backward (trainer.py's
`remat`). `Global.use_profiler` traces steps [`profile_start_step`,
`profile_end_step`) (10 and 15 by default) on rank 0 with torch.profiler,
the card's activity too, into `save_model_dir/profile` (a Chrome trace,
`trace_steps<start>-<end>.json`), as the JAX loop writes its
jax.profiler trace there (:584-592); a run that ends inside the window
writes the steps it traced.

Not carried over (ROADMAP.md A.15): `steps_per_dispatch`, the bf16 "wire
dtype" (the port sends uint8 images and float32 label maps to the card),
`StallWatchdog`, the save-hang and host-RSS re-exec watchdogs
(`_resume_reexec`), and the XLA compile cache.
`use_tensorboard` writes through torch.utils.tensorboard when it imports,
else nothing, as the JAX writer does without tensorflow.
"""

import os
import random
import time

import numpy as np
import torch
import torch.profiler

from ..parallel import mesh
from ..trainer import (batch_to_device, build_input_transform, make_eval_step,
                       make_train_step, set_matmul_precision)
from ..utils.config import ArgsParser, load_config, merge_config, save_config
from ..utils.logging import get_logger, print_dict, process_rank
from ..utils.save_load import save_model
from ..utils.stats import TrainingStats

SUPPORTED_ALGS = ["DB", "PSE", "PAN", "CRNN", "STARNet", "CLS", "SLANet", "Distillation"]


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


def select_device(global_config, local_rank=0):
    """Global.use_gpu: True -> card `local_rank // Global.ranks_per_card`
    (the first card in one process), and no card raises; False -> the
    CPU."""
    return mesh.select_device(global_config.get("use_gpu", True), local_rank,
                              global_config.get("ranks_per_card", 1))


def init_distributed(global_config):
    """The device, and the process group when the torchrun environment is
    present and Global.distributed is true (else one process: the Mesh is
    None). Sets Global.distributed to whether a group is up."""
    env = mesh.torchrun_env()
    wanted = global_config.get("distributed", False) and env is not None
    device = select_device(global_config, env[2] if wanted else 0)
    if wanted:
        backend = global_config.get("dist_backend") or (
            "nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl" and int(global_config.get("ranks_per_card", 1)) > 1:
            raise ValueError("NCCL refuses two ranks on one card: Global.ranks_per_card > 1 "
                             "takes Global.dist_backend=gloo")
        mesh.setup(backend, device)
    global_config["distributed"] = wanted
    return device, env


def preprocess(is_train=False, argv=None):
    """Parse `-c cfg.yml -o K=v`, load and merge the config, set up logging,
    the device, seeds and TF32. Returns (config, device, logger,
    tsb_writer). From program.py:114."""
    args = ArgsParser().parse_args(argv)
    config = load_config(args.config)
    merge_config(config, args.opt)
    global_config = config["Global"]
    global_config["_config_path"] = args.config
    asked = bool(global_config.get("distributed", False))
    # training ranks join their group before the logger, which asks the rank;
    # tools.eval stays one process
    if is_train:
        device, env = init_distributed(global_config)
    else:
        device, env = select_device(global_config), None
        global_config["distributed"] = False

    log_file = None
    if is_train:
        save_model_dir = global_config["save_model_dir"]
        os.makedirs(save_model_dir, exist_ok=True)
        if process_rank() == 0:
            save_config(config, os.path.join(save_model_dir, "config.yml"))
        log_file = "{}/train.log".format(save_model_dir)
    logger = get_logger(name="root", log_file=log_file)

    alg = config["Architecture"]["algorithm"]
    if alg not in SUPPORTED_ALGS:
        raise ValueError("algorithm must be in {}".format(SUPPORTED_ALGS))

    if global_config.get("device_normalize", False):
        extract_device_normalize(config)

    grid = mesh.get_mesh()
    if is_train and asked and grid is None:
        logger.info("Global.distributed: True without the torchrun environment (RANK, "
                    "WORLD_SIZE): one process trains; `python -m torch.distributed.run "
                    "--nproc_per_node N -m pytorchocr_tpu_torch.tools.train` trains on N ranks")
    elif env is not None and grid is None:
        logger.info("Global.distributed: False under torchrun: rank %d trains alone on the "
                    "whole data", env[0])

    tsb_writer = None
    if global_config.get("use_tensorboard", False) and process_rank() == 0:
        tsb_path = "{}/tensorboard/".format(global_config["save_model_dir"])
        os.makedirs(tsb_path, exist_ok=True)
        tsb_writer = TensorboardWriter(tsb_path)

    set_random_seed(global_config.get("seed", 2022))
    set_matmul_precision()
    print_dict(config, logger)
    logger.info("train with torch {} on {} ({}); rank {} of {}{}; TF32 off for cuDNN and "
                "cuBLAS; {}".format(
                    torch.__version__, device,
                    torch.cuda.get_device_name(device) if device.type == "cuda" else "host",
                    grid.rank if grid else 0, grid.world if grid else 1,
                    " (%s)" % grid.backend if grid else "",
                    "bf16 autocast (use_amp)" if global_config.get("use_amp") else "float32"))
    return config, device, logger, tsb_writer


class StepProfiler:
    """Global.use_profiler: a torch.profiler trace (the host, and the card's
    activity on a card) of the train steps [profile_start_step,
    profile_end_step), written to save_model_dir/profile as a Chrome trace.
    Off (every call a no-op) without use_profiler. From program.py:389-397
    and :584-592."""

    def __init__(self, global_config, device):
        self.on = bool(global_config.get("use_profiler", False))
        self.start = int(global_config.get("profile_start_step", 10))
        self.end = int(global_config.get("profile_end_step", 15))
        self.dir = os.path.join(global_config["save_model_dir"], "profile")
        self.device = device
        self.prof = None
        self.path = None

    def at(self, step):
        """Before train step `step`: start or stop the trace."""
        if not self.on:
            return
        if step == self.start and self.prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif step == self.end:
            self.close(step)

    def close(self, step):
        """Stop a running trace after the steps before `step` and write it."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "trace_steps%d-%d.json" % (self.start, step))
        self.prof.export_chrome_trace(self.path)
        get_logger().info("profiler: steps [%d, %d) traced to %s", self.start, step, self.path)
        self.prof = None


def train(config, device, train_dataloader, valid_dataloader, model, loss_class, optimizer,
          global_state, post_process_class, eval_class, logger, tsb_writer=None):
    """The epoch loop with eval and checkpoints. Returns a report: steps,
    samples, the wall, loader-wait, copy and per-step metric seconds of the
    train iterations of this rank, every step's loss (the global batch's;
    one sync at the end), the best metric, the rank and the data world
    (`world`: samples times world is the global count), and on rank 0 the
    profiler trace's path (`profile`, None without one). From
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
        if valid_dataloader is None or len(valid_dataloader) == 0:
            logger.info("No Images in eval dataset, evaluation during training will be "
                        "disabled")
            start_eval_step = 1e111
        if rank0:
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
        logger.info("Transform params frozen for the first %d epochs (%d steps)",
                    freeze_tf_epochs, frozen[0][1])
    train_step = make_train_step(model, loss_class, optimizer,
                                 input_transform=build_input_transform(dn_spec.get("Train")),
                                 amp=amp, frozen=frozen,
                                 remat=bool(global_config.get("remat", False)))
    profiler = StepProfiler(global_config, device) if rank0 else None
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
    grid = mesh.get_mesh()
    report = dict(steps=0, samples=0, wall_s=0.0, reader_s=0.0, copy_s=0.0, metric_s=0.0,
                  rank=grid.rank if grid else 0, world=grid.data_world if grid else 1)

    def save(prefix, is_best=False):
        save_model(model, optimizer, state(epoch), save_model_dir, logger, is_best=is_best,
                   prefix=prefix)
        mesh.barrier()  # rank 0 wrote it: no rank goes on before it is whole

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
            if profiler is not None:
                profiler.at(global_step)
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
                post_result = post_process_class(
                    eval_step(batch[0]), batch_np if model_type == "table" else batch_np[1])
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

        if epoch + 1 > start_eval_step and (epoch - start_eval_step + 1) % eval_epoch_step == 0:
            # rank 0 evaluates the whole (unsharded) eval set; every rank takes its metric
            cur_metric = mesh.broadcast_object(
                evaluate(eval_step, valid_dataloader, post_process_class, eval_class,
                         model_type, device) if rank0 else None)
            logger.info("cur metric, {}".format(
                ", ".join("{}: {}".format(k, v) for k, v in cur_metric.items())))
            if tsb_writer is not None:
                for k, v in cur_metric.items():
                    if isinstance(v, (float, int)):
                        tsb_writer.add_scalar("EVAL/{}".format(k), v, global_step)
            if cur_metric[main_indicator] >= best_model_dict[main_indicator]:
                best_model_dict.update(cur_metric)
                best_model_dict["best_model_epoch"] = epoch + 1
                save("best_accuracy", is_best=True)
            logger.info("best metric, {}".format(
                ", ".join("{}: {}".format(k, v) for k, v in best_model_dict.items())))
            if tsb_writer is not None:
                tsb_writer.add_scalar("EVAL/best_{}".format(main_indicator),
                                      best_model_dict[main_indicator], global_step)

        if ((epoch + 1) % int(global_config.get("save_latest_epoch_step", 1)) == 0
                or epoch + 1 == epoch_num):
            save("latest")
        if ckpt_save_type == "FixedEpochStep" and (epoch + 1) % save_epoch_step == 0:
            save("epoch_{}".format(epoch))

    if profiler is not None:
        profiler.close(global_step)
        report["profile"] = profiler.path
    if rank0:
        logger.info("best metric, {}".format(
            ", ".join("{}: {}".format(k, v) for k, v in best_model_dict.items())))
        if grid is not None:
            wall = max(report["wall_s"], 1e-9)
            logger.info("rank 0 of {} ({}, data world {}): {} steps, {:.3f} steps/s, {:.2f} "
                        "samples/s on this rank, {:.2f} global, loader wait {:.1%}".format(
                            grid.world, grid.backend, grid.data_world, report["steps"],
                            report["steps"] / wall, report["samples"] / wall,
                            report["samples"] * grid.data_world / wall, report["reader_s"] / wall))
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
    order. Pre-batched loaders take the per-batch path, as tables do (their
    post process and metric take the whole batch, :819-846)."""
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
            eval_class(post_process_class(
                preds, batch_np if model_type == "table" else batch_np[1]), batch_np)
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
