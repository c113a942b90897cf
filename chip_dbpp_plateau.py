#!/usr/bin/env python3
"""DB++'s loss plateau on one fixed batch, one card:

  python3 chip_dbpp_plateau.py [--runs 5] [--cap 500] [--lrs 1e-3,2e-4]

DB++ (det_r18_dbpp_synth.yml at full width: ResNet-18, FPN 256 with the ASF
attention scale_channel_spatial, DBHead k=50) on one fixed batch of 4 of
chip_smoke.py's drawn 640x640 pages through the config's train chain, bf16,
the config's amsgrad at a constant LR (chip_smoke.dbpp_overfit's setting).

First, with the config's 1e-3, the ASF attention at the trainer's init and
after 25 and 100 steps: the share of its scores within 0.004 of 0 and of 1,
the fused map's spatial standard deviation, the batch's loss and binary
dice loss. Then, for each LR of `--lrs` and each of `--runs` pairs (the
model's init seed, the batch's augmentation draw), the steps until the
batch's loss falls under 1.5 (read every 25 steps), or "never" within
`--cap`. Last, at chip_smoke's LR (2e-4) on the first pair, every 50 of
`--maps_steps` steps: the loss, the eval forward's mean text and background
probability on the batch (text: its shrink map) and the boxes that the
config's post process finds on the 4 pages at 736. Prints one line each
and the card's name and power limit. Exits 1
without a card. --device cpu runs it on the CPU (slowly; for a rehearsal
with --runs 1 --cap 50)."""

import argparse
import copy
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def attention_report(model, batch, forward_loss):
    """The loss dict of `forward_loss(batch)` (the train step's forward and
    loss, no update) and a line on the ASF scores' saturation and the fused
    map's spread in that forward."""
    seen = {}
    att = model.neck.concat_attention
    hooks = [att.att.register_forward_hook(lambda m, i, o: seen.__setitem__("score", o)),
             att.register_forward_hook(lambda m, i, o: seen.__setitem__("fuse", o))]
    try:
        with torch.no_grad():
            losses = forward_loss(batch)
    finally:
        for h in hooks:
            h.remove()
    s, fuse = seen["score"].float(), seen["fuse"].float()
    return losses, ("scores within 0.004 of 0: %.4f, of 1: %.4f; fused map's spatial std %.4f"
                    % (float((s <= 0.004).float().mean()), float((s >= 0.996).float().mean()),
                       float(fuse.std(dim=(2, 3)).mean())))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cap", type=int, default=500)
    ap.add_argument("--lrs", default="1e-3,2e-4")
    ap.add_argument("--maps_steps", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chip_dbpp_plateau: torch.cuda.is_available() is False")
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    card = cs.card_line() if dev.type == "cuda" else "cpu"

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.losses import build_loss
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.trainer import (batch_to_device, build_input_transform,
                                              float_preds, make_eval_step)
    from pytorchocr_tpu_torch.utils.logging import get_logger

    with tempfile.TemporaryDirectory() as tmp:
        train_label = cs.make_train_pages(os.path.join(tmp, "train"), cs.DBPP_OVERFIT_N,
                                          cs.SEED + 11)
        argv = cs.train_argv(os.path.join(tmp, "out"), train_label, train_label, 10,
                             cs.DBPP_TRAIN_CFG)
        if dev.type == "cpu":
            argv.append("Global.use_gpu=False")
        config = program.preprocess(is_train=True, argv=argv)[0]
        config["Optimizer"].pop("lr_decay")
        loss_fn = build_loss(config["Loss"])
        batches = []
        for seed in range(args.runs):
            random.seed(seed)
            np.random.seed(seed)
            batches.append(batch_to_device(
                cs.first_batches(config, 1, cs.DBPP_OVERFIT_N, train_label)[0], dev))

        model, _, step = cs.train_parts(config, dev, amp=True, schedule=(args.cap, 1))
        norm = build_input_transform(config["Global"]["_device_normalize_spec"]["Train"])

        def forward_loss(batch):
            with torch.autocast(dev.type, torch.bfloat16):
                preds = model(norm(batch[0]).permute(0, 3, 1, 2), data=batch)
            return loss_fn(float_preds(preds), batch)

        done = 0
        for at in (a for a in (0, 25, 100) if a <= args.cap):
            while done < at:
                losses = step(batches[0])
                done += 1
            losses, line = attention_report(model, batches[0], forward_loss)
            print("[attention] LR 1e-3, after %d steps: loss %.4f, binary dice %.4f; %s"
                  % (done, float(losses["loss"]), float(losses["loss_binary_maps"]), line),
                  flush=True)

        for lr in (float(v) for v in args.lrs.split(",")):
            cfg = copy.deepcopy(config)
            cfg["Optimizer"]["base_lr"] = lr
            hits = []
            t0 = time.perf_counter()
            for seed, batch in enumerate(batches):
                cfg["Global"]["seed"] = 2022 + seed
                _, _, step = cs.train_parts(cfg, dev, amp=True, schedule=(args.cap, 1))
                hit = "never"
                for i in range(1, args.cap + 1):
                    losses = step(batch)
                    if i % 25 == 0 and float(losses["loss"]) < 1.5:
                        hit = i
                        break
                hits.append(hit)
            print("[escape] LR %g, bf16: steps to a loss under 1.5 per (init seed 2022+i, "
                  "batch draw i), cap %d: %s; %.1f s on %s"
                  % (lr, args.cap, hits, time.perf_counter() - t0, card), flush=True)

        cfg = copy.deepcopy(config)
        cfg["Optimizer"]["base_lr"] = cs.DBPP_OVERFIT_LR
        model, _, step = cs.train_parts(cfg, dev, amp=True, schedule=(args.cap, 1))
        eval_step = make_eval_step(model, build_input_transform(
            cfg["Global"]["_device_normalize_spec"]["Eval"]))
        post = build_post_process(cfg["PostProcess"], cfg["Global"])
        pages = list(build_dataloader(cfg, "Eval", get_logger(name="root"))[0])
        text = batches[0][3] > 0.5  # the shrink map
        for i in range(1, args.maps_steps + 1):
            losses = step(batches[0])
            if i % 50:
                continue
            p = eval_step(batches[0][0])["maps"].float()[..., 0]
            boxes = sum(len(post({"maps": eval_step(torch.from_numpy(page[0]).to(dev))[
                "maps"].float()}, page[1])[0]["points"]) for page in pages)
            print("[maps] LR %g, after %d steps: loss %.4f, binary dice %.4f; eval forward's "
                  "mean probability on text %.3f, on background %.3f; %d boxes on the %d pages "
                  "at 736 (box_thresh %g)" % (cs.DBPP_OVERFIT_LR, i, float(losses["loss"]),
                                             float(losses["loss_binary_maps"]),
                                             float(p[text].mean()), float(p[~text].mean()),
                                             boxes, len(pages), post.box_thresh), flush=True)
    print(card)


if __name__ == "__main__":
    main()
