#!/usr/bin/env python3
"""The float32-against-float64 train steps of chip_smoke.py's phases 11-15
on seeded single-thread batches, one card:

  python3 chip_f32_steps.py --lines 8 --db 6 --det 1 [--own]

Each batch is drawn with one loader thread after `random.seed(i)` /
`np.random.seed(i)`, so a batch is the same in every run (the smoke's
8-thread batches are not). For each it runs chip_smoke.compare_f32_step
as the smoke does (the float64 and CPU float32 steps taking the card's
pieces, `chip_smoke.Branches`) and prints one RESULT line: the worst
elementwise gradient error over its floor and the leaf, the worst relative
L2, the TF32 control's, and the elements that took another piece than on
the card. `--own` adds, for the classifier and the CRNN, the same step
with the float64 and CPU float32 steps on their own pieces (the elements
only counted): the reference as it was before Branches. A failed check is
printed, not fatal; the exit code is the number of failed checks (at most
1). --device cpu runs it on the CPU (with the CPU as the "card")."""

import argparse
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


class OwnPieces(cs.Branches):
    """Counts the elements on another piece but keeps the replaying run's
    own pieces."""

    def _kink(self, role, name, func, args, kwargs, replay):
        out = super()._kink(role, name, func, args, kwargs, replay)
        return func(*args, **kwargs) if replay else out

    def _pool(self, role, func, args, kwargs, replay):
        out = super()._pool(role, func, args, kwargs, replay)
        return func(*args, **kwargs) if replay else out


def seeded_batch(config, seed, bs, label=None):
    random.seed(seed)
    np.random.seed(seed)
    return cs.first_batches(config, 1, bs, label)[0]


def line(kind, seed, mode, got, control, flips, t0):
    print("RESULT %s seed %d%s: elem %.4g of the floor (%s, %.3g of its largest |g|), worst "
          "relative L2 %.3g; TF32 control elem %.4g, relative L2 %.3g; elements on another "
          "piece than on the card: %s; %.1f s" % (
              kind, seed, mode, got["elem"][0], got["elem"][1],
              dict((k, r) for _, k, r in got["leaves"])[got["elem"][1]], got["grad"][0],
              control["elem"][0], control["grad"][0], flips, time.time() - t0), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lines", type=int, default=8, help="classifier batches (CRNN: a third)")
    ap.add_argument("--db", type=int, default=6, help="DB batches (phase 11)")
    ap.add_argument("--det", type=int, default=1, help="PSE and PAN batches (phases 14-15)")
    ap.add_argument("--own", action="store_true", help="also the steps on their own pieces")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()

    fails = []

    def check(cond, msg):
        if not cond:
            fails.append(msg)
            print("CHECK FAILED:", msg, flush=True)

    cs.check = check
    from pytorchocr_tpu_torch.tools import program

    dev = torch.device(args.device)
    card = cs.card_line() if dev.type == "cuda" else "the CPU"
    cpu_opt = [] if dev.type == "cuda" else ["Global.use_gpu=False"]
    print(card, flush=True)
    real = cs.Branches
    with tempfile.TemporaryDirectory() as tmp:
        for kind, n in (("cls", args.lines), ("rec", max(args.lines // 3, 1))):
            rec = kind == "rec"
            label = cs.make_lines(os.path.join(tmp, kind), 2 * cs.F32_BS, cs.SEED + 31 + rec,
                                  (1, 25) if rec else (5, 25), turn_half=not rec)
            epochs = cs.LINES_STEPS[kind] // (cs.LINES_TRAIN // cs.LINES_BS)
            schedule = (epochs, cs.LINES_TRAIN // cs.LINES_BS)
            config = cs.lines_config(cs.lines_argv(
                cs.REC_TRAIN_CFG if rec else cs.CLS_TRAIN_CFG, os.path.join(tmp, kind + "_o"),
                label, label, epochs) + cpu_opt)
            config["Train"]["loader"]["num_workers"] = 1
            for seed in range(n):
                batch = seeded_batch(config, seed, cs.F32_BS, label)
                for mode, cls_ in (("", real),) + (((" own pieces", OwnPieces),) if args.own
                                                    else ()):
                    cs.Branches = cls_
                    t0 = time.time()
                    got, control = cs.compare_f32_step(
                        config, dev, batch, card, tag="%s%d%s" % (kind, seed, mode.strip()),
                        schedule=schedule, zero_grad=cs.bn_fed_biases,
                        focus="rnn." if rec else None, card_floors=True)
                    line(kind, seed, mode, got, control, got["pieces"], t0)
                cs.Branches = real
        label = cs.make_train_pages(os.path.join(tmp, "train"), 16, cs.SEED + 11)
        config = program.preprocess(is_train=True, argv=cs.train_argv(
            os.path.join(tmp, "o"), label, label, 2) + cpu_opt)[0]
        config["Train"]["loader"]["num_workers"] = 1
        for seed in range(args.db):
            batch = seeded_batch(config, seed, 2)
            t0 = time.time()
            got, control = cs.compare_f32_step(config, dev, batch, card, tag="db%d" % seed,
                                               loss_pieces=True)
            line("db", seed, "", got, control, got["pieces"], t0)
        for kind in ("pse", "pan"):
            spec = cs.DET_TRAIN[kind]
            per_epoch = cs.TRAIN_PAGES // spec["bs"]
            schedule = (spec["steps"] // per_epoch, per_epoch)
            argv = cs.train_argv(os.path.join(tmp, kind), label, label, 2, spec["cfg"]) + cpu_opt
            config = cs.sized(program.preprocess(is_train=True, argv=argv)[0], spec["f32_size"])
            config["Train"]["loader"]["num_workers"] = 1
            for seed in range(args.det):
                batch = seeded_batch(config, seed, 2)
                t0 = time.time()
                flips, explained, select, _ = cs.step_flips(config, dev, batch, schedule)
                got, control = cs.compare_f32_step(
                    config, dev, batch, card, tag="%s%d" % (kind, seed), schedule=schedule,
                    zero_grad=cs.bn_fed_biases, explained=explained, deep=True, select=select)
                line(kind, seed, " (floor 3x)", got, control, "%s; loss thresholds %s" % (
                    got["pieces"], flips), t0)
    print("failed checks: %d" % len(fails), flush=True)
    return min(len(fails), 1)


if __name__ == "__main__":
    sys.exit(main())
