#!/usr/bin/env python3
"""The float32-against-float64 train steps of chip_smoke.py's phases 11-15
on seeded single-thread batches, one card:

  python3 chip_f32_steps.py --cls 8 --rec 3 --db 6 --det 1 [--own] [--floors pr6]

Each batch is drawn with one loader thread after `random.seed(i)` /
`np.random.seed(i)`, so a batch is the same in every run (the smoke's
8-thread batches are not); PSE's and PAN's i-th batch holds pages 2i and
2i + 1 (their chains draw the same crops whatever the seed). For each it
runs chip_smoke.compare_f32_step as the smoke does (the float64 and CPU
float32 steps taking the card's pieces, `chip_smoke.Branches`) and prints
one RESULT line: the worst elementwise gradient error over its floor and
the leaf, the worst relative L2, the TF32 control's, and the elements that
took another piece than on the card. `--own` adds, for the classifier and
the CRNN, the same step with the float64 and CPU float32 steps on their own
pieces (the elements only counted): the reference as it was before
Branches.

`--floors pr6` holds phases 12-13 (cls, rec) to phase 11's floors (the CPU
float32 step's worst error in a leaf) in place of their widened ones
(chip_smoke.ELEM_SCALE), as phases 14-15 (pse, pan) are held, and prints,
per model and leaf over all its batches, the largest elementwise error over
that floor and relative L2 over the limit chip_smoke.GRAD_LIMIT: a LEAF line
for each that reaches 0.5 of either, and a SUMMARY line a model.

`--swap ctc,lstm,se,dw` repeats each CRNN (ctc, lstm) and classifier
(se, dw) batch with one piece of the card's float32 step computed in
float64 on the CPU, on the same batch and against the same float64 step:
`ctc` the CTC loss and its gradient with respect to the logits (F.ctc_loss
on the CPU in place of CUDA's), `lstm` both BiLSTMs (cuDNN's float32 LSTM),
`se` every squeeze-excite block of MobileNetV3, `dw` every depthwise conv.
Each prints its RESULT lines and, with `--floors pr6`, its own SUMMARY
("rec+ctc", ...): the piece whose substitution takes the worst leaf under
1.0 of its floor is the one that widens it.

A failed check is printed, not fatal; the exit code is the number of failed
checks (at most 1). --device cpu runs it on the CPU (with the CPU as the
"card")."""

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


def _cast_tree(obj, device, dtype):
    if torch.is_tensor(obj):
        return obj.to(device, dtype) if obj.is_floating_point() else obj.to(device)
    if isinstance(obj, dict):
        return {k: _cast_tree(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast_tree(v, device, dtype) for v in obj)
    return obj


def on_cpu64(module):
    """`module`'s forward computed in float64 on the CPU when its input lies
    on a card: parameters, buffers and inputs go over as float64, the output
    comes back in the input's dtype, and autograd carries the gradients
    back across both casts to the card's parameters."""
    from torch.func import functional_call

    def forward(*args, **kwargs):
        first = next(t for t in args if torch.is_tensor(t))
        if first.device.type != "cuda":
            return type(module).forward(module, *args, **kwargs)
        cpu = torch.device("cpu")
        state = {k: _cast_tree(v, cpu, torch.float64)
                 for k, v in list(module.named_parameters()) + list(module.named_buffers())}
        del module.forward  # functional_call runs the class's forward
        try:
            out = functional_call(module, state, _cast_tree(args, cpu, torch.float64),
                                  _cast_tree(kwargs, cpu, torch.float64))
        finally:
            module.forward = forward
        return _cast_tree(out, first.device, first.dtype)

    module.forward = forward
    return module


def loss_on_cpu64(loss):
    """The loss computed in float64 on the CPU for predictions on a card:
    its value and its gradient with respect to them come back as float32."""

    def wrapped(preds, batch):
        first = preds if torch.is_tensor(preds) else None
        if first is None or first.device.type != "cuda":
            return loss(preds, batch)
        cpu = torch.device("cpu")
        out = loss(_cast_tree(preds, cpu, torch.float64), _cast_tree(tuple(batch), cpu,
                                                                   torch.float64))
        return _cast_tree(out, first.device, first.dtype)

    return wrapped


SWAPS = {"rec": ("ctc", "lstm"), "cls": ("se", "dw")}


def swap_pieces(piece):
    """Patch chip_smoke.train_parts so that the card's step computes `piece`
    in float64 on the CPU (the float64 and CPU float32 steps are unchanged:
    on_cpu64 and loss_on_cpu64 act on card tensors only). Returns the undo."""
    real = cs.train_parts

    def parts(config, device, amp, schedule=None, wrap_loss=None, frozen=()):
        if piece == "ctc" and device.type == "cuda":
            inner = wrap_loss
            wrap_loss = lambda loss: loss_on_cpu64(inner(loss) if inner else loss)  # noqa: E731
        model, opt, step = real(config, device, amp, schedule, wrap_loss, frozen)
        if device.type == "cuda":
            for name, m in model.named_modules():
                if ((piece == "lstm" and isinstance(m, torch.nn.LSTM))
                        or (piece == "se" and type(m).__name__ == "_SE")
                        or (piece == "dw" and isinstance(m, torch.nn.Conv2d)
                            and m.groups > 1 and m.groups == m.in_channels)):
                    on_cpu64(m)
        return model, opt, step

    cs.train_parts = parts
    return lambda: setattr(cs, "train_parts", real)


def seeded_batch(config, seed, bs, label=None):
    random.seed(seed)
    np.random.seed(seed)
    return cs.first_batches(config, 1, bs, label)[0]


def line(kind, seed, mode, got, control, flips, t0):
    print("RESULT %s seed %d%s: elem %.4g of the floor (%s, %.3g of its largest |g|), worst "
          "relative L2 %.3g; TF32 control elem %.4g, relative L2 %.3g; %d parameters past their "
          "bound; elements on another piece than on the card: %s; %.1f s" % (
              kind, seed, mode, got["elem"][0], got["elem"][1],
              dict((k, r) for _, k, r in got["leaves"])[got["elem"][1]], got["grad"][0],
              control["elem"][0], control["grad"][0], got["outside"], flips,
              time.time() - t0), flush=True)


class Worst:
    """Per model and leaf, the largest elementwise error over its floor and
    relative L2 over cs.GRAD_LIMIT over the batches seen."""

    def __init__(self):
        self.elem, self.rel, self.outside, self.runs = {}, {}, {}, {}

    def add(self, kind, got):
        for ratio, k, _ in got["leaves"]:
            self.elem.setdefault(kind, {})[k] = max(self.elem.get(kind, {}).get(k, 0.0), ratio)
        for k, rel in got["rels"].items():
            r = rel / cs.GRAD_LIMIT
            self.rel.setdefault(kind, {})[k] = max(self.rel.get(kind, {}).get(k, 0.0), r)
        self.outside[kind] = self.outside.get(kind, 0) + got["outside"]
        self.runs[kind] = self.runs.get(kind, 0) + 1

    def report(self):
        for kind in self.elem:
            elem, rel = self.elem[kind], self.rel[kind]
            for k in sorted(elem, key=lambda k: -max(elem[k], rel.get(k, 0.0))):
                if max(elem[k], rel.get(k, 0.0)) >= 0.5:
                    print("LEAF %s %s: elem %.4g of the CPU float32 floor, relative L2 %.4g of "
                          "%g" % (kind, k, elem[k], rel.get(k, 0.0), cs.GRAD_LIMIT), flush=True)
            worst_e = max(elem.items(), key=lambda kv: kv[1])
            worst_r = max(rel.items(), key=lambda kv: kv[1])
            print("SUMMARY %s over %d batches: %d of %d leaves at or past 0.5 of a phase-11 "
                  "floor; worst elem %.4g (%s), worst relative L2 %.4g of the limit (%s); %d "
                  "parameters past their bound (no |p| allowance)"
                  % (kind, self.runs[kind], sum(max(elem[k], rel.get(k, 0.0)) >= 0.5
                                                for k in elem),
                     len(elem), worst_e[1], worst_e[0], worst_r[1], worst_r[0],
                     self.outside[kind]), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cls", type=int, default=8, help="classifier batches (phase 13)")
    ap.add_argument("--rec", type=int, default=3, help="CRNN batches (phase 12)")
    ap.add_argument("--db", type=int, default=6, help="DB batches (phase 11)")
    ap.add_argument("--det", type=int, default=1, help="PSE and PAN batches (phases 14-15)")
    ap.add_argument("--own", action="store_true", help="also the steps on their own pieces")
    ap.add_argument("--floors", choices=("smoke", "pr6"), default="smoke",
                    help="phases 12-13's floors: the smoke's, or phase 11's (module docstring)")
    ap.add_argument("--swap", default="",
                    help="comma-separated pieces computed in float64 on the CPU in the card's "
                         "step: ctc, lstm (CRNN), se, dw (classifier)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    pr6 = args.floors == "pr6"

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
    worst = Worst()
    with tempfile.TemporaryDirectory() as tmp:
        for kind, n in (("cls", args.cls), ("rec", args.rec)):
            rec = kind == "rec"
            label = cs.make_lines(os.path.join(tmp, kind), 2 * cs.F32_BS, cs.SEED + 31 + rec,
                                  (1, 25) if rec else (5, 25), turn_half=not rec)
            epochs = cs.LINES_STEPS[kind] // (cs.LINES_TRAIN // cs.LINES_BS)
            schedule = (epochs, cs.LINES_TRAIN // cs.LINES_BS)
            config = cs.lines_config(cs.lines_argv(
                cs.REC_TRAIN_CFG if rec else cs.CLS_TRAIN_CFG, os.path.join(tmp, kind + "_o"),
                label, label, epochs) + cpu_opt)
            config["Train"]["loader"]["num_workers"] = 1
            swaps = [p for p in args.swap.split(",") if p in SWAPS[kind]]
            for seed in range(n):
                batch = seeded_batch(config, seed, cs.F32_BS, label)
                for mode, cls_ in (("", real),) + (((" own pieces", OwnPieces),) if args.own
                                                    else ()):
                    cs.Branches = cls_
                    t0 = time.time()
                    got, control = cs.compare_f32_step(
                        config, dev, batch, card, tag="%s%d%s" % (kind, seed, mode.strip()),
                        schedule=schedule, zero_grad=cs.bn_fed_biases,
                        focus="rnn." if rec else None, card_floors=not pr6)()
                    line(kind, seed, mode, got, control, got["pieces"], t0)
                    if not mode:
                        worst.add(kind, got)
                cs.Branches = real
                for piece in swaps:
                    undo = swap_pieces(piece)
                    try:
                        t0 = time.time()
                        got, control = cs.compare_f32_step(
                            config, dev, batch, card, tag="%s%d+%s" % (kind, seed, piece),
                            schedule=schedule, zero_grad=cs.bn_fed_biases,
                            focus="rnn." if rec else None, card_floors=not pr6)()
                    finally:
                        undo()
                    line("%s+%s" % (kind, piece), seed, "", got, control, got["pieces"], t0)
                    worst.add("%s+%s" % (kind, piece), got)
        label = cs.make_train_pages(os.path.join(tmp, "train"), 16, cs.SEED + 11)
        config = program.preprocess(is_train=True, argv=cs.train_argv(
            os.path.join(tmp, "o"), label, label, 2) + cpu_opt)[0]
        config["Train"]["loader"]["num_workers"] = 1
        for seed in range(args.db):
            batch = seeded_batch(config, seed, 2)
            t0 = time.time()
            got, control = cs.compare_f32_step(config, dev, batch, card, tag="db%d" % seed,
                                               loss_pieces=True)()
            line("db", seed, "", got, control, got["pieces"], t0)
        for kind in ("pse", "pan"):
            spec = cs.DET_TRAIN[kind]
            per_epoch = cs.TRAIN_PAGES // spec["bs"]
            schedule = (spec["steps"] // per_epoch, per_epoch)
            argv = cs.train_argv(os.path.join(tmp, kind), label, label, 2, spec["cfg"]) + cpu_opt
            config = cs.sized(program.preprocess(is_train=True, argv=argv)[0], spec["f32_size"])
            config["Train"]["loader"]["num_workers"] = 1
            for seed in range(args.det):  # pages 2 seed and 2 seed + 1: a batch of its own
                pair = os.path.join(tmp, "%s_pages_%d.txt" % (kind, seed))
                with open(label) as f, open(pair, "w") as g:
                    g.writelines(f.readlines()[2 * seed : 2 * seed + 2])
                batch = seeded_batch(config, seed, 2, pair)
                t0 = time.time()
                job, explained, select = cs.step_flips(config, dev, batch, schedule)
                flips = job.result()[0]
                got, control = cs.compare_f32_step(
                    config, dev, batch, card, tag="%s%d" % (kind, seed), schedule=schedule,
                    zero_grad=cs.bn_fed_biases, explained=explained, select=select)()
                line(kind, seed, "", got, control, "%s; loss thresholds %s" % (got["pieces"],
                                                                               flips), t0)
                worst.add(kind, got)
    if pr6:
        worst.report()
    print("failed checks: %d" % len(fails), flush=True)
    return min(len(fails), 1)


if __name__ == "__main__":
    sys.exit(main())
