#!/usr/bin/env python3
"""Where the time of a `chip_smoke.py` run goes, phase by phase.

  python3 chip_time_split.py [--smoke PATH/chip_smoke.py] [--out FILE] [-- ARGS]

Imports the given chip_smoke.py (by default the one beside this file; give
the path of an unpacked older tree to measure that tree), wraps some of its
functions and the port's entry points with timers, and runs its main() with
ARGS. Each second of a phase goes to one of four parts, the outermost timed
call deciding:

  reps    timing repetitions that hold nothing: timed_runs, stage_breakdown,
          profile_loop, forward_report, kernel_ms, stream_ms, cuda_ms,
          device_time, loss_ms, loader_breakdown, pse_expansion_report;
  cpu     CPU reference work: the float64 reference steps, the CPU float32
          steps whose errors set the floors, and every forward of a model
          whose parameters lie on the CPU (the float32 CPU runs the card is
          held to), with the port's OCRer / Deter / Recer / Clser calls on
          the CPU and the host work inside them;
  setup   drawing pages, lines and tables, and seeding models;
  card    the rest: the card's runs, the checks, the trainings.

Prints one line a phase and writes the table as JSON to FILE (default
time_split.json in the working directory). The smoke's own output is
printed as it runs.
"""

import functools
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

REPS = ("timed_runs", "stage_breakdown", "profile_loop", "forward_report", "kernel_ms",
        "stream_ms", "cuda_ms", "device_time", "loss_ms", "loader_breakdown",
        "pse_expansion_report")
CPU = ("f64_reference_step",)
SETUP = ("make_pages", "make_train_pages", "make_lines", "make_tables", "seeded_checkpoints",
         "seeded_det", "seeded_star_net")


class Split:
    """Seconds by part, attributed to the outermost timed call."""

    def __init__(self):
        self.total = {"reps": 0.0, "cpu": 0.0, "setup": 0.0}
        self.depth = 0

    def timed(self, part, fn, *args, **kw):
        if self.depth:
            return fn(*args, **kw)
        self.depth += 1
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            self.total[part] += time.perf_counter() - t
            self.depth -= 1

    def wrap(self, part, fn, when=None):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if when is not None and not when(*args, **kw):
                return fn(*args, **kw)
            return self.timed(part, fn, *args, **kw)
        return wrapped


def on_cpu(obj):
    import torch

    if isinstance(obj, torch.nn.Module):
        p = next(obj.parameters(), None)
        return p is not None and p.device.type == "cpu"
    dev = getattr(obj, "device", None)
    if dev is None and hasattr(obj, "runner"):
        dev = getattr(obj.runner, "device", None)
    if dev is None and hasattr(obj, "deter"):
        return on_cpu(obj.deter)
    return dev is not None and torch.device(dev).type == "cpu"


def main():
    argv = sys.argv[1:]
    smoke_args = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[: argv.index("--")] if "--" in argv else argv
    smoke = argv[argv.index("--smoke") + 1] if "--smoke" in argv else os.path.join(
        HERE, "chip_smoke.py")
    out = argv[argv.index("--out") + 1] if "--out" in argv else "time_split.json"
    smoke = os.path.abspath(smoke)
    sys.path.insert(0, os.path.dirname(smoke))
    spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    import torch

    from pytorchocr_tpu_torch.deploy import infer_cls, infer_det, infer_rec, run_ocr

    split = Split()
    for names, part in ((REPS, "reps"), (CPU, "cpu"), (SETUP, "setup")):
        for name in names:
            if hasattr(cs, name):
                setattr(cs, name, split.wrap(part, getattr(cs, name)))
    cs.card_step = split.wrap("cpu", cs.card_step,
                              when=lambda config, dev, *a, **k: torch.device(dev).type == "cpu")
    for cls, meth in ((run_ocr.OCRer, "run_many"), (run_ocr.OCRer, "run"),
                      (infer_det.Deter, "run_batch"), (infer_rec.Recer, "run_batch"),
                      (infer_cls.Clser, "run_batch")):
        if hasattr(cls, meth):
            setattr(cls, meth, split.wrap("cpu", getattr(cls, meth),
                                          when=lambda self, *a, **k: on_cpu(self)))
    module_call = torch.nn.Module.__call__

    def call(self, *args, **kw):
        if split.depth or not on_cpu(self):
            return module_call(self, *args, **kw)
        return split.timed("cpu", module_call, self, *args, **kw)

    torch.nn.Module.__call__ = call

    rows, last = [], {"t": time.perf_counter(), **split.total}
    say = cs.say

    def said(phase, msg):
        say(phase, msg)
        if phase == "time" and msg.startswith("phase ") and " took " in msg:
            now = time.perf_counter()
            row = {"phase": msg.split(" took ")[0][len("phase "):],
                   "wall_s": now - last["t"]}
            for k in split.total:
                row[k + "_s"] = split.total[k] - last[k]
            row["card_s"] = row["wall_s"] - sum(row[k + "_s"] for k in split.total)
            rows.append(row)
            last.update(t=now, **split.total)
            print("[split] phase %s: %.1f s = card %.1f + cpu reference %.1f + timing reps %.1f "
                  "+ setup %.1f" % (row["phase"], row["wall_s"], row["card_s"], row["cpu_s"],
                                    row["reps_s"], row["setup_s"]), flush=True)

    cs.say = said
    sys.argv = [smoke] + smoke_args
    try:
        cs.main()
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            try:
                card = cs.card_line()
            except Exception as e:  # no nvidia-smi: the run failed before its first phase
                card = "not read (%s)" % e
            json.dump({"smoke": smoke, "card": card, "phases": rows}, f, indent=1)
        tot = {k: sum(r[k] for r in rows) for k in ("wall_s", "card_s", "cpu_s", "reps_s",
                                                      "setup_s")}
        print("[split] all: %s" % ", ".join("%s %.1f" % kv for kv in tot.items()), flush=True)


if __name__ == "__main__":
    main()
