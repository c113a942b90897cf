#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pytorchocr_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, one line each, any failure ends the run with a non-zero exit:
  1. device report and the build of the hand-written kernels (nvcc, sm_90a,
     one nvcc per source, all started together), with ptxas's registers and
     spills and the IGMMA (wgmma) instructions of the int8 conv's SASS;
  2. the run-max kernel (K1) against its plain PyTorch version, exactly, on
     both axes and with the changed flag, at 736x1280 (random, text-like,
     all masked, empty), 184x320, 4096x256, 64x20000, 97x1001, 1x5000 and
     5000x1; then, at 736x1280 and 184x320 on labelled text-like maps, its
     device-only time (kernel_ms), wrapper time, plain time and bound;
  3. the propagation kernel (K2) against its plain PyTorch version, exactly
     (labels and the round-16 flag), on both rules at 736x1280 (nested
     text-like kernels, random seeds), 184x320, 97x1001, 4096x256, 1x5000
     and three edge cases (an empty mask, runs only round 16 completes,
     lone seeds), and the fixpoint on the card against its CPU run; the
     same four times and bound at 736x1280 on both rules;
  4. the DB front half on the card against the CPU run of the port's plain
     path on a 736x1280 map of rectangles, L and U shapes;
  5. the DB slice: OCRer.run_many at full width (DB-ResNet18 + FPN 256, CRNN
     VGG v1 x1.0 + BiLSTM 256 + CTC over 6,624 classes) with seeded weights
     on 4 synthetic 736x1280 pages: float32 on the card (TF32 off) must
     equal the CPU run, boxes and texts on every page; only a box that holds
     a pixel within rounding of the threshold, or a line with a CTC step
     within rounding of a tie, may differ (compare_boxes, compare_texts). It
     is timed. Then the bf16 default is the main-path run whose kernel
     launches are counted; it is timed and reported against float32 by box
     IoU;
  6. the PSE slice: OCRer.run_many with det_r50_pse.yml (ResNet-50, FPN 256,
     PSEHead 256 -> 7, scale 1) and the same CRNN on the same pages, with
     the float32 checks of phase 5 over the 7 maps (on identical maps the
     card's postprocess must give the CPU's boxes exactly), then the bf16
     run with K1 and K2 launches counted, timed, and the expansion of one
     page timed level by level;
  7. the PAN det path: Deter.run_batch with det_r18_pan.yml (ResNet-18,
     FPEM_FFM v2 128 x2, PANHead 128 -> 6) with the float32 box checks over
     the text and kernel maps, then the bf16 run, counted and timed;
  8. the int8 DB slice: OCRer(det_quant=True).run_many on the DB slice's
     checkpoints and pages, calibrated on the first 2 pages. On the CPU,
     then float32 on the card with its own calibration (reported against
     the CPU's) and again with the CPU's: boxes and texts as in phase 5,
     and the int8 elements of the fused map that differ. Then the bf16
     default, the main-path run whose int8-conv and K1 launches are
     counted and timed; its prob maps held against the float bf16 ones by
     the bound tests/test_quant.py sets for an untrained DB model (mean
     |int8 - float| < 0.05), its boxes reported against phase 5's by hmean
     (rectangle IoU >= 0.5); the int8 and the float det forward (bf16)
     over 10 alternating synced calls each, with each one's card time by
     kernel against its wall time and the host time inside the port's
     int8 wrappers (forward_report);
  9. the int8 conv kernel (csrc/int8_conv.cu) against its plain version,
     exactly, in float32 and bf16 output, on every QuantConv call of one
     4-page bf16 int8 DB-ResNet18 forward (collected by wrapping the
     wrapper; every call must write bf16), of the same pages turned
     portrait (1056x736), and on edge shapes; per distinct shape and dtype
     its device time (stream_ms: back to back, the L2 cold), profiler,
     wrapper and plain times and its bound (2 x MACs at 1,979 int8 TOP/s or
     bytes at 3.35 TB/s, the output at its own element size),
     torch._int_mm (1x1 stride-1 shapes: the same int32 product) and
     cuDNN bf16 conv times, and the portrait stem's times; then the
     requantize kernel (csrc/requant.cu) against its plain version on every
     quantize, dequant and residual requantize call of that forward and on
     edge inputs, with its device time and bound (bytes) per shape and
     torch.mul beside the dequant calls, and the path check: the det
     model's int8 bf16 forward runs no aten::round or aten::clamp;
 10. the direction classifier: OCRer with a seeded cls_mbv3small.yml (its
     fc made decisive on the DB slice's crops) on the CPU and float32 on the
     card: equal labels (but a crop whose |p - 0.5| lies within the
     probabilities' difference), boxes and texts as in phase 5; the bf16
     run timed with a Cls stage;
 11. the training slice, det_r18_db_synth.yml at full width (ResNet-18, FPN
     256, DBHead k=50, amsgrad + WarmupPolyLR) on 64 training and 8 eval
     640x640 pages drawn with cv2: one float32 step (TF32 off, bs 2) on the
     card against the same step in float64 on the CPU, from the same seeded
     weights and batch (loss and terms, every gradient, the parameters after
     the update, the BN running statistics; the float64 step, and the CPU
     float32 step whose errors set the floors, take the card's side of every
     relu, relu6 and max-pool kink and of the loss's abs, clamp and
     comparisons, the elements that would have gone the other way counted:
     Branches); a checkpoint round trip (save `latest` after step 1, load
     it into a fresh model and optimizer, step 2 bit for bit the
     uninterrupted one, cuDNN deterministic); then 80 steps of bs 16 in
     bf16 through tools.train.run, the entry point of `python -m
     pytorchocr_tpu_torch.tools.train`, whose loss must fall below half its
     start (means of the first and last 20 steps), with steps/s, samples/s,
     the loader-wait share, and the bucketed evaluate after the last epoch,
     the main-path run of K1 on the training-eval path (counted); the eval
     CLI on the saved checkpoint; card busy over 2 steps by torch.profiler;
 12. CRNN training, rec_vgg_bilstm_ctc_synth.yml as published (VGG v1 x1.0,
     BiLSTM 256, CTC over the 36-character table and blank, bs 128 at
     1x32x320 gray, RecAug, amsgrad + WarmupPolyLR, bf16, 8 loader threads,
     cal_metric_during_train) on 2,560 training and 512 eval lines drawn with
     cv2's Hershey fonts (1-25 lowercase alphanumerics): a float32 step (bs
     8) against float64 as in phase 11 (the forward's pieces taken, not
     the loss's), with the LSTM's gradients reported
     and a TF32-on control that must fail the limits; the checkpoint round
     trip bit for bit; the convergence check (one fixed batch of 128 lines,
     no augmentation, Adam at 3e-3: >= 120 read back within 3,000 steps)
     and that model served from a checkpoint directory by Recer; 40 steps
     through tools.train.run with steps/s, samples/s, the loader-wait, copy
     and per-step-metric shares; tools.eval.run on best_accuracy equal to the
     train run's metric; Recer (deploy.infer_rec) on best_accuracy reading
     the eval lines as the eval post process does; card busy by
     torch.profiler over 2 iterations of the loop;
 13. direction-classifier training, cls_mbv3small_synth.yml as published
     (MobileNetV3 small x0.35, bs 128 at 3x48x192, RecAug without TIA and
     RandAugment) on drawn lines of 5-25 characters, half turned by 180
     degrees: the float32 step against float64, phase 12's fixed-batch
     convergence check on the directions (>= 120 of 128 within 3,000
     steps) and that model served by Clser, 40 steps through
     tools.train.run, tools.eval.run equal to it, Clser (deploy.infer_cls)
     on best_accuracy giving the eval's labels, the same rates and profiler. Phases 12 and 13 add no
     kernel launch: their paths reach no kernel of the port;
 14. PSE training, det_r50_pse_synth.yml as published (ResNet-50, FPN 256,
     PSEHead 256 -> 7, PSELoss with OHEM, bs 8 at 640x640, ColorJitter,
     IaaAugment, MakePseGt, RandomCropImgMask, bf16, 8 loader threads) on
     phase 11's drawn pages: the float32 step against float64 at bs 2 and
     320x320 (the CPU's float64 ResNet-50 step kept short; the forward's
     pieces taken as in phase 11), with the pixels that the two put on the
     other side of a loss threshold counted, the float64 loss summing over
     the card's selections and the IoU logs held to the card's own
     binarisation, and its TF32-on control;
     the checkpoint round trip; 96 steps through tools.train.run, whose mean
     loss over the last 20 steps must fall under 0.5 of the first 20's, with
     the rates, shares and peak memory; the bucketed evaluate after the last
     epoch, every K1 and K2 launch of it recorded and held, with its changed
     flag, to the plain version (the main-path run of both kernels on the
     PSE-train-eval path); tools.eval.run on latest equal to it; Deter
     (deploy.infer_det) on best_accuracy giving the eval's boxes page by
     page; card busy over 2 steps;
 15. PAN++ training, det_r18_pan_synth.yml as published (ResNet-18,
     FPEM_FFM v2 128 x2, PANHead 128 -> 6, PANLoss v2 with the embedding
     loss, bs 16 at 640x640, MakePanGt, float32 images on the wire), the
     checks of phase 14 at 640x640 with 40 steps and 0.6, K1 on the
     PAN-train-eval path; both time their loss, and PAN its embedding loss.
 16. the rest of the zoo served at full width with seeded weights on phase
     5's pages: DB++ (det_r18_dbpp.yml) and phase 5's DB with STAR-Net
     (rec_vgg_tps_bilstm_ctc.yml) through OCRer.run_many, the MobileNetV3,
     ShuffleNetV2, RepVGG and ResNet-50 DBs through Deter.run_batch; each
     float32 against the CPU on 2 pages, its bf16 run timed by stage with
     every K1 launch held to the plain version; the folded RepVGG against
     its train form;
 17. DB++ (det_r18_dbpp_synth.yml) and STAR-Net
     (rec_vgg_tps_bilstm_ctc_synth.yml) trained as published: the float32
     step against float64 and its TF32-on control, the checkpoint round
     trip, tools.train.run (DB++'s loss off its start, its evaluate's K1
     launches held; STAR-Net's transform bit for bit inside the published
     freeze, after a freeze check) and the eval CLIs; DB++'s fall past its
     plateau on one fixed batch, that model served by Deter from its
     checkpoint directory, and STAR-Net's best_accuracy served by Recer.
 18. SLANet tables on 160 train and 48 eval tables drawn with cv2 (2-8 rows,
     2-6 columns, headers, colspans, empty cells, Hershey text; PubTabNet
     jsonl through PubTabDataSet): (a) table_sla_ch.yml served with seeded
     weights (its structure_fc2 made decisive: utils.seeded) through
     program.evaluate, 501 decode steps at 480x480: float32 on the card
     against the CPU on 8 tables (token sequences equal up to eos, but a
     table that differs only after a step whose CPU top-2 margin lies within
     2x the largest probability difference before it, counted; decoded td
     boxes within TABLE_BOX_TOL px; at least 20 tokens before eos on 6 of
     8), then the bf16 eval of the 48 timed (tables/s, the decode loop's
     share of the forward by CUDA events, kernel launches a decode step by
     torch.profiler, card busy; none of the port's kernels launched);
     (b) table_sla_synth.yml trained as published: the float32 step (bs 2)
     against float64 on the card's pieces (hardswish's relu6, CSPPAN's leaky
     relu, relu, the loss's abs and comparisons) and the card's scheduled-
     sampling coins and fed-back tokens, with its TF32-on control; the
     checkpoint round trip; 40 steps through tools.train.run (steps/s,
     samples/s, loader wait, peak memory, the loss under 0.7 of its start)
     and tools.eval.run on best_accuracy equal to its eval; (c) one fixed
     batch of 8 drawn tables (the decode cut to 81 steps) read back (7 of 8
     structures exactly) within a step cap, the untrained model failing that reading, and the checkpoint
     read alike by tools.eval.run (the entry point of `python -m
     pytorchocr_tpu_torch.tools.eval`). The table path adds no kernel launch.
 19. distillation on phase 11's pages, its trained DB-ResNet18 as the teacher
     (`Architecture.Models.Teacher.pretrained`), and phase 12's lines:
     (a) det_cml_db_synth.yml as published (the frozen teacher, two
     MobileNetV3-large x0.5 students with FPN 96; TeachDB + DML + DB losses;
     bs 8 at 640x640, bf16): the float32 step against float64 on the card's
     pieces (the teacher's forward too) and its TF32-on control, the
     checkpoint round trip, tools.train.run with its evaluate through
     DistillationDBPostProcess (every K1 launch held, with its changed flag,
     to the plain version), the teacher bit for bit unchanged in the saved
     checkpoint, tools.eval.run on best_accuracy equal to it; (b)
     det_distill_db_synth.yml and det_dml_db_synth.yml through
     tools.train.run and tools.eval.run alike, and the distill student's
     convergence check on one fixed batch (it reproduces the teacher's eval
     boxes; the untrained student does not); (c) rec_dml_ctc_synth.yml as
     published (two CRNNs, CTC + DML): the float32 step, the round trip,
     tools.train.run and tools.eval.run equal to it, DistillationMetric
     picking the better student; no kernel on that path.
 20. training across ranks (its note above DP_F32_BS), its processes
     started before phase 19 and run beside it;
 21. the rest of serving. (a) int8 PTQ on the zoo's detectors (ZOO_INT8:
     the MobileNetV3s, ShuffleNetV2, RepVGG-A0 in train and deploy form,
     DB++; phase 16's seeded models): float32 int8 on the card against the
     CPU's int8 run on 2 pages in phase 8's form (calibrations, the int8
     payloads' elements apart, boxes), then the bf16 main path through
     OCRer(det_quant=True) with phase 5's CRNN and its Deter, every int8
     conv (both branches), requantize and K1 launch of one forward held to
     the plain version, pages/s, the det forward against the float one,
     and the depthwise branch's (int8_dwconv) shapes timed against
     cuDNN's float32 grouped conv (library_ms; its sums held equal to the
     plain version's) and its bf16 conv (context); (b) phase 11's DB-ResNet18 exported with torch.export (float32
     and bf16), reloaded from its .pt2 and held to the Runner's forward;
     (c) run_ocr's res_*.jpg against its res_*.txt, and a Runner over two
     replicas on the card against one.
 22. the zoo's tail (TAIL_CONFIGS: repo configs with Architecture.Backbone
     replaced whole). (a) DB-ConvNeXt-tiny with a CRNN-ResNet34 (6,624
     classes) and DB-Swin-T with phase 5's CRNN served at full width with
     seeded weights on phase 5's pages as phase 16 serves the zoo (float32
     against the CPU on 2 pages, the bf16 main path timed by stage with
     every K1 launch held); (b) DB-ConvNeXt-tiny trained with AdamW (bs 16
     at 640x640, bf16): Global.remat against the plain step over the same
     fixed batches from one init (steps/s, peak memory, losses and running
     statistics within float32 rounding), tools.train.run with Global.remat
     and Global.use_profiler (the trace's size and the steps it covers),
     and one float32 AdamW step (bs 2 at 320x320) against float64 on phase
     12-13's floors; (c) SGD (nesterov, weight decay) and
     RMSprop on CRNN-ResNet34, every update held to optax's rule in float64
     on the card's own gradients, the loss falling. (b) and (c) run first,
     while the CPU reference processes make (b)'s float64 step and (a)'s
     references.
Each main-path run sets the kernels' counts to 0 just before it and reads
them just after. At the end it checks that no module of jax, flax or the
JAX package (pytorchocr_tpu) was loaded. The line before the last is
{"kernels": [...]} (device_ms, wrapper_ms, plain_ms, bound_ms, bound_by,
library_ms, launches, and `timing`, how device_ms was taken), the last one
the contract {"ok": true, "device":
{...}}. Without a card, or outside a checkout, it exits non-zero and prints
no result.

The phases run in the order 1-4, 11-15, 17, 18, 20 with 19 beside it, 5-10,
16, 21, 22 (run_phases: the trainings' card-bound loops leave the host to the
CPU reference work of the serving phases; nvcc starts on every kernel
source at the top of the run, and each phase waits only for the kernels it
launches). The convergence checks of phases 12, 13, 18 and 19 (a fixed batch
trained until it reads back: host-bound loops that leave the card mostly
idle) run in a side process of this script, one after another, beside the
rest of the run, which waits for them at its end; the timed sections that
ran beside that process's card work, or beside phase 20's ranks, are named
after their phase ("beside"), and phases 9 and 21 wait for it to be idle
before their kernel timings. Each phase's time is printed beside its budget
(PHASE_BUDGET_S); a phase past it says so and does not fail. The CPU reference work runs in a second
process of this script (CpuWorker), stopped while a timed section runs;
the float32-step checks wait for their float64 and CPU float32 steps at the
end of the run ("checks"), each reported then under its phase's tag.
`--only 1-4,19` runs the listed phases and those they read from (19: 11
and 12), and prints no result.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PAGES = 4
H, W = 736, 1280
PORTRAIT_H = 1056  # phase 9's portrait pages: PORTRAIT_H x H
DET_CFG = os.path.join(REPO, "configs", "det", "det_r18_db.yml")
REC_CFG = os.path.join(REPO, "configs", "rec", "rec_vgg_bilstm_ctc.yml")
PSE_CFG = os.path.join(REPO, "configs", "det", "det_r50_pse.yml")
PAN_CFG = os.path.join(REPO, "configs", "det", "det_r18_pan.yml")
CLS_CFG = os.path.join(REPO, "configs", "cls", "cls_mbv3small.yml")


def say(phase, msg):
    print("[%s] %s" % (phase, msg), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit("chip_smoke FAILED: " + msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class CpuWorker:
    """A process of this script (`--cpu-worker DIR THREADS`, niced to 19),
    started at the top of the run, that does CPU reference work off the
    card's critical path: in WORKER the seeded models and the CPU float32
    and int8 runs that phases 5-8, 10, 16 and 21 hold the card to and the
    drawn lines of phases 12-13; in STEP_WORKER the float64 and CPU float32
    train steps of the float32-step checks.
    Jobs are (function of this script, picklable arguments) files in DIR,
    run in the order submitted; each result comes back as a file. While a
    timed section runs (`paused`: the kernels' timings, every
    tools.train.run and tools.eval.run, the loaders' and the losses'
    timings, the profiled train loops, the served timings), the worker is
    stopped (SIGSTOP). The serving timings of phases 5-10, 16 and 21
    (`beside`: pages/s, stage times, card busy) may run beside it, and the
    run says so where they did. With `side` (`--side-worker DIR`, not
    niced, never stopped) the same machinery is the side process, which
    runs card work: the convergence checks (SIDE, beside_run)."""

    def __init__(self, dirname, name, side=False, threads=4):
        os.makedirs(dirname, exist_ok=True)
        self.dir, self.n, self.depth, self.stopped_s, self.waited_s = dirname, 0, 0, 0.0, 0.0
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side-worker" if side else "--cpu-worker",
             dirname, str(threads)], preexec_fn=None if side else lambda: os.nice(19))

    def _path(self, kind, n):
        return os.path.join(self.dir, "%s_%04d.pt" % (kind, n))

    def submit(self, fn, *args, **kwargs):
        import torch

        n, self.n = self.n, self.n + 1
        tmp = self._path("job", n) + ".tmp"
        torch.save({"fn": fn.__name__, "args": args, "kwargs": kwargs}, tmp)
        os.rename(tmp, self._path("job", n))
        return Pending(self, n)

    def result(self, n):
        import torch

        check(self.depth == 0, "a result of %s was asked for inside a timed section" % self.name)
        path = self._path("out", n)
        t0 = time.perf_counter()
        while not os.path.exists(path):
            check(self.proc.poll() is None, "%s ended (exit %s) before job %d"
                  % (self.name, self.proc.returncode, n))
            time.sleep(0.02)
        self.waited_s += time.perf_counter() - t0
        out = torch.load(path, weights_only=False)
        os.remove(path)
        check("error" not in out, "%s's job %d failed:\n%s" % (self.name, n, out.get("error")))
        return out["result"]

    def pause(self):
        import signal

        if self.depth == 0 and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGSTOP)
            self.t_stop = time.perf_counter()
        self.depth += 1

    def resume(self):
        import signal

        self.depth -= 1
        if self.depth == 0 and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGCONT)
            self.stopped_s += time.perf_counter() - self.t_stop

    def busy(self):
        """Whether a job waits or runs."""
        return any(os.path.exists(self._path("job", n)) for n in range(self.n))

    def close(self):
        import signal

        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGCONT)
            self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class Pending:
    """A submitted job's result, or a value computed at once."""

    def __init__(self, worker=None, n=None, value=None):
        self.worker, self.n, self.value, self.done = worker, n, value, worker is None

    def result(self):
        if not self.done:
            self.value, self.done = self.worker.result(self.n), True
        return self.value


class Earlier:
    """An argument of a job that is the result (or one entry of it) of an
    earlier job, resolved in the worker."""

    def __init__(self, pending, key=None):
        self.n, self.key = pending.n, key


WORKER = None  # the run's CpuWorker; None runs every job in place (--only, rehearsals)
# a second niced CPU reference process for the float64 and CPU float32 train
# steps of the float32-step checks (STEP_JOBS), so that they run beside the
# serving references instead of after them, and for the serving references
# that read nothing of WORKER's (step_job); None sends them to WORKER
STEP_WORKER = None
STEP_JOBS = ("f64_steps", "float64_selections")
# the run's side process (a CpuWorker with `side`, not niced, never stopped):
# the convergence checks of phases 12, 13, 18 and 19, host-bound loops of
# launches that leave the card mostly idle, run there one after another,
# beside the rest of the run (beside_run); None runs them in place
SIDE = None
IN_SIDE = False  # this process is the side process


def cpu_job(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` in a CPU reference process (STEP_WORKER for
    STEP_JOBS), or here and now without one. Returns a Pending."""
    if STEP_WORKER is not None and fn.__name__ in STEP_JOBS:
        return STEP_WORKER.submit(fn, *args, **kwargs)
    if WORKER is not None:
        return WORKER.submit(fn, *args, **kwargs)

    def resolve(a):
        return a.value if isinstance(a, Pending) else a

    return Pending(value=fn(*[resolve(a) for a in args],
                            **{k: resolve(v) for k, v in kwargs.items()}))


def step_job(fn, *args, **kwargs):
    """cpu_job in STEP_WORKER: a reference that reads nothing of WORKER's
    jobs (phase 16's seeded zoo detectors, phase 21's int8 runs of them), so
    that the two processes share the serving references."""
    if STEP_WORKER is not None:
        return STEP_WORKER.submit(fn, *args, **kwargs)
    return cpu_job(fn, *args, **kwargs)


def after(pending, key=None):
    """An argument of cpu_job: `pending`'s result (its `key` entry)."""
    if WORKER is None:
        value = pending.result()
        return Pending(value=value if key is None else value[key])
    return Earlier(pending, key)


DEFERRED = []  # the float32-step checks waiting for their CPU steps (later)


def later(check_fn):
    """Hold a float32-step check (compare_f32_step's) back to the end of the
    run, so that its float64 and CPU float32 steps run in the CPU reference
    process while the card goes on with the later phases (their untimed
    parts)."""
    DEFERRED.append(check_fn)


def run_deferred():
    """The held-back float32-step checks, in the order their phases ran."""
    n = len(DEFERRED)
    while DEFERRED:
        DEFERRED.pop(0)()
    say("f32-checks", "the %d float32-step checks held back to here hold" % n)


class paused:
    """A timed section: the CPU reference processes are stopped inside it.
    The run's other card work (card_sharers) is not: the section is named
    (`name`, else its caller's) in its phase's note when that was running."""

    def __init__(self, name=None):
        self.name = name or sys._getframe(1).f_code.co_name

    def __enter__(self):
        note_beside(self.name, card_sharers())
        for worker in (WORKER, STEP_WORKER):
            if worker is not None:
                worker.pause()

    def __exit__(self, *exc):
        for worker in (WORKER, STEP_WORKER):
            if worker is not None:
                worker.resume()


def quiet(fn):
    """`fn` as a timed section (paused)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with paused(fn.__name__):
            return fn(*args, **kwargs)

    return wrapped


# the timed sections that ran beside other work of the run: {section: {who}}
OVERLAPPED = {}
DP_LIVE = False  # phase 20's rank processes are running (its start to its end)


def note_beside(name, who):
    for w in who:
        OVERLAPPED.setdefault(name, set()).add(w)


def beside(fn):
    """A timed serving section (pages/s, stage times, card busy) that the
    niced CPU reference process may run beside: run_phases names it after
    its phase when the process, or other card work, was running then."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        note_beside(fn.__name__, sharing())
        return fn(*args, **kwargs)

    return wrapped


def beside_worker():
    """A note for a timed loop that the CPU reference process, or the rest
    of the run, may run beside."""
    if IN_SIDE:
        return " (in the side process, beside the run's other phases)"
    who = sharing()
    return " (%s ran beside it)" % " and ".join(who) if who else ""


def workers_busy():
    """Whether a CPU reference process that is not stopped has a job."""
    return any(w is not None and w.depth == 0 and w.busy() for w in (WORKER, STEP_WORKER))


def card_sharers():
    """The run's other processes that may use the card now: the side process
    while it has a job, phase 20's ranks while they run."""
    return ((["the side process's card work"] if SIDE is not None and SIDE.busy() else [])
            + (["phase 20's ranks"] if DP_LIVE else []))


def sharing():
    """Who runs beside a timed section that starts now."""
    return (["the niced CPU reference processes"] if workers_busy() else []) + card_sharers()


def side_idle(tag):
    """Wait until the side process has run every job it was given (their
    results are still read at the end), so that the kernel timings that
    follow have the card to themselves."""
    if SIDE is None:
        return
    t0 = time.perf_counter()
    while SIDE.busy():
        check(SIDE.proc.poll() is None, "the side process ended (exit %s)" % SIDE.proc.returncode)
        time.sleep(0.05)
    say(tag, "waited %.1f s for the side process's card work before the kernel timings"
        % (time.perf_counter() - t0))


def beside_run(fn, *args):
    """`fn(*args)`, a convergence check, in the side process (SIDE), after
    the checks submitted there before it; the run waits for it, and fails
    with it, at the end (later). Without a side process, here and now."""
    if SIDE is None:
        fn(*args)
    else:
        later(SIDE.submit(fn, *args).result)


def cpu_worker_main(dirname, threads):
    """A CPU reference process (or the side process): run the jobs of DIR
    in order, on `threads` threads, until told to stop or the parent goes."""
    import traceback

    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(threads)
    parent, done, n = os.getppid(), {}, 0
    while True:
        path = os.path.join(dirname, "job_%04d.pt" % n)
        while not os.path.exists(path):
            if os.getppid() != parent:
                return
            time.sleep(0.02)
        job = torch.load(path, weights_only=False)

        def resolve(a):
            if type(a).__name__ == "Earlier":  # this module may be loaded twice here
                value = done[a.n]
                return value if a.key is None else value[a.key]
            return a

        try:
            out = globals()[job["fn"]](*[resolve(a) for a in job["args"]],
                                       **{k: resolve(v) for k, v in job["kwargs"].items()})
            done[n] = out
            result = {"result": out}
        except (Exception, SystemExit):  # check() raises SystemExit; the parent raises it
            result = {"error": traceback.format_exc()}
        tmp = os.path.join(dirname, "out_%04d.pt.tmp" % n)
        torch.save(result, tmp)
        os.rename(tmp, os.path.join(dirname, "out_%04d.pt" % n))
        os.remove(path)
        n += 1


@quiet
def cuda_ms(fn, iters=50, warmup=5):
    """ms per call of `fn` between CUDA events around a loop of calls: the
    larger of the host's enqueue time and the card's time."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@quiet
def kernel_ms(launch, iters=100, sessions=5):
    """Device-only time per call of `launch` (raw kernel launches into
    preallocated outputs): for each kernel or memset a call runs, the mean
    card duration torch.profiler records for it, summed. Host enqueue time
    and the gaps between launches are not in it. The tracer drops records
    (from 1 to 90 of 100 seen on the H100, most in a process's first
    session), so the means are over the records the traces hold, gathered
    over up to `sessions` sessions of `iters` calls until every kernel has
    50, and at least 10 must be there. The inputs stay in L2 between calls,
    as they do for the fixpoint loops that call the kernels. Returns (ms,
    "name ms xrecords, ..." per kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    totals = {}  # kernel name -> [device us, records]
    for _ in range(sessions):
        for _ in range(5):
            launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                launch()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0:
                t = totals.setdefault(kernel_name(e.key), [0.0, 0])
                t[0] += e.self_device_time_total
                t[1] += e.count
        if totals and min(n for _, n in totals.values()) >= 50:
            break
    check(bool(totals) and min(n for _, n in totals.values()) >= 10,
          "the profiler traces hold under 10 records of a kernel: kernel time not measured")
    means = [(name, us / 1e3 / n, n) for name, (us, n) in totals.items()]
    return sum(m[1] for m in means), ", ".join("%s %.4f x%d" % m for m in means)


L2_BYTES = 50 * 2 ** 20  # H100 SXM L2 (NVIDIA data sheet)


@quiet
def stream_ms(launch, tensors, reps=5):
    """Device ms per call of `launch(*tensors)` back to back, with the L2
    cold: the int8_conv and requant rows of the kernels line use it.
    `launch` runs on rotating copies of `tensors` (its inputs, and its
    outputs where it writes into given ones; what it returns is kept, so a
    new output is a new buffer) that together hold 4x the L2, so every call
    reads its inputs from device memory and its writes evict the dirty lines
    of earlier calls: the write-back that a single launch leaves in the L2
    past its end is paid inside the run. The calls are captured in one CUDA
    graph, replayed `reps` times between CUDA events, and the time divided
    by the calls; the graph's gaps between launches are in it."""
    import torch

    footprint = max(1, sum(t.numel() * t.element_size() for t in tensors))
    sets = max(2, -(-4 * L2_BYTES // footprint))
    copies = [list(tensors)] + [[t.clone() for t in tensors] for _ in range(sets - 1)]
    n = sets * max(1, -(-16 // sets))
    side = torch.cuda.Stream()  # warm on a side stream, as graph capture asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in copies[:2]:  # builds, attributes, cached tensor maps, library handles
            launch(*c)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, kept = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(n):
            kept.append(launch(*copies[i % sets]))
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph, kept, copies
    return ms


def share(bound, ms):
    """`bound` over `ms` in percent; past 100% the time is a measurement
    fault (the card cannot beat its bound), flagged as such."""
    pct = 100.0 * bound / ms
    return "%.0f%%%s" % (pct, " (over 100%: a measurement fault, not a result)" if pct > 100 else "")


def kernel_name(key):
    """A profiler kernel key without its namespace, return type and
    parameter list; template arguments kept."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "").replace(
        " ", "")


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)


def int32_ops_per_s():
    """The card's INT32 rate: 64 INT32 lanes per SM x the SMs x the SM's
    maximum clock (nvidia-smi clocks.max.sm)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    return 64 * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


NO_LIBRARY = {
    "segmented_runmax": "no single PyTorch call computes a max over the maximal masked runs "
                        "of a line (no segmented scan op)",
    "propagate_rounds": "no single PyTorch call computes 16 masked rounds of 4-neighbour "
                        "label-max spreading",
}


def kernel_row(tag, what, name, device, wrapper, plain, nbytes, ops, int32_rate, card):
    """Print one kernel's numbers at one shape against its bound: the larger
    of `nbytes` (each input read once, each output written once) over the
    card's memory rate and `ops` INT32 operations over its INT32 rate.
    `device` is kernel_ms's (ms, per-kernel parts)."""
    device, parts = device
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / int32_rate * 1e3
    bound, bound_by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    say(tag, "%s: device %.4f ms (%s), wrapper %.4f ms, plain %.4f ms; bound %.4f ms by %s "
        "(%.2f MB at 3.35 TB/s = %.4f ms, %.1f M INT32 ops at %.1f T/s = %.4f ms), %.0f%% of "
        "the bound; library_ms: none (%s) on %s"
        % (what, device, parts, wrapper, plain, bound, bound_by, nbytes / 1e6, by_bytes, ops / 1e6,
           int32_rate / 1e12, by_ops, 100.0 * bound / device, NO_LIBRARY[name], card))
    return {"device_ms": device, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by}


def text_like_binary(rng, h, w, n_lines):
    """Text-line rectangles plus L and U shapes (several alternations)."""
    import numpy as np

    m = np.zeros((h, w), bool)
    for _ in range(n_lines):
        y, x = rng.randint(0, h - 30), rng.randint(0, w - 200)
        m[y : y + rng.randint(8, 28), x : x + rng.randint(40, 200)] = True
    for _ in range(n_lines // 10):
        y, x = rng.randint(0, h - 80), rng.randint(0, w - 80)
        s = rng.randint(30, 70)
        m[y : y + s, x : x + 5] = True  # L
        m[y + s - 5 : y + s, x : x + s] = True
        y, x = rng.randint(0, h - 80), rng.randint(0, w - 80)
        m[y : y + s, x : x + 4] = True  # U
        m[y : y + s, x + s - 4 : x + s] = True
        m[y + s - 4 : y + s, x : x + s] = True
    return m


def igmma_count(lib):
    """IGMMA instructions in `lib`'s SASS by cuobjdump, or None where the
    toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    return sum("IGMMA" in ln for ln in out.stdout.splitlines())


READY = set()  # the kernels whose builds kernels_ready has reported


def kernels_ready(names):
    """Wait for the builds of `names` (nvcc started on every source at the
    top of the run, run_phases) and report each once: nvcc's time, ptxas's
    registers and spills; the int8 conv's SASS must hold wgmma. A build
    that fails raises."""
    from pytorchocr_tpu_torch import _kernels

    t0 = time.perf_counter()
    libs = _kernels.build(names)
    for name in names:
        _kernels.load(name)
        if name in READY:
            continue
        READY.add(name)
        if name in _kernels.build_log:
            secs, log = _kernels.build_log[name]
            regs = " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                              if "registers" in ln)
            say("build", "%s.cu built by nvcc (sm_90a) in %.2f s; ptxas: %s" % (name, secs, regs))
            spills = sorted({ln.strip() for ln in log.splitlines()
                             if "spill" in ln and not ln.strip().startswith("0 bytes")
                             and " 0 bytes spill stores, 0 bytes spill loads" not in ln})
            if spills:
                say("build", "%s.cu: ptxas reports spills: %s" % (name, " | ".join(spills)))
            if "serializ" in log:
                say("build", "%s.cu: ptxas: %s" % (name, " | ".join(
                    ln.strip() for ln in log.splitlines() if "serializ" in ln)))
        else:
            say("build", "%s.cu loaded from an earlier build" % name)
        if name == "int8_conv":
            igmma = igmma_count(libs[name])
            if igmma is not None:
                check(igmma > 0, "the int8 conv library holds no IGMMA instruction: no wgmma "
                      "path built")
                say("build", "int8_conv: %d IGMMA (wgmma s8) instructions in its SASS "
                    "(cuobjdump)" % igmma)
    say("build", "%s ready; waited %.2f s for them here" % (", ".join(names),
                                                           time.perf_counter() - t0))


def phase_kernels(dev, card, int32_rate):
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.ops import runmax

    kernels_ready(["runmax", "propagate"])

    rng = np.random.RandomState(SEED)
    cases = {
        "736x1280 random": (rng.rand(H, W) > 0.5),
        "736x1280 text-like": text_like_binary(rng, H, W, 300),
        "184x320 text-like": text_like_binary(rng, 184, 320, 20),
        "736x736 text-like": text_like_binary(rng, 736, 736, 170),  # the training eval's pages
        "4096x256 tall": (rng.rand(4096, 256) > 0.4),
        "64x20000 long": (rng.rand(64, 20000) > 0.4),
        "97x1001 odd": (rng.rand(97, 1001) > 0.3),
        "1x5000 row": (rng.rand(1, 5000) > 0.2),
        "5000x1 column": (rng.rand(5000, 1) > 0.2),
        "736x1280 all masked": np.ones((H, W), bool),
        "736x1280 empty": np.zeros((H, W), bool),
    }
    max_err, shapes = 0, []
    for name, mask in cases.items():
        h, w = mask.shape
        vals = np.where(mask, rng.randint(1, 1 << 30, (h, w)), 0).astype(np.int32)
        tv, tm = torch.from_numpy(vals), torch.from_numpy(mask)
        dv, dm = tv.to(dev), tm.to(dev)
        for axis in (0, 1):
            want = runmax.segmented_runmax_ref(tv, tm, axis)
            got = runmax.segmented_runmax(dv, dm, axis)
            err = int((got.cpu().long() - want.long()).abs().max())
            check(err == 0, "runmax %s axis %d differs from the plain version" % (name, axis))
            max_err = max(max_err, err)
        # the axis-0 launch's changed flag: set against the input, clear at a fixpoint
        got, changed = runmax.segmented_runmax(dv, dm, 0, prev=dv)
        check(int(changed.item()) == int((got.cpu() != tv).any()), "changed flag %s" % name)
        _, same = runmax.segmented_runmax(got, dm, 0, prev=got)
        check(int(same.item()) == 0, "changed flag set at a fixpoint, %s" % name)
        shapes.append(name)

    say("K1", "segmented_runmax == plain on both axes, and the flag, at %s; max_abs_err %d"
        % (", ".join(shapes), max_err))

    # times on labelled text-like maps, one alternation's inputs: the axis-1
    # launch, then the axis-0 launch with prev and the changed flag, as
    # cc_label.spread_labels_scan makes them (736x1280: DB, PSE; 184x320: PAN)
    rows = {}
    for name in ("736x1280 text-like", "184x320 text-like"):
        mask = torch.from_numpy(cases[name]).to(dev)
        h, w = mask.shape
        lbl = torch.where(mask, torch.arange(1, h * w + 1, dtype=torch.int32,
                                             device=dev).view(h, w), 0)
        out = torch.empty_like(lbl)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        for axis, prev in ((1, None), (0, lbl)):
            with_flag = prev is not None
            rows[name, axis] = kernel_row(
                "K1", "%s axis %d%s" % (name, axis, " with prev and flag" if with_flag else ""),
                "segmented_runmax",
                kernel_ms(lambda: runmax.launch(lbl, mask, out, axis, prev,
                                                flag if with_flag else None)),
                cuda_ms(lambda: runmax.segmented_runmax(lbl, mask, axis, prev)),
                cuda_ms(lambda: runmax.segmented_runmax_ref(lbl, mask, axis)),
                # int32 labels and uint8 mask in, int32 out; prev in and the flag out
                h * w * (9 + 4 * with_flag) + 4 * with_flag,
                h * w * (4 + with_flag),  # two scans' max and select, the compare
                int32_rate, card)
    # the JSON line: 736x1280, per launch, the mean of an alternation's two
    main = [rows["736x1280 text-like", axis] for axis in (1, 0)]
    return dict({k: (main[0][k] + main[1][k]) / 2
                 for k in ("device_ms", "wrapper_ms", "plain_ms", "bound_ms")},
                bound_by=main[0]["bound_by"], max_abs_err=max_err)


def nested_field(rng, h, w, n):
    """max over `n` boxes of 1 - (normalized Chebyshev distance to the box
    centre), plus noise: thresholds at rising levels give nested kernels,
    and overlapping boxes contest pixels."""
    import numpy as np

    yy, xx = np.mgrid[:h, :w]
    field = np.full((h, w), -1.0, np.float32)
    for _ in range(n):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry, rx = rng.uniform(2, h / 10 + 3), rng.uniform(3, w / 8 + 4)
        field = np.maximum(field, 1 - np.maximum(np.abs(yy - cy) / ry, np.abs(xx - cx) / rx))
    return field + 0.08 * rng.rand(h, w).astype(np.float32)


def propagate_case(rng, h, w, fill_only, text_like):
    """(labels int32, mask bool) of one K2 case. The fill rule gets sparse
    random seed labels (inside the smallest kernel where `text_like`), the
    CC rule every masked pixel's own index, as CC labelling starts."""
    import numpy as np

    if text_like:
        field = nested_field(rng, h, w, 80)
        mask, core = field > 0.0, field > 0.8
    else:
        mask = core = rng.rand(h, w) > 0.5
    if fill_only:
        labels = np.where(core & (rng.rand(h, w) < 0.01), rng.randint(1, 1000, (h, w)), 0)
    else:
        labels = np.where(mask, np.arange(h * w).reshape(h, w) + 1, 0)
    return labels.astype(np.int32), mask


def edge_propagate_cases():
    """(name, (labels, mask)) of the K2 edge cases: an empty mask (every tile
    skips its rounds); runs that only round 16 completes (the flag set by the
    last round alone), one inside a tile's interior and one across a tile
    edge; and lone seeds in wide masks, where tiles stop early."""
    import numpy as np

    empty = (np.arange(130 * 300, dtype=np.int32).reshape(130, 300) % 7, np.zeros((130, 300), bool))
    lbl, msk = np.zeros((130, 300), np.int32), np.zeros((130, 300), bool)
    for y, x0, seed in ((70, 40, 5), (10, 50, 7), (100, 120, 9)):
        msk[y, x0 : x0 + 17] = True  # 16 pixels from the seed: round 16 reaches the last
        lbl[y, x0] = seed
    lbl[100:103, 200:203] = 3  # labelled, masked, nothing to fill: stops at round 1
    msk[100:103, 200:203] = True
    seeds = np.zeros((200, 200), np.int32)
    seeds[[5, 150], [5, 120]] = [11, 4]
    return [("130x300 empty mask", empty), ("130x300 round 16 only", (lbl, msk)),
            ("200x200 lone seeds", (seeds, np.ones((200, 200), bool)))]


def phase_propagate(dev, card, int32_rate):
    """K2 against its plain version on the card's inputs, exactly: labels and
    flag of two chained launches (the flag set, then perhaps clear), then the
    whole fixpoint against its CPU run."""
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.ops import propagate

    rng = np.random.RandomState(SEED + 3)
    shapes = [(H, W), (184, 320), (97, 1001), (4096, 256), (1, 5000)]
    cases = [("%dx%d" % (h, w), fill_only) + propagate_case(rng, h, w, fill_only, (h, w) == (H, W))
             for h, w in shapes for fill_only in (True, False)]
    cases += [(name, fill_only) + case for name, case in edge_propagate_cases()
              for fill_only in (True, False)]
    max_err, calls, timed = 0, {}, {}
    for name, fill_only, labels, mask in cases:
        tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
        dl, dm = tl.to(dev), tm.to(dev)
        if name == "%dx%d" % (H, W):
            timed[fill_only] = (dl, dm)
        for _ in range(2):
            want, want_flag = propagate.propagate_rounds_ref(tl, tm, fill_only)
            got, flag = propagate.propagate_rounds(dl, dm, fill_only)
            err = int((got.cpu().long() - want.long()).abs().max())
            check(err == 0, "propagate %s fill_only=%s differs from the plain version"
                  % (name, fill_only))
            check(int(flag.item()) == int(want_flag.item()),
                  "propagate %s fill_only=%s: changed flag" % (name, fill_only))
            max_err = max(max_err, err)
            tl, dl = want, got
        before = propagate.launches
        got = propagate.spread_labels_fixpoint(dl, dm, fill_only)
        calls["%s %s" % (name, "fill" if fill_only else "cc")] = propagate.launches - before
        want = propagate.spread_labels_fixpoint(tl, tm, fill_only)
        check(torch.equal(got.cpu(), want), "fixpoint %s fill_only=%s differs from the "
              "CPU run" % (name, fill_only))
    say("K2", "propagate_rounds == plain (labels and flag) on both rules at %s; max_abs_err %d"
        % (", ".join(dict.fromkeys(c[0] for c in cases)), max_err))
    say("K2", "fixpoint on the card == its CPU run everywhere; launches to the fixpoint: %s"
        % ", ".join("%s %d" % kv for kv in calls.items()))
    rows = {}
    for fill_only, (dl, dm) in timed.items():
        out = torch.empty_like(dl)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        rows[fill_only] = kernel_row(
            "K2", "%dx%d nested text-like, %s rule, one 16-round launch"
            % (H, W, "fill" if fill_only else "CC"), "propagate_rounds",
            kernel_ms(lambda: propagate.launch(dl, dm, out, flag, fill_only)),
            cuda_ms(lambda: propagate.propagate_rounds(dl, dm, fill_only)),
            cuda_ms(lambda: propagate.propagate_rounds_ref(dl, dm, fill_only)),
            H * W * 9 + 4,  # int32 labels and uint8 mask in, int32 labels and the flag out
            # 16 rounds of 4 max, a test and a select on each masked pixel
            propagate.ROUNDS * 6 * int(dm.sum()),
            int32_rate, card)
    return dict(rows[True], max_abs_err=max_err)  # the main path runs the fill rule


def phase_front_half(dev):
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.ops import cc_label

    rng = np.random.RandomState(SEED + 1)
    binary = text_like_binary(rng, H, W, 150)
    prob = np.where(binary, 0.5 + 0.49 * rng.rand(H, W), 0.25 * rng.rand(H, W))
    prob = torch.from_numpy(prob.astype(np.float32))
    want = cc_label.db_front_half(prob, 0.3, max_labels=1000)
    before = cc_label.alternations
    got = cc_label.db_front_half(prob.to(dev), 0.3, max_labels=1000)
    got = {k: v.cpu() for k, v in got.items()}
    alts = cc_label.alternations - before
    for k in ("labels", "num", "count", "bbox"):
        check(torch.equal(got[k], want[k]), "front half %s differs from the CPU run" % k)
    check(torch.allclose(got["score"], want["score"], rtol=1e-6, atol=0),
          "front half score differs from the CPU run")
    say("front-half", "%dx%d on cuda == cpu: labels, count, bbox exact, score rtol 1e-6;"
        " %d components, %d alternations" % (H, W, int(want["num"]), alts))


def make_pages(dirname):
    """Synthetic 736x1280 pages of word-like text lines, drawn with cv2."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(SEED + 2)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    paths = []
    for p in range(PAGES):
        img = np.full((H, W, 3), 245, np.uint8)
        y = 50
        while y < H - 30:
            x = int(rng.randint(20, 160))
            scale = float(rng.uniform(0.9, 1.5))
            while x < W - 220:
                word = "".join(rng.choice(letters, rng.randint(3, 9)))
                cv2.putText(img, word, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                            (25, 25, 25), 3, cv2.LINE_AA)
                (tw, _), _ = cv2.getTextSize(word, cv2.FONT_HERSHEY_SIMPLEX, scale, 3)
                x += tw + int(rng.randint(18, 40))
            y += int(rng.randint(55, 90))
        path = os.path.join(dirname, "page_%d.png" % p)
        cv2.imwrite(path, img)
        paths.append(path)
    return paths


def det_inputs(deter, pages):
    """`pages` as `deter` feeds them to its model (normalized NCHW float32 on
    the CPU) and their dark pixels (N, H, W)."""
    import cv2
    import numpy as np
    import torch

    det_imgs = np.concatenate([deter._preprocess(cv2.imread(p))[0] for p in pages])
    x = deter.runner.normalize(torch.from_numpy(det_imgs)).permute(0, 3, 1, 2)
    dark = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) < 128 for im in det_imgs])
    return x, dark


def seeded_checkpoints(dirname, det_cfg, rec_cfg, pages):
    """Full-width models with weights from a torch.Generator; the DB head is
    made text-like on `pages` (utils.seeded.text_like_db_head_) and the CTC
    head decisive (seeded_rec). Returns the .pt paths and the DB head's
    threshold margin in logits."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.utils.seeded import seeded_init_, text_like_db_head_

    gen = torch.Generator().manual_seed(SEED)
    deter = Deter(det_cfg, None, device="cpu")
    model = seeded_init_(deter.runner.model, gen)
    margin = text_like_db_head_(model, *det_inputs(deter, pages))
    det_pt = os.path.join(dirname, "det.pt")
    torch.save(model.state_dict(), det_pt)
    return det_pt, seeded_rec(dirname, rec_cfg, pages, gen, "rec.pt"), margin


def seeded_rec(dirname, rec_cfg, pages, gen, name):
    """A full-width CTC recogniser of `rec_cfg` with weights from the
    torch.Generator `gen`, its head made decisive (decisive_ctc_head_) on
    strips of the first page; its .pt path (`name` in `dirname`)."""
    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy.infer_rec import Recer
    from pytorchocr_tpu_torch.utils.seeded import decisive_ctc_head_, seeded_init_

    recer = Recer(rec_cfg, None, device="cpu")
    model = seeded_init_(recer.runner.model, gen)
    page_img = cv2.imread(pages[0])
    strips = [recer._prep(page_img[y : y + 48, : W // 2]) for y in range(30, H - 48, 90)]
    decisive_ctc_head_(model, torch.from_numpy(np.stack(strips)).permute(0, 3, 1, 2))
    path = os.path.join(dirname, name)
    torch.save(model.state_dict(), path)
    return path


def seeded_det(dirname, det_cfg, pages, text_like, seed, prepare=None):
    """A full-width det model of `det_cfg` with weights from a
    torch.Generator seeded with `seed` (then `prepare(model, generator)`, if
    given), its head made text-like on `pages` by `text_like`
    (utils.seeded). Returns the .pt path and the head's margins in logits,
    one per thresholded map."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.utils.seeded import seeded_init_

    gen = torch.Generator().manual_seed(seed)
    deter = Deter(det_cfg, None, device="cpu")
    model = seeded_init_(deter.runner.model, gen)
    if prepare is not None:
        prepare(model, gen)
    margins = text_like(model, *det_inputs(deter, pages))
    path = os.path.join(dirname, os.path.basename(det_cfg).replace(".yml", ".pt"))
    torch.save(model.state_dict(), path)
    return path, margins


def flat(result):
    return [[(b.reshape(-1).tolist(), t, p) for b, t, p in page] for page in result]


def box_lists(result):
    """One list of flat boxes per page, from OCR rows or from det boxes."""
    import numpy as np

    return [[np.asarray(r[0] if isinstance(r, tuple) else r).reshape(-1).tolist() for r in page]
            for page in result]


@beside
def timed_runs(fn, reps=5):
    """Mean seconds of `reps` calls of `fn` (after an earlier, untimed call)
    and the lines (or boxes) it returns per call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        lines = sum(len(p) for p in fn())
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, lines


def train_run(argv):
    """tools.train.run(argv), the entry point of `python -m
    pytorchocr_tpu_torch.tools.train`, as a timed section: its report and
    seconds."""
    from pytorchocr_tpu_torch.tools import train as train_cli

    with paused():
        t0 = time.perf_counter()
        report = train_cli.run(argv)
        return report, time.perf_counter() - t0


@quiet
def eval_run(argv):
    """tools.eval.run(argv), the entry point of `python -m
    pytorchocr_tpu_torch.tools.eval`, as a timed section (it reports fps)."""
    from pytorchocr_tpu_torch.tools import eval as eval_cli

    return eval_cli.run(argv)


class float32_on_card:
    """TF32 off for cuDNN and cuBLAS inside the block, as the float32
    comparisons with the CPU need."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def det_reference(deter, pages):
    """What compare_boxes holds a card run to, from `deter` (the CPU's, or a
    model on the card): its maps (float32, on the CPU) on the batch of
    `pages` as the det path builds it, and its post process."""
    batch, _ = _det_batch(deter, pages)
    return {"maps": deter.runner(batch)["maps"].float().cpu(), "post": deter.det_post_process_class}


def ocr_crops(pages, rows):
    """The line crops of `rows` (an OCRer's flat rows on `pages`)."""
    import cv2
    import numpy as np

    from pytorchocr_tpu_torch.deploy.run_ocr import crop_lines

    parts = []
    for path, page in zip(pages, rows):
        parts.extend(crop_lines(cv2.imread(path), [np.array(b).reshape(-1, 2) for b, _, _ in page]))
    return parts


def text_reference(ocr, pages, rows):
    """What compare_texts holds a card run to: the line crops of `rows` (an
    OCRer's rows on `pages`), turned as `ocr`'s classifier turns them, as
    the recognizer's batch, and `ocr`'s CTC probabilities on it."""
    import numpy as np

    parts = ocr.turn_upright(ocr_crops(pages, rows))
    batch = np.stack([ocr.recer._prep(im) for im in parts])
    return {"batch": batch, "probs": ocr.recer.runner(batch).float().cpu()}


def ref_ocr(args, pages, det_quant=False, cls_batch=None):
    """The CPU run of OCRer(*args) on `pages` that a float32 card run is
    held to: its rows, seconds, det_reference and text_reference; with
    `det_quant` (calibrated on the first half of the pages) its AbsMax
    state and int8 payloads; with `cls_batch` its classifier's
    probabilities on that batch."""
    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer

    t0 = time.perf_counter()
    ocr = OCRer(*args, det_quant=det_quant, device="cpu")
    cpu = flat(ocr.run_many(pages))
    out = dict(cpu=cpu, cpu_s=time.perf_counter() - t0, det=det_reference(ocr.deter, pages),
               text=text_reference(ocr, pages, cpu))
    if det_quant:
        out.update(calibrated=bool(ocr.deter.runner.quant),
                   absmax=_absmax_state(ocr.deter.runner.model),
                   payloads=_int8_payloads(ocr.deter, pages))
    if cls_batch is not None:
        out["p_cls"] = ocr.clser.runner(cls_batch).float().cpu()
    return out


def ref_det(det_cfg, det_pt, pages):
    """The CPU run of Deter.run_batch on `pages` and its det_reference."""
    import cv2

    from pytorchocr_tpu_torch.deploy.infer_det import Deter

    deter = Deter(det_cfg, det_pt, device="cpu")
    return dict(cpu=box_lists(deter.run_batch([cv2.imread(p) for p in pages])),
                det=det_reference(deter, pages))


def job_slice(tmp, pages):
    """Phase 5's seeded checkpoints and CPU reference."""
    det_pt, rec_pt, margin = seeded_checkpoints(tmp, DET_CFG, REC_CFG, pages)
    return dict(ref_ocr((DET_CFG, det_pt, REC_CFG, rec_pt), pages), det_pt=det_pt, rec_pt=rec_pt,
                margin=margin)


def job_pse(tmp, pages, rec_pt):
    from pytorchocr_tpu_torch.utils.seeded import text_like_pse_head_

    det_pt, margins = seeded_det(tmp, PSE_CFG, pages, text_like_pse_head_, SEED + 4)
    return dict(ref_ocr((PSE_CFG, det_pt, REC_CFG, rec_pt), pages), det_pt=det_pt,
                margins=margins)


def job_pan(tmp, pages):
    from pytorchocr_tpu_torch.utils.seeded import text_like_pan_head_

    det_pt, margins = seeded_det(tmp, PAN_CFG, pages, text_like_pan_head_, SEED + 5)
    return dict(ref_det(PAN_CFG, det_pt, pages), det_pt=det_pt, margins=margins)


def job_cls(tmp, pages, det_pt, rec_pt, rows):
    """Phase 10's classifier, seeded (its fc made decisive on the crops of
    `rows`, phase 5's CPU rows), and its CPU reference."""
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy.infer_cls import Clser
    from pytorchocr_tpu_torch.utils.seeded import decisive_cls_head_, seeded_init_

    parts = ocr_crops(pages, rows)
    clser = Clser(CLS_CFG, None, device="cpu")
    model = seeded_init_(clser.runner.model, torch.Generator().manual_seed(SEED + 7))
    cls_batch = np.stack([clser._prep(c) for c in parts])
    margin = decisive_cls_head_(model, torch.from_numpy(cls_batch).permute(0, 3, 1, 2))
    cls_pt = os.path.join(tmp, "cls.pt")
    torch.save(model.state_dict(), cls_pt)
    args = (DET_CFG, det_pt, REC_CFG, rec_pt, CLS_CFG, cls_pt)
    return dict(ref_ocr(args, pages, cls_batch=cls_batch), args=args, margin=margin,
                cls_batch=cls_batch)


def job_zoo(tmp, pages, kind, det_pt=None, rec_pt=None, tag=None, cfg=None, seed=None):
    """Phase 16's seeded model of `kind` ("dbpp", "starnet" or "det": a
    ZOO_DET entry) and its CPU reference on the first ZOO_CPU_PAGES pages;
    for RepVGG also its fold."""
    from pytorchocr_tpu_torch.utils.seeded import nontrivial_bn_, text_like_db_head_

    few = pages[:ZOO_CPU_PAGES]
    if kind == "dbpp":
        det_pt, margin = seeded_det(tmp, DBPP_CFG, few, text_like_db_head_, SEED + 60)
        return dict(ref_ocr((DBPP_CFG, det_pt, REC_CFG, rec_pt), few), det_pt=det_pt,
                    margin=margin)
    if kind == "starnet":
        star_pt, outside = seeded_star_net(tmp, pages)
        return dict(ref_ocr((DET_CFG, det_pt, STARNET_CFG, star_pt), few), star_pt=star_pt,
                    outside=outside)
    repvgg = "repvgg" in os.path.basename(cfg)
    det_pt, margin = seeded_det(tmp, cfg, few, text_like_db_head_, seed,
                                nontrivial_bn_ if repvgg else None)
    out = dict(ref_det(cfg, det_pt, few), det_pt=det_pt, margin=margin)
    if repvgg:
        out["fold"] = repvgg_fold(tmp, cfg, det_pt)
    return out


def job_lines(tmp, kind):
    """Phase 12's (kind "rec") or 13's ("cls") drawn train and eval lines."""
    rec = kind == "rec"
    lengths = (1, 25) if rec else (5, 25)  # cls: long enough that a turn shows
    return (make_lines(os.path.join(tmp, kind + "_train"), LINES_TRAIN, SEED + 31 + rec, lengths,
                       turn_half=not rec),
            make_lines(os.path.join(tmp, kind + "_eval"), LINES_EVAL, SEED + 41 + rec, lengths,
                       turn_half=not rec))


def submit_references(tmp, pages, wanted):
    """The fixed jobs of the CPU reference process that `wanted` names (the
    keys of REFS), in the order the phases read them. The checkpoints of
    phase 5 (job_slice's det.pt and rec.pt) are written before any later
    job reads them: the process runs its jobs in order."""
    det_pt, rec_pt = os.path.join(tmp, "det.pt"), os.path.join(tmp, "rec.pt")
    jobs = [("lines rec", job_lines, (tmp, "rec"), {}),
            ("lines cls", job_lines, (tmp, "cls"), {}),
            ("slice", job_slice, (tmp, pages), {}),
            ("pse", job_pse, (tmp, pages, rec_pt), {}),
            ("pan", job_pan, (tmp, pages), {}),
            ("int8", ref_ocr, ((DET_CFG, det_pt, REC_CFG, rec_pt), pages), {"det_quant": True}),
            ("cls", job_cls, (tmp, pages, det_pt, rec_pt, "slice rows"), {}),
            ("dbpp", job_zoo, (tmp, pages, "dbpp"), {"rec_pt": rec_pt}),
            ("starnet", job_zoo, (tmp, pages, "starnet"), {"det_pt": det_pt})]
    # the seeded zoo detectors read nothing of the jobs above: the second
    # process makes them, and phase 21's int8 runs of them
    second = [(tag, job_zoo, (tmp, pages, "det"), {"tag": tag, "cfg": cfg, "seed": seed})
              for tag, cfg, seed in ZOO_DET]
    if any(name.startswith("tail ") for name in wanted):
        tail_configs(tmp)  # written before the processes read them
    refs = {}
    for submit, listed in ((cpu_job, jobs), (step_job, second)):
        for name, fn, args, kwargs in listed:
            if name in wanted:
                args = tuple(after(refs["slice"], "cpu") if a == "slice rows" else a
                             for a in args)
                refs[name] = submit(fn, *args, **kwargs)
    cfgs = dict({tag: cfg for tag, cfg, _ in ZOO_DET}, dbpp=DBPP_CFG)
    for tag, src in ZOO_INT8:  # phase 21's CPU int8 runs of phase 16's seeded models
        if "int8 " + tag in wanted:
            fold = after(refs[src], "fold") if tag.endswith("deploy") else None
            # in the process that made its model: an earlier job's result is
            # read in the process that ran it
            refs["int8 " + tag] = (cpu_job if src == "dbpp" else step_job)(
                ref_int8_det, cfgs[src], after(refs[src], "det_pt"), pages[:ZOO_CPU_PAGES],
                fold=fold)
    # phase 22's references last, after phase 21's int8 runs (queued before
    # the int8 DB++ run they held phase 21 up by 90.5 s; both in the first
    # process, phase 22 by 84.1 s, on one H100 host): DB-Swin reads phase 5's
    # CRNN, so the first process makes it; DB-ConvNeXt and its CRNN read
    # nothing earlier, so the second does, ahead of the float64 steps that
    # the run reads only at its end
    if "tail swin" in wanted:
        refs["tail swin"] = cpu_job(job_tail, tmp, pages, "swin", rec_pt=rec_pt)
    if "tail convnext" in wanted:
        refs["tail convnext"] = step_job(job_tail, tmp, pages, "convnext")
    return refs


def phase_slice(dev, card, tmp, pages, ref):
    """The DB slice, held to `ref` (job_slice's CPU reference). Returns the
    main-path run's K1 launches and the checkpoints and runs that later
    phases read."""
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import cc_label, runmax

    det_cfg, rec_cfg = DET_CFG, REC_CFG
    reps = 1
    ref = ref.result()
    det_pt, rec_pt, margin, cpu, cpu_s = (ref[k] for k in ("det_pt", "rec_pt", "margin", "cpu",
                                                           "cpu_s"))
    n_lines = sum(len(p) for p in cpu)
    check(n_lines > 0, "the seeded slice found no text boxes on the CPU")

    with float32_on_card():
        ocr32 = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev, dtype=torch.float32)
        launches0 = runmax.launches
        f32 = flat(ocr32.run_many(pages))
        check(runmax.launches > launches0, "the float32 slice launched no run-max kernel")
        pairs, f32_diff = compare_boxes(ref["det"], ocr32.deter, pages, box_lists(cpu),
                                        box_lists(f32), margin)
        compare_texts(ref["text"], ocr32, cpu, f32, pairs)
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("slice-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off; %d pages of %dx%d, "
            "%d timed run(s)) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
        say("slice-f32", "stages per %d-page call: %s on %s"
            % (PAGES, stage_breakdown(ocr32.deter, pages, "db", ocr32.recer), card))
    del ocr32

    ocr = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev)  # bf16 default
    runmax.launches = 0
    cc_label.alternations = 0
    torch.cuda.synchronize()
    with paused():
        t0 = time.perf_counter()
        bf16 = flat(ocr.run_many(pages))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches, alts = runmax.launches, cc_label.alternations
    check(launches > 0, "the main-path run launched no run-max kernel")
    lines16 = sum(len(p) for p in bf16)
    check(lines16 > 0, "the bf16 slice found no text boxes")
    matched, same_text = match_iou(bf16, f32)
    secs, _ = timed_runs(lambda: ocr.run_many(pages), reps)
    breakdown = stage_breakdown(ocr.deter, pages, "db", ocr.recer)
    busy = device_time(lambda: ocr.run_many(pages), secs)
    say("slice-bf16", "main path: runmax.launches %d, alternations %d (%.1f per page); "
        "first call %.3f s on %s" % (launches, alts, alts / PAGES, first_s, card))
    say("slice-bf16", "bf16 against the float32 run on the card (a report, not a check): "
        "%d lines; %d match an f32 box at IoU >= 0.5, %d of them with the f32 text"
        % (lines16, matched, same_text))
    say("slice-bf16", "%.3f pages/s, %.1f lines/s (%d pages of %dx%d, %d timed run(s)) on %s"
        % (PAGES / secs, lines16 / secs, PAGES, H, W, reps, card))
    say("slice-bf16", "stages per %d-page call: %s on %s" % (PAGES, breakdown, card))
    say("slice-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    return launches, dict(det_pt=det_pt, rec_pt=rec_pt, margin=margin, cpu=cpu, bf16=bf16,
                          pages_per_s=PAGES / secs, f32_diff=f32_diff)


@beside
def pse_expansion_report(deter, pages):
    """pse_expand_device on the first page's kernels from `deter`'s maps: the
    K2 launches of each level's fixpoint, the K1 launches, and the time of
    the whole expansion (host clock; it syncs once per launch)."""
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.ops import cc_label, propagate, runmax

    post = deter.det_post_process_class
    batch, _ = _det_batch(deter, pages[:1])
    _, kernels, labels = post.front_half(deter.runner(batch)["maps"])
    min_area = post.min_area / (post.scale ** 2)
    per_level = []
    fixpoint = cc_label.spread_labels_fixpoint

    def counted(*args, **kwargs):
        before = propagate.launches
        out = fixpoint(*args, **kwargs)
        per_level.append(propagate.launches - before)
        return out

    cc_label.spread_labels_fixpoint = counted
    k1 = runmax.launches
    try:
        again = cc_label.pse_expand_device(kernels[0], min_area)
    finally:
        cc_label.spread_labels_fixpoint = fixpoint
    k1 = runmax.launches - k1
    check(torch.equal(again, labels[0]), "the PSE expansion is not deterministic")
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cc_label.pse_expand_device(kernels[0], min_area)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    k = kernels.shape[1]
    sizes = [int(v) for v in kernels[0].flatten(1).sum(1)]
    return ("pse_expand_device on page 0 (%dx%d, %d instances; kernel pixels %s): K2 launches "
            "per level %s (levels %d..0), %d in all, K1 launches %d; %.2f ms (median of 5, "
            "host clock)" % (kernels.shape[2], kernels.shape[3], int(labels[0].max()), sizes,
                             per_level, k - 2, sum(per_level), k1, float(np.median(ms))))


def phase_pse(dev, card, tmp, pages, rec_pt, ref):
    """The PSE slice: det_r50_pse.yml + the DB slice's CRNN through
    OCRer.run_many, held to `ref` (job_pse's). Returns the main-path run's
    (K1, K2) launches."""
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import propagate, runmax

    det_cfg, rec_cfg, reps = PSE_CFG, REC_CFG, 1
    ref = ref.result()
    det_pt, margins, cpu, cpu_s = ref["det_pt"], ref["margins"], ref["cpu"], ref["cpu_s"]
    say("pse", "seeded PSE head (ResNet-50, FPN 256, PSEHead 256 -> 7): margins %s logits"
        % _fmt(margins))
    check(sum(len(p) for p in cpu) > 0, "the seeded PSE slice found no text boxes on the CPU")

    with float32_on_card():
        ocr32 = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev, dtype=torch.float32)
        before = runmax.launches, propagate.launches
        f32 = flat(ocr32.run_many(pages))
        check(runmax.launches > before[0] and propagate.launches > before[1],
              "the float32 PSE slice did not launch both kernels")
        pairs, _ = compare_boxes(ref["det"], ocr32.deter, pages, box_lists(cpu),
                                 box_lists(f32), margins, tag="pse-f32", channels=range(7),
                                 components=True)
        compare_texts(ref["text"], ocr32, cpu, f32, pairs, tag="pse-f32")
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("pse-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off; %d pages of %dx%d, "
            "%d timed run(s)) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
        say("pse-f32", "stages per %d-page call: %s on %s"
            % (PAGES, stage_breakdown(ocr32.deter, pages, "pse", ocr32.recer), card))
        say("pse-f32", "%s on %s" % (pse_expansion_report(ocr32.deter, pages), card))
    del ocr32

    ocr = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev)  # bf16 default
    runmax.launches = propagate.launches = 0
    torch.cuda.synchronize()
    with paused():
        t0 = time.perf_counter()
        bf16 = flat(ocr.run_many(pages))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = runmax.launches, propagate.launches
    check(launches[0] > 0, "the PSE main-path run launched no run-max kernel")
    check(launches[1] > 0, "the PSE main-path run launched no propagation kernel")
    lines16 = sum(len(p) for p in bf16)
    check(lines16 > 0, "the bf16 PSE slice found no text boxes")
    matched, same_text = match_iou(bf16, f32)
    secs, _ = timed_runs(lambda: ocr.run_many(pages), reps)
    breakdown = stage_breakdown(ocr.deter, pages, "pse", ocr.recer)
    busy = device_time(lambda: ocr.run_many(pages), secs)
    say("pse-bf16", "main path: runmax.launches %d, propagate.launches %d (%.1f per page); "
        "first call %.3f s on %s" % (launches + (launches[1] / PAGES, first_s, card)))
    say("pse-bf16", "bf16 against the float32 run on the card (a report, not a check): "
        "%d lines; %d match an f32 box at IoU >= 0.5, %d of them with the f32 text"
        % (lines16, matched, same_text))
    say("pse-bf16", "%.3f pages/s, %.1f lines/s (%d pages of %dx%d, %d timed run(s)) on %s"
        % (PAGES / secs, lines16 / secs, PAGES, H, W, reps, card))
    say("pse-bf16", "stages per %d-page call: %s on %s" % (PAGES, breakdown, card))
    say("pse-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    say("pse-bf16", "%s on %s" % (pse_expansion_report(ocr.deter, pages), card))
    return launches


def phase_pan(dev, card, tmp, pages, ref):
    """The PAN det path: det_r18_pan.yml through Deter.run_batch, held to
    `ref` (job_pan's). Returns the main-path run's K1 launches."""
    import cv2
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.ops import runmax

    det_cfg, reps = PAN_CFG, 1
    ref = ref.result()
    det_pt, margins, cpu = ref["det_pt"], ref["margins"], ref["cpu"]
    say("pan", "seeded PAN head (ResNet-18, FPEM_FFM v2 128 x2, PANHead 128 -> 6): text and "
        "kernel margins %s logits" % _fmt(margins))
    imgs = [cv2.imread(p) for p in pages]
    check(sum(len(p) for p in cpu) > 0, "the seeded PAN det found no text boxes on the CPU")

    with float32_on_card():
        deter32 = Deter(det_cfg, det_pt, device=dev, dtype=torch.float32)
        before = runmax.launches
        f32 = box_lists(deter32.run_batch(imgs))
        check(runmax.launches > before, "the float32 PAN det launched no run-max kernel")
        compare_boxes(ref["det"], deter32, pages, cpu, f32, margins, tag="pan-f32",
                      channels=(0, 1), components=True)
        secs32, boxes32 = timed_runs(lambda: deter32.run_batch(imgs), reps)
        say("pan-f32", "%.3f pages/s, %.1f boxes/s (float32, TF32 off; %d pages of %dx%d, "
            "%d timed run(s)) on %s" % (PAGES / secs32, boxes32 / secs32, PAGES, H, W, reps, card))
    del deter32

    deter = Deter(det_cfg, det_pt, device=dev)  # bf16 default
    runmax.launches = 0
    torch.cuda.synchronize()
    boxes16 = sum(len(p) for p in deter.run_batch(imgs))
    torch.cuda.synchronize()
    launches = runmax.launches
    check(launches > 0, "the PAN main-path run launched no run-max kernel")
    check(boxes16 > 0, "the bf16 PAN det found no text boxes")
    secs, _ = timed_runs(lambda: deter.run_batch(imgs), reps)
    breakdown = stage_breakdown(deter, pages, "pan")
    busy = device_time(lambda: deter.run_batch(imgs), secs)
    say("pan-bf16", "main path: runmax.launches %d; %d boxes (float32: %d)"
        % (launches, boxes16, sum(len(p) for p in f32)))
    say("pan-bf16", "%.3f pages/s, %.1f boxes/s (%d pages of %dx%d, %d timed run(s)) on %s"
        % (PAGES / secs, boxes16 / secs, PAGES, H, W, reps, card))
    say("pan-bf16", "stages per %d-page call: %s on %s" % (PAGES, breakdown, card))
    say("pan-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    return launches


def _absmax_state(model):
    """{name: value} of every calibrated AbsMax module of `model`, on the CPU."""
    from pytorchocr_tpu_torch.ops.quant import AbsMax

    return {n: m.value.detach().cpu() for n, m in model.named_modules()
            if isinstance(m, AbsMax) and m.calibrated}


INT8_STAGES = ("backbone.stem", "backbone.layer1_block1", "backbone.layer2_block1",
               "backbone.layer3_block1", "backbone.layer4_block1", "neck", "head.binarize.conv1")


# the int8 input of a forward's second int8 conv, an early payload on every
# int8 model: on most, the first that an int8 conv's float epilogue made
# (the first conv's is the image)
INT8_CONV2_INPUT = "int8 conv 2's input"


@contextlib.contextmanager
def int8_payloads(model):
    """Inside the block, the int8 payloads, as int32 on the CPU, of the
    INT8_STAGES modules of `model` whose outputs are QTensors (a ResNet's
    stem and each stage's last block, the DB FPN's fused map, the DB head's
    conv1) and INT8_CONV2_INPUT, from the one forward that runs there, in
    the forward's order."""
    import torch

    from pytorchocr_tpu_torch.ops.quant import QTensor

    from pytorchocr_tpu_torch.ops import int8_conv as conv_mod

    seen, hooks = {}, []
    mods = dict(model.named_modules())
    original, calls = conv_mod.int8_conv, [0]

    def keep(name):
        def hook(mod, inp, out):  # returns None: the module's output stays as it is
            if isinstance(out, QTensor):
                seen[name] = out.q.to(torch.int32).cpu()
        return hook

    def conv(xq, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 2:
            seen[INT8_CONV2_INPUT] = xq.to(torch.int32).cpu()
        return original(xq, *args, **kwargs)

    for name in INT8_STAGES:
        if name in mods:
            hooks.append(mods[name].register_forward_hook(keep(name)))
    conv_mod.int8_conv = conv
    try:
        yield seen
    finally:
        conv_mod.int8_conv = original
        for h in hooks:
            h.remove()


def _int8_payloads(deter, pages):
    """int8_payloads of one forward of `deter`'s model over `pages`."""
    with int8_payloads(deter.runner.model) as seen:
        deter.runner(_det_batch(deter, pages)[0])
    return seen


def hmean(runs, refs):
    """hmean of two runs' boxes matched one to one by rectangle IoU >= 0.5
    (match_iou)."""
    matched, _ = match_iou(runs, refs)
    total = sum(len(p) for p in runs) + sum(len(p) for p in refs)
    return 2.0 * matched / total if total else 1.0


def phase_int8_slice(dev, card, pages, db, ref):
    """The int8 DB slice on the DB slice's checkpoints `db` (phase_slice's),
    held to `ref` (ref_ocr's int8 CPU run, calibrated on the first half of
    the pages). Returns the main-path run's (int8 conv, K1, requant)
    launches and the bf16 int8 OCRer."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import int8_conv, requant, runmax
    from pytorchocr_tpu_torch.utils.weights import load_absmax

    kernels_ready(["int8_conv", "requant"])
    det_cfg, rec_cfg, reps = DET_CFG, REC_CFG, 1
    args = (det_cfg, db["det_pt"], rec_cfg, db["rec_pt"])
    ref = ref.result()
    cpu, cpu_s, cpu_state = ref["cpu"], ref["cpu_s"], ref["absmax"]
    check(ref["calibrated"], "the int8 slice did not calibrate on the CPU")
    check(sum(len(p) for p in cpu) > 0, "the int8 slice found no text boxes on the CPU")

    with float32_on_card():
        ocr32 = OCRer(*args, det_quant=True, device=dev, dtype=torch.float32)
        before = int8_conv.launches
        ocr32.run_many(pages)  # its own calibration
        check(int8_conv.launches > before, "the float32 int8 slice launched no int8 conv kernel")
        own = _absmax_state(ocr32.deter.runner.model)
        check(sorted(own) == sorted(cpu_state), "card and CPU calibrated different modules")
        rel = max(float((own[k] - cpu_state[k]).abs() / cpu_state[k].abs().clamp_min(1e-12))
                  for k in own)
        say("int8-f32", "the card's calibration (float32, TF32 off) against the CPU's: %d absmax, "
            "largest relative difference %.3g" % (len(own), rel))
        load_absmax(ocr32.deter.runner.model, cpu_state)  # the CPU's scales from here on
        f32 = flat(ocr32.run_many(pages))
        q_cpu, q_gpu = ref["payloads"], _int8_payloads(ocr32.deter, pages)
        check(list(q_cpu) == list(q_gpu) and "backbone.stem" in q_gpu,
              "int8 payloads %s on the card, %s on the CPU" % (list(q_gpu), list(q_cpu)))
        report = []
        for name in q_gpu:
            d = (q_cpu[name] - q_gpu[name]).abs()
            report.append("%s %d of %d (%.4f%%, %d by one, at most %d)" % (
                name, int((d > 0).sum()), d.numel(), 100.0 * float((d > 0).float().mean()),
                int((d == 1).sum()), int(d.max())))
        say("int8-f32", "with the CPU's calibration, int8 elements that differ from the CPU's: %s"
            % "; ".join(report))
        check(int((q_cpu["backbone.stem"] - q_gpu["backbone.stem"]).abs().max()) <= 1,
              "the stem's int8 output differs from the CPU's by more than a quantum")
        pairs, _ = compare_boxes(ref["det"], ocr32.deter, pages, box_lists(cpu),
                                 box_lists(f32), db["margin"], tag="int8-f32",
                                 moved=2 * db["f32_diff"])
        compare_texts(ref["text"], ocr32, cpu, f32, pairs, tag="int8-f32")
        say("int8-f32", "card against CPU, both int8: hmean %.4f (rectangle IoU >= 0.5)"
            % hmean(f32, cpu))
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("int8-f32", "%.3f pages/s, %.1f lines/s (int8 det, float32 compute; %d pages of %dx%d, "
            "%d timed run(s)) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
    del ocr32

    ocr = OCRer(*args, det_quant=True, device=dev)  # bf16 default; run_many calibrates
    int8_conv.launches = runmax.launches = requant.launches = 0
    torch.cuda.synchronize()
    with paused():
        t0 = time.perf_counter()
        q16 = flat(ocr.run_many(pages))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = int8_conv.launches, runmax.launches, requant.launches
    check(launches[0] > 0, "the int8 main-path run launched no int8 conv kernel")
    check(launches[1] > 0, "the int8 main-path run launched no run-max kernel")
    check(launches[2] > 0, "the int8 main-path run launched no requantize kernel")
    # int8 against float, both bf16, on the same batch: the JAX package's
    # bound for int8 prob maps of an untrained DB model (tests/test_quant.py:
    # mean |int8 - float| < 0.05), then the boxes
    batch = _det_batch(ocr.deter, pages)[0]
    m_int8 = ocr.deter.runner(batch)["maps"].float()
    deter_float = Deter(det_cfg, db["det_pt"], device=dev)
    m_float = deter_float.runner(batch)["maps"].float()
    err = float((m_int8 - m_float).abs().mean())
    cc = float(torch.corrcoef(torch.stack([m_int8.flatten(), m_float.flatten()]))[0, 1])
    check(bool(((m_int8 >= 0) & (m_int8 <= 1)).all()) and err < 0.05,
          "int8 bf16 prob maps: mean |int8 - float| %.4f (bound 0.05)" % err)
    h = hmean(q16, db["bf16"])
    secs, lines = timed_runs(lambda: ocr.run_many(pages), reps)
    busy = device_time(lambda: ocr.run_many(pages), secs)
    say("int8-bf16", "main path: int8_conv.launches %d, runmax.launches %d, requant.launches %d; "
        "first call %.3f s on %s" % (launches + (first_s, card)))
    say("int8-bf16", "int8 against float, both bf16: prob maps mean |diff| %.4f (bound 0.05), "
        "correlation %.4f; boxes hmean %.4f (%d and %d boxes, rectangle IoU >= 0.5), against the "
        ">= 0.9 that tests/test_quant.py:258 sets for a trained detector: the seeded head puts its "
        "threshold %.3g logits from the nearest pixel, and int8 moves the seeded boxes as far in "
        "the JAX package (tests/test_torch_slice.py)" % (err, cc, h, sum(len(p) for p in q16),
                                                        sum(len(p) for p in db["bf16"]),
                                                        db["margin"]))
    say("int8-bf16", "%.3f pages/s, %.1f lines/s (int8 det; %d pages of %dx%d, %d timed run(s)) "
        "against %.3f pages/s float bf16 (phase 5) on %s"
        % (PAGES / secs, lines / secs, PAGES, H, W, reps, db["pages_per_s"], card))
    say("int8-bf16", "stages per %d-page call: %s on %s"
        % (PAGES, stage_breakdown(ocr.deter, pages, "db", ocr.recer), card))
    say("int8-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    forward_report(ocr.deter.runner, deter_float.runner, batch, card)
    return launches, ocr


@beside
def forward_report(runner_q, runner_f, batch, card, rounds=4):
    """The int8 and the float det forward (both bf16) on one batch, on the
    host clock, each call ending in a sync, in `rounds` alternating pairs;
    then where each one's time goes: card time by kernel (torch.profiler)
    against the call's wall time, and, for int8, the host time spent inside
    the port's int8 conv and requantize wrappers."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorchocr_tpu_torch.ops import int8_conv, requant

    def once(runner):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    walls = {runner_q: [], runner_f: []}
    once(runner_q), once(runner_f)
    for i in range(rounds):
        for r in (runner_q, runner_f) if i % 2 == 0 else (runner_f, runner_q):
            walls[r].append(once(r))
    tq, tf = walls[runner_q], walls[runner_f]
    say("int8-bf16", "det forward, %d pages, %d alternating synced calls each: int8 median %.2f ms "
        "(mean %.2f, min %.2f, max %.2f), float median %.2f ms (mean %.2f, min %.2f, max %.2f) on "
        "%s" % (PAGES, rounds, statistics.median(tq), statistics.mean(tq), min(tq), max(tq),
                statistics.median(tf), statistics.mean(tf), min(tf), max(tf), card))

    host = {"int8_conv": [0.0, 0], "requant": [0.0, 0]}
    wrapped = [(int8_conv, "int8_conv", "int8_conv")] + [(requant, n, "requant")
                                                         for n in REQUANT_FNS]
    originals = [getattr(mod, name) for mod, name, _ in wrapped]

    def clocked(fn, family):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host[family][0] += time.perf_counter() - t0
            host[family][1] += 1
            return out
        return call

    for (mod, name, family), fn in zip(wrapped, originals):
        setattr(mod, name, clocked(fn, family))
    try:
        wall_q = once(runner_q)
    finally:
        for (mod, name, _), fn in zip(wrapped, originals):
            setattr(mod, name, fn)

    for tag, runner in (("int8", runner_q), ("float", runner_f)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner(batch)
            torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
        groups = {}
        for e in events:
            key = ("int8_conv kernels" if "int8_conv_" in e.key else
                   "requant kernels" if "requant_kernel" in e.key else e.key[:50])
            g = groups.setdefault(key, [0.0, 0])
            g[0] += e.self_device_time_total / 1e3
            g[1] += e.count
        busy = sum(g[0] for g in groups.values())
        top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:8]
        say("int8-bf16", "%s det forward under the profiler: wall %.2f ms, card busy %.2f ms over "
            "%d kernels and copies, so the card waits %.2f ms; most: %s on %s"
            % (tag, traced, busy, sum(g[1] for g in groups.values()), traced - busy,
               "; ".join("%s %.3f ms x%d" % (k, v[0], v[1]) for k, v in top), card))
    say("int8-bf16", "int8 det forward, one synced call of %.2f ms: host time inside the wrappers "
        "int8_conv %.2f ms over %d calls, requant %.2f ms over %d calls (checks, allocation, the "
        "ctypes launch) on %s"
        % (wall_q, host["int8_conv"][0] * 1e3, host["int8_conv"][1], host["requant"][0] * 1e3,
           host["requant"][1], card))


def _conv_key(args):
    xq, wq, _, bias, stride, padding, dilation, groups = args
    n, cin, h, w = xq.shape
    cout, kh, kw, _ = wq.shape
    return (n, cin, h, w, cout, kh, kw, tuple(stride), tuple(padding), tuple(dilation), groups,
            bias is not None)


def conv_bound(xq, wq, bias, y, groups):
    """(bound ms, by, int8 ops, bytes, ms by ops, ms by bytes) of one int8
    conv: 2 x MACs at 1,979 int8 TOP/s, or each input read once and the
    output written once (its own element size) at 3.35 TB/s."""
    cout, kh, kw, cg = wq.shape
    ops = 2.0 * y.shape[0] * y.shape[2] * y.shape[3] * cout * kh * kw * cg
    nbytes = (xq.numel() + wq.numel() + 4 * cout * (1 + (bias is not None))
              + y.element_size() * y.numel())
    by_ops, by_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    return bound, by, ops, nbytes, by_ops, by_bytes


CONV_EDGES = [(2, 3, 23, 30, 16, 7, 2, 3, 1, 1), (1, 24, 9, 31, 10, 3, 1, 1, 1, 1),
              (2, 16, 15, 17, 8, 3, 1, 2, 2, 1), (1, 32, 7, 9, 40, 3, 1, 1, 1, 1),
              (2, 96, 24, 48, 96, 5, 1, 2, 1, 96), (2, 8, 10, 10, 6, 3, 1, 1, 1, 2),
              (1, 16, 7, 9, 24, 1, 1, 0, 1, 1), (1, 3, 30, 40, 128, 7, 2, 3, 1, 1),
              (2, 24, 9, 64, 10, 3, 1, 1, 1, 1),
              # grouped: int8_dwconv at C 58 (one contiguous run a row, one
              # channel a thread), a multiplier of 2, output rows narrower
              # than a thread's 4 columns, fewer output rows than a band,
              # dilation 2; int8_conv_direct at groups 4 with 4 channels a group
              (2, 58, 13, 17, 58, 3, 2, 1, 1, 58), (2, 12, 10, 11, 24, 3, 1, 1, 1, 12),
              (2, 16, 9, 5, 16, 3, 1, 0, 1, 16), (1, 32, 2, 50, 32, 5, 1, 2, 1, 32),
              (2, 16, 15, 17, 16, 3, 1, 2, 2, 16), (2, 16, 10, 9, 8, 3, 1, 1, 1, 4)]


def conv_edge_args(dev, rng, case):
    import numpy as np
    import torch

    n, cin, h, w, cout, k, st, pad, dil, g = case
    xq = torch.from_numpy(rng.randint(-127, 128, (n, cin, h, w)).astype(np.int8)).to(dev)
    xq = xq.contiguous(memory_format=torch.channels_last)
    wq = torch.from_numpy(rng.randint(-127, 128, (cout, k, k, cin // g)).astype(np.int8)).to(dev)
    sc = torch.from_numpy((rng.rand(cout) * 1e-3).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev)
    return (xq, wq, sc, b, (st, st), (pad, pad), (dil, dil), g)


def phase_int8_conv(dev, card, ocr, pages):
    """The int8 conv kernel against its plain version on every QuantConv
    call of one bf16 int8 forward of `ocr`'s det model over `pages`, in
    both output dtypes, and on edge shapes; times and bounds per distinct
    shape and dtype. Returns the JSON row's numbers (bf16, the main path's
    output) and the float32 ones, summed over the forward's calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pytorchocr_tpu_torch.ops import int8_conv

    side_idle("int8-conv")
    wrapped = int8_conv.int8_conv

    def recorded(batch):
        """The int8 conv calls of one forward of the det model over `batch`."""
        calls, out_dtypes = [], []

        def record(*args, out_dtype=torch.float32):
            calls.append(args)
            out_dtypes.append(out_dtype)
            return wrapped(*args, out_dtype=out_dtype)

        int8_conv.int8_conv = record
        try:
            ocr.deter.runner(batch)
        finally:
            int8_conv.int8_conv = wrapped
        torch.cuda.synchronize()
        check(len(calls) > 0, "the int8 forward made no int8 conv call")
        check(set(out_dtypes) == {torch.bfloat16}, "the bf16 int8 forward's convs wrote %s, not "
              "bf16 alone" % sorted(map(str, set(out_dtypes))))
        return calls

    batch = _det_batch(ocr.deter, pages)[0]
    calls = recorded(batch)
    # the same pages turned portrait, as DB's resize (short side 736) gives
    # them: the stem's output rows are 368 pixels, and its 128-pixel tiles
    # run from the end of one row into the next
    portrait = recorded(np.ascontiguousarray(batch.transpose(0, 2, 1, 3)[:, :PORTRAIT_H]))

    dtypes = (torch.float32, torch.bfloat16)
    max_err, shapes = 0.0, {}
    for args in calls:
        for od in dtypes:
            got, want = wrapped(*args, out_dtype=od), int8_conv.int8_conv_ref(*args, out_dtype=od)
            err = float((got.float() - want.float()).abs().max())
            check(torch.equal(got, want), "int8_conv (%s) differs from the plain version at %s: %g"
                  % (od, _conv_key(args), err))
            max_err = max(max_err, err)
        shapes.setdefault(_conv_key(args), []).append(args)
    for args in portrait:
        for od in dtypes:
            got, want = wrapped(*args, out_dtype=od), int8_conv.int8_conv_ref(*args, out_dtype=od)
            err = float((got.float() - want.float()).abs().max())
            check(torch.equal(got, want), "int8_conv (%s) differs from the plain version at the "
                  "portrait forward's %s: %g" % (od, _conv_key(args), err))
            max_err = max(max_err, err)
    rng = np.random.RandomState(SEED + 6)
    for case in CONV_EDGES:
        a = conv_edge_args(dev, rng, case)
        for od in dtypes:
            check(torch.equal(wrapped(*a, out_dtype=od), int8_conv.int8_conv_ref(*a, out_dtype=od)),
                  "int8_conv (%s) differs from the plain version at edge shape %s"
                  % (od, _conv_key(a)))
    say("int8", "int8_conv == plain (float32 and bf16 bits) on all %d calls of the %d-page forward "
        "(%d shapes; the forward wrote bf16), all %d of the same pages turned portrait (%dx%d) "
        "and %d edge shapes (Cin 3 and 24, dilation 2, Cout 40, depthwise 5x5 96, groups 2, 1x1 "
        "Cin 16, byte loads at Cout 128, an input patch of Cin 24; depthwise C 58, multiplier 2, "
        "Wo 3, H 2, dilation 2, groups 4 with 4 channels a group); max_abs_err %g"
        % (len(calls), PAGES, len(shapes), len(portrait), PORTRAIT_H, H, len(CONV_EDGES),
           max_err))

    def timed(args, od):
        """(device ms back to back with the L2 cold, profiler ms and kernel
        names of single launches with the L2 warm, the output)."""
        xq, wq, scale, bias, stride, padding, dilation, groups = args
        y = wrapped(*args, out_dtype=od)
        dev_ms = stream_ms(lambda x_, y_: int8_conv.launch(
            x_, wq, scale, bias, y_, stride, padding, dilation, groups), [xq, y])
        prof_ms, names = kernel_ms(lambda: int8_conv.launch(
            xq, wq, scale, bias, y, stride, padding, dilation, groups), iters=50)
        return dev_ms, prof_ms, names, y

    keys = ("device_ms", "profiler_ms", "wrapper_ms", "plain_ms", "bound_ms", "by_ops",
            "by_bytes")
    total = {od: dict.fromkeys(keys, 0.0) for od in dtypes}
    total["library_ms"] = total["cudnn_ms"] = 0.0
    library_calls, shares = 0, []
    for key, group in shapes.items():
        xq, wq, scale, bias, stride, padding, dilation, groups = group[0]
        n, cin, h, w, cout, kh, kw = key[:7]
        c = len(group)
        parts = []
        for od in dtypes:
            dev_ms, prof_ms, names, y = timed(group[0], od)
            bound, by, ops, nbytes, by_ops, by_bytes = conv_bound(xq, wq, bias, y, groups)
            wrap_ms = cuda_ms(lambda: wrapped(*group[0], out_dtype=od), iters=20)
            plain_ms = cuda_ms(lambda: int8_conv.int8_conv_ref(*group[0], out_dtype=od), iters=3,
                               warmup=1)
            for name, v in zip(keys, (dev_ms, prof_ms, wrap_ms, plain_ms, bound, by_ops,
                                      by_bytes)):
                total[od][name] += c * v
            shares.append((100.0 * bound / dev_ms, "%s %s" % (key[:7], od)))
            parts.append("%s: device %.4f ms (back to back, L2 cold), profiler %.4f ms (%s; L2 "
                         "warm), wrapper %.4f ms, plain %.4f ms, bound %.4f ms by %s (%.2f G int8 "
                         "ops = %.4f ms, %.1f MB = %.4f ms), %s of the bound"
                         % ("f32" if od == torch.float32 else "bf16", dev_ms, prof_ms, names,
                            wrap_ms, plain_ms, bound, by, ops / 1e9, by_ops, nbytes / 1e6,
                            by_bytes, share(bound, dev_ms)))
        wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        xb = xq.to(torch.bfloat16)
        cudnn = cuda_ms(lambda: F.conv2d(xb, wb, None, stride, padding, dilation, groups), iters=20)
        total["cudnn_ms"] += c * cudnn
        lib = None
        if (kh, kw, groups) == (1, 1, 1) and tuple(stride) == (1, 1) and bias is None:
            a2 = xq.permute(0, 2, 3, 1).reshape(-1, cin)  # (M, K) view of the NHWC payload
            b2 = wq.reshape(cout, cin).t()  # (K, N), column-major
            y = wrapped(*group[0])
            check(torch.equal(torch._int_mm(a2, b2).float() * scale,
                              y.permute(0, 2, 3, 1).reshape(-1, cout)),
                  "torch._int_mm's product differs from the kernel's at %s" % (key,))
            lib = stream_ms(torch._int_mm, [a2, b2])
            library_calls += c
            total["library_ms"] += c * lib
        say("int8", "N%d Cin%d %dx%d -> Cout%d %dx%d/%d (x%d in the forward): %s; library_ms %s; "
            "cuDNN bf16 conv %.4f ms (CUDA events around a loop of calls; context) on %s"
            % (n, cin, h, w, cout, kh, kw, stride[0], c, "; ".join(parts),
               "%.4f ms (torch._int_mm, int32 product, back to back, L2 cold)" % lib
               if lib is not None else
               "none (no PyTorch call computes an int8 convolution on CUDA)", cudnn, card))
    for od in dtypes:
        t = total[od]
        t["bound_by"] = "operations" if t["by_ops"] >= t["by_bytes"] else "bytes"
        say("int8", "one %d-page forward, %d calls, %s output: device %.3f ms (back to back, L2 "
            "cold; profiler, L2 warm: %.3f ms), wrapper %.3f ms, plain %.3f ms, bound %.3f ms by "
            "%s (%s) on %s"
            % (PAGES, len(calls), od, t["device_ms"], t["profiler_ms"], t["wrapper_ms"],
               t["plain_ms"], t["bound_ms"], t["bound_by"], share(t["bound_ms"], t["device_ms"]),
               card))
    stem = next(a for a in portrait if a[0].shape[1] == 3)
    parts, portrait_ms = [], {}
    for od in dtypes:
        dev_ms, prof_ms, names, y = timed(stem, od)
        bound = conv_bound(stem[0], stem[1], stem[3], y, stem[7])[0]
        portrait_ms[od] = dev_ms
        parts.append("%s: device %.4f ms (back to back, L2 cold), profiler %.4f ms (%s; L2 warm), "
                     "bound %.4f ms, %s of the bound"
                     % ("f32" if od == torch.float32 else "bf16", dev_ms, prof_ms, names, bound,
                        share(bound, dev_ms)))
    say("int8", "the stem of %d portrait pages (%dx%d -> %dx%d: 128-pixel tiles straddle output "
        "rows), input patch in two segments: %s on %s"
        % (PAGES, PORTRAIT_H, H, y.shape[2], y.shape[3], "; ".join(parts), card))
    say("int8", "cuDNN bf16 convs of the same shapes %.3f ms (context); torch._int_mm %.3f ms over "
        "the %d 1x1 stride-1 calls; shapes under half their bound: %s"
        % (total["cudnn_ms"], total["library_ms"], library_calls,
           ", ".join("%s %.0f%%" % (k, v) for v, k in sorted(shares) if v < 50) or "none"))
    row = dict(total[torch.bfloat16], max_abs_err=max_err, calls=len(calls),
               library_calls=library_calls, library_ms=total["library_ms"],
               f32=total[torch.float32], portrait_stem_ms=portrait_ms[torch.bfloat16],
               portrait_stem_f32_ms=portrait_ms[torch.float32])
    return row


REQUANT_FNS = ("quantize", "dequant", "add_act_quantize")


def _requant_key(name, args):
    import torch

    t = [a for a in args if torch.is_tensor(a) and a.dim() > 0]
    fmt = "cl" if not t[0].is_contiguous() else "contig"
    return (name, tuple(t[0].shape), tuple(str(a.dtype).split(".")[-1] for a in t), fmt,
            tuple(a for a in args if not torch.is_tensor(a) and a is not None))


def _requant_ref(name):
    from pytorchocr_tpu_torch.ops import requant

    return getattr(requant, name + "_ref")


def _rotating(fn, args):
    """(launch, tensors) for stream_ms: `launch(*tensors)` calls `fn` on
    `args` with its tensors that have dimensions replaced by `tensors`."""
    import torch

    at = [i for i, a in enumerate(args) if torch.is_tensor(a) and a.dim() > 0]

    def launch(*tensors):
        a = list(args)
        for i, t in zip(at, tensors):
            a[i] = t
        return fn(*a)

    return launch, [args[i] for i in at]


def requant_edges(dev):
    """(name, args) edge inputs: exact ties, saturation, -0.0, odd sizes,
    unaligned views, both memory formats, every operand combination."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 8)
    k = rng.randint(-130, 130, (2, 16, 9, 13)).astype(np.float32)
    ties = torch.from_numpy((k + 0.5) * 0.25).to(dev)  # x / 0.25 = k + 0.5 exactly
    x = torch.from_numpy((rng.randn(3, 5, 7, 11) * 0.9).astype(np.float32)).to(dev)
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, 1e30, -1e30])
    s, s2 = torch.tensor(0.25, device=dev), torch.tensor(0.0071, device=dev)
    flat = torch.from_numpy((rng.randn(4099 + 3) * 0.5).astype(np.float32)).to(dev)
    cases = [("quantize", (ties, s)), ("quantize", (ties.bfloat16(), s)), ("quantize", (x, s2)),
             ("quantize", (x.contiguous(memory_format=torch.channels_last), s2)),
             ("quantize", (x.bfloat16(), s2)), ("quantize", (flat[3:], s2))]
    q = torch.from_numpy(rng.randint(-127, 128, (3, 5, 7, 11)).astype(np.int8)).to(dev)
    q2 = torch.from_numpy(rng.randint(-127, 128, (3, 5, 7, 11)).astype(np.int8)).to(dev)
    qf = torch.from_numpy(rng.randint(-127, 128, 4099 + 1).astype(np.int8)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("dequant", (q, s2, dtype)), ("dequant", (qf[1:], s2, dtype))]
    ops = {"i8": (q, s2), "f32": (x, None), "bf16": (x.bfloat16(), None)}
    other = {"i8": (q2, s), "f32": (x * 0.7, None), "bf16": ((x * 0.7).bfloat16(), None)}
    for ka in ops:
        for kb in other:
            for relu in (False, True):
                (a, sa), (b, sb) = ops[ka], other[kb]
                cases.append(("add_act_quantize", (a, b, sa, sb, s2, relu)))
    cl = torch.channels_last
    cases.append(("add_act_quantize", (q.contiguous(memory_format=cl),
                                       x.contiguous(memory_format=cl), s2, None, s2, True)))
    cases.append(("add_act_quantize", (qf[1:], flat[3:], s2, None, s2, True)))
    return cases


def phase_requant(dev, card, ocr, pages):
    """The requantize kernel (csrc/requant.cu) against its plain version on
    every call of one bf16 int8 forward and on edge inputs; device time,
    bound and calls per shape. Then the path check: torch.profiler's op
    list of the det model's int8 bf16 forward alone holds no aten::round
    and no aten::clamp, and the kernel's count rose. Returns the JSON row's
    numbers, summed over the forward's calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorchocr_tpu_torch.ops import quant, requant

    calls = []
    originals = {name: getattr(requant, name) for name in REQUANT_FNS}

    def recorder(name):
        def call(*args):
            calls.append((name, args))
            return originals[name](*args)
        return call

    for name in REQUANT_FNS:
        setattr(requant, name, recorder(name))
    try:
        ocr.deter.runner(_det_batch(ocr.deter, pages)[0])
    finally:
        for name in REQUANT_FNS:
            setattr(requant, name, originals[name])
    torch.cuda.synchronize()
    check(len(calls) > 0, "the int8 forward made no requantize call")
    shapes, max_err = {}, 0.0
    edges = requant_edges(dev)
    for i, (name, args) in enumerate(calls + edges):
        got, want = originals[name](*args), _requant_ref(name)(*args)
        check(torch.equal(got, want), "requant.%s differs from the plain version at %s%s"
              % (name, "edge input " if i >= len(calls) else "", _requant_key(name, args)))
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))
        if i < len(calls):
            shapes.setdefault(_requant_key(name, args), []).append((name, args))
    say("requant", "requant == plain (bits) on all %d calls of the %d-page int8 bf16 forward (%d "
        "shapes: %s) and %d edge inputs (exact ties, saturation, -0.0, odd and unaligned sizes, "
        "channels_last, every operand combination of the add, relu on and off); max_abs_err %g"
        % (len(calls), PAGES, len(shapes), ", ".join("%s x%d" % (n, sum(c[0] == n for c in calls))
                                                     for n in REQUANT_FNS), len(edges), max_err))

    total = dict(device_ms=0.0, profiler_ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=0.0, library_kernel_ms=0.0)
    library_calls = 0
    for key, group in shapes.items():
        name, args = group[0]
        out = originals[name](*args)
        ins = [a for a in args if torch.is_tensor(a)]
        nbytes = sum(a.numel() * a.element_size() for a in ins) + out.numel() * out.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        dev_ms = stream_ms(*_rotating(originals[name], args))
        prof_ms, names = kernel_ms(lambda: originals[name](*args), iters=50)
        wrap_ms = cuda_ms(lambda: originals[name](*args), iters=20)
        plain_ms = cuda_ms(lambda: _requant_ref(name)(*args), iters=10)
        c = len(group)
        for k, v in (("device_ms", dev_ms), ("profiler_ms", prof_ms), ("wrapper_ms", wrap_ms),
                     ("plain_ms", plain_ms), ("bound_ms", bound)):
            total[k] += c * v
        lib = "none (no single PyTorch call computes it)"
        if name == "dequant":
            # torch.mul of the int8 payload by the 0-d float32 scale computes
            # float(q) * scale in float32 and rounds it to the out tensor's
            # dtype, in one kernel: the same function
            q, scale, dtype = args
            y = torch.empty_like(q, dtype=dtype)
            torch.mul(q, scale, out=y)
            check(torch.equal(y, out), "torch.mul(q, scale, out=%s) differs from requant.dequant at "
                  "%s" % (dtype, key))
            lib_ms = stream_ms(lambda q_, y_: torch.mul(q_, scale, out=y_), [q, y])
            total["library_ms"] += c * lib_ms
            total["library_kernel_ms"] += c * dev_ms
            library_calls += c
            lib = "%.4f ms (torch.mul(q, scale, out=%s), bit-equal; back to back, L2 cold)" % (
                lib_ms, str(dtype).split(".")[-1])
        say("requant", "%s (x%d in the forward): device %.4f ms (back to back, L2 cold), profiler "
            "%.4f ms (%s; L2 warm), wrapper %.4f ms, plain %.4f ms; bound %.4f ms by bytes (%.1f MB "
            "at 3.35 TB/s), %s of the bound; library_ms %s on %s"
            % (key, c, dev_ms, prof_ms, names, wrap_ms, plain_ms, bound, nbytes / 1e6,
               share(bound, dev_ms), lib, card))
    say("requant", "one %d-page forward, %d calls: device %.3f ms (back to back, L2 cold; "
        "profiler, L2 warm: %.3f ms), wrapper %.3f ms, plain %.3f ms, bound %.3f ms by bytes (%s); "
        "library_ms %.4f ms over the %d dequant calls (torch.mul; the kernel %.4f ms on them), "
        "none for quantize and the residual requantize (torch.quantize_per_tensor multiplies by "
        "1 / scale and clamps to -128: another function) on %s"
        % (PAGES, len(calls), total["device_ms"], total["profiler_ms"], total["wrapper_ms"],
           total["plain_ms"], total["bound_ms"], share(total["bound_ms"], total["device_ms"]),
           total["library_ms"], library_calls, total["library_kernel_ms"], card))

    # the path check: the model's forward alone, as Runner._forward runs it
    runner = ocr.deter.runner
    x = runner.normalize(torch.from_numpy(_det_batch(ocr.deter, pages)[0]).to(dev))
    x = x.permute(0, 3, 1, 2)
    with torch.inference_mode(), quant.quantized(runner.model, "int8"), \
            torch.autocast("cuda", dtype=runner.dtype):
        runner.model(x)
        torch.cuda.synchronize()
        before = requant.launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runner.model(x)
            torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    bad = sorted(ops & {"aten::round", "aten::clamp"})
    check(not bad, "the int8 bf16 det forward still runs %s" % bad)
    check(requant.launches > before, "the int8 bf16 det forward launched no requantize kernel")
    say("requant", "path: the det model's int8 bf16 forward (%s) runs %d requantize kernels and no "
        "aten::round or aten::clamp (%d ops in the profiler's list: %s)"
        % (runner.dtype, requant.launches - before, len(ops), ", ".join(sorted(
            k for k in ops if k.startswith("aten::")))))
    return dict(total, max_abs_err=max_err, calls=len(calls), library_calls=library_calls)


def phase_cls(dev, card, tmp, pages, db, ref):
    """The direction classifier on the DB slice (phase_slice's `db`): a
    seeded cls_mbv3small.yml, its fc made decisive on the CPU crops, held to
    `ref` (job_cls's)."""
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer

    ref = ref.result()
    args, margin, cls_batch, cpu, p_cpu = (ref[k] for k in ("args", "margin", "cls_batch", "cpu",
                                                            "p_cls"))
    reps = 1
    with float32_on_card():
        ocr32 = OCRer(*args, device=dev, dtype=torch.float32)
        f32 = flat(ocr32.run_many(pages))
        p_gpu = ocr32.clser.runner(cls_batch).float().cpu()
        diff = float((p_gpu - p_cpu).abs().max())
        near = ((p_cpu[:, 1] - 0.5).abs() <= 2 * diff).tolist()
        same = (p_gpu.argmax(1) == p_cpu.argmax(1)).tolist()
        check(all(s or n for s, n in zip(same, near)),
              "a cls label differs on the card at a crop far from p = 0.5")
        n180 = int((p_cpu.argmax(1) == 1).sum())
        say("cls-f32", "seeded cls (MobileNetV3 small x0.35 + ClsHead, fc decisive, nearest crop "
            "%.3g logits from a tie): %d crops, %d labelled 180; probs max |cuda - cpu| %.3g, "
            "labels equal on %d, %d within 2x that of 0.5" % (margin, len(cls_batch), n180, diff,
                                                             sum(same), sum(near)))
        pairs, _ = compare_boxes(ref["det"], ocr32.deter, pages, box_lists(cpu),
                                 box_lists(f32), db["margin"], tag="cls-f32")
        compare_texts(ref["text"], ocr32, cpu, f32, pairs, tag="cls-f32",
                      excused={i for i, n in enumerate(near) if n})
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("cls-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off, with cls; %d pages of "
            "%dx%d, %d timed run(s)) on %s" % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps,
                                                card))
    del ocr32
    parts = ocr_crops(pages, db["cpu"])
    ocr = OCRer(*args, device=dev)  # bf16 default
    ocr.run_many(pages)
    secs, lines = timed_runs(lambda: ocr.run_many(pages), reps)
    say("cls-bf16", "%.3f pages/s, %.1f lines/s (with cls; %d pages of %dx%d, %d timed run(s)) "
        "on %s" % (PAGES / secs, lines / secs, PAGES, H, W, reps, card))
    say("cls-bf16", "stages per %d-page call: %s on %s"
        % (PAGES, stage_breakdown(ocr.deter, pages, "db", ocr.recer, ocr.clser), card))
    cls_s = timed_runs(lambda: [ocr.clser.run_batch(parts)], reps)[0]
    say("cls-bf16", "Clser.run_batch on the %d crops: %.1f ms (mean of %d); profiler: %s on %s"
        % (len(parts), cls_s * 1e3, reps, device_time(lambda: ocr.clser.run_batch(parts), cls_s),
           card))


def _det_batch(deter, pages):
    import cv2
    import numpy as np

    pre = [deter._preprocess(cv2.imread(p)) for p in pages]
    return (np.concatenate([p[0] for p in pre]), np.concatenate([p[1] for p in pre]))


def compare_boxes(ref, deter32, pages, cpu, f32, margin, tag="slice-f32", channels=(0,),
                  components=False, moved=None):
    """Boxes of a float32 det path on the card against the CPU run (`cpu`,
    `f32`: one list of flat boxes per page; `ref`, the CPU run's
    det_reference: its maps and its post process). The two runs' maps agree to
    rounding, so a pixel whose value lies within that rounding of the
    threshold may binarize differently in one of `channels` and change the
    boxes of its component. Checked: every pixel that binarizes differently
    lies within twice the largest map difference of the threshold; on
    identical maps the card's postprocess (its kernels) gives the CPU's
    boxes exactly; and on every page each box is equal to one of the other
    run's, except a box whose bounding rectangle holds such a pixel (the
    page area of its map pixel, with `components`). With `components` (PSE,
    PAN: map 0 is the text map, and the instances of one text component
    grow against each other, so a flipped pixel can move the border between
    any two of them) a box whose rectangle meets the rectangle of a text
    component, on either run, that holds such a pixel is excused too; those
    are counted apart. With `moved` (int8: an int8 element a quantum apart
    moves the maps by far more than float rounding, and a box's mean score
    can cross box_thresh with no pixel binarized differently) a box whose
    rectangle holds a pixel where the maps differ by more than `moved` is
    excused too, counted apart. `margin` is the seeded head's distance of
    the nearest pixel to the threshold, in logits (one per map for PSE/PAN).
    Returns the equal boxes as (page, cpu line, card line) triples, lines
    counted over all pages, and the maps' largest difference."""
    import cv2
    import numpy as np
    import torch

    channels = list(channels)
    batch, shapes = _det_batch(deter32, pages)
    maps_gpu = deter32.runner(batch)["maps"].float()
    m_gpu = maps_gpu.cpu()[..., channels]
    m_cpu = ref["maps"][..., channels]
    diff = float((m_gpu - m_cpu).abs().max())
    thresh = ref["post"].thresh
    flips = (m_gpu > thresh) != (m_cpu > thresh)
    near = (m_cpu - thresh).abs() <= 2 * diff
    check(bool((~flips | near).all()), "a pixel far from the threshold binarizes differently")
    flipped = flips.any(-1)
    post_gpu = deter32.det_post_process_class({"maps": maps_gpu}, shapes)
    post_cpu = ref["post"]({"maps": maps_gpu.cpu()}, shapes)
    for i, (a, b) in enumerate(zip(post_gpu, post_cpu)):
        check(torch.equal(torch.from_numpy(a["points"]), torch.from_numpy(b["points"])),
              "page %d: on the same map, cuda postprocess boxes != cpu" % i)

    pairs, excused, by_component, by_moved, flip_counts = [], 0, 0, 0, []
    base_cpu = base_gpu = 0
    height, width = m_cpu.shape[1:3]
    for i, (page_gpu, page_cpu) in enumerate(zip(f32, cpu)):
        ys, xs = np.nonzero(flipped[i].numpy())
        cell = np.array([shapes[i][1] / width, shapes[i][0] / height])  # page pixels per map pixel
        flip_lo = np.stack([xs, ys], axis=1) * cell
        flip_hi = flip_lo + cell if components else flip_lo
        flip_counts.append(len(flip_lo))
        moved_lo = np.zeros((0, 2))
        if moved is not None:
            my, mx = np.nonzero(((m_gpu[i] - m_cpu[i]).abs().amax(-1) > moved).numpy())
            moved_lo = np.stack([mx, my], axis=1) * cell
        comp_lo = comp_hi = np.zeros((0, 2))
        if components and len(flip_lo):
            text = ((m_cpu[i, ..., 0] > thresh) | (m_gpu[i, ..., 0] > thresh)).numpy()
            _, lab, stats, _ = cv2.connectedComponentsWithStats(text.astype(np.uint8),
                                                                connectivity=4)
            hit = np.unique(lab[ys, xs])
            hit = hit[hit > 0]
            comp_lo = stats[hit, 0:2] * cell
            comp_hi = (stats[hit, 0:2] + stats[hit, 2:4]) * cell

        def excuse(box, here, there):
            nonlocal excused, by_component, by_moved
            if _holds_flip(box, flip_lo, flip_hi):
                excused += 1
            elif _holds_flip(box, comp_lo, comp_hi):
                by_component += 1
            elif _holds_flip(box, moved_lo, moved_lo):
                by_moved += 1
            else:
                check(False, "page %d: %s box %s has no equal on the %s and no pixel binarized "
                      "differently" % (i, here, box, there))

        unused = {}
        for j, box in enumerate(page_gpu):
            unused.setdefault(tuple(box), []).append(j)
        for j, box in enumerate(page_cpu):
            left = unused.get(tuple(box))
            if left:
                pairs.append((i, base_cpu + j, base_gpu + left.pop(0)))
            else:
                excuse(box, "cpu", "card")
        for key, left in unused.items():
            for _ in left:
                excuse(list(key), "card", "cpu")
        base_cpu += len(page_cpu)
        base_gpu += len(page_gpu)
    gap = float((m_cpu - thresh).abs().min())
    say(tag, "maps max |cuda - cpu| %.3g; nearest cpu pixel %.3g from the threshold (seeded head "
        "margin %s logits); pixels binarized differently per page %s, all within 2x that of the "
        "threshold; on the same maps the cuda postprocess boxes == cpu on all %d pages"
        % (diff, gap, _fmt(margin), flip_counts, len(pages)))
    say(tag, "cuda float32 (TF32 off) vs cpu float32: %d of %d cpu boxes equal on the card "
        "(%d card boxes); %d boxes without an equal hold a pixel binarized differently%s%s"
        % (len(pairs), base_cpu, base_gpu, excused,
           "; %d more lie in a text component that holds one" % by_component
           if components else "",
           "; %d more hold a pixel where the maps differ by over %g" % (by_moved, moved)
           if moved is not None else ""))
    return pairs, diff


def _fmt(margin):
    if isinstance(margin, (list, tuple)):
        return "[%s]" % ", ".join("%.3g" % m for m in margin)
    return "%.3g" % margin


def _holds_flip(points, flip_lo, flip_hi):
    """Whether the bounding rectangle of a box (flat x, y list), one pixel
    wider on each side, meets one of the rectangles [flip_lo, flip_hi]
    (K, 2) of page pixels (points where flip_lo == flip_hi)."""
    import numpy as np

    pts = np.asarray(points, np.float64).reshape(-1, 2)
    lo, hi = pts.min(0) - 1, pts.max(0) + 1
    return bool(((flip_lo <= hi) & (flip_hi >= lo)).all(1).any())


def compare_texts(ref, ocr32, cpu, f32, pairs, tag="slice-f32", excused=()):
    """Texts of the float32 slice on the card against the CPU run (`ref`,
    its text_reference). On the CPU's line crops (turned as the CPU's
    classifier turns them, where the slice has one), the argmax must agree
    at every step whose CPU top-2
    margin exceeds twice the largest CPU/card probability difference; then
    every equal box of compare_boxes must read the same on both, unless its
    line holds a step within that of a tie or is in `excused` (CPU lines
    whose cls label may differ)."""
    p_gpu = ocr32.recer.runner(ref["batch"]).float().cpu()
    p_cpu = ref["probs"]
    diff = float((p_gpu - p_cpu).abs().max())
    top2 = p_cpu.topk(2, dim=2).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * diff
    agree = p_gpu.argmax(2) == p_cpu.argmax(2)
    check(bool((agree | ~decisive).all()), "f32 CTC argmax differs at a decisive step")
    tied = (~decisive).any(dim=1).tolist()
    rows_cpu = [t for page in cpu for _, t, _ in page]
    rows_gpu = [t for page in f32 for _, t, _ in page]
    same = 0
    for _, k_cpu, k_gpu in pairs:
        got, want = rows_gpu[k_gpu], rows_cpu[k_cpu]
        same += got == want
        check(got == want or tied[k_cpu] or k_cpu in excused,
              "line %d: f32 text cuda %r != cpu %r" % (k_cpu, got, want))
    say(tag, "CTC probs max |cuda - cpu| %.3g; argmax equal at all %d decisive steps; "
        "texts equal on %d of the %d equal boxes (%d of all %d cpu lines hold a step within 2x "
        "that of a tie)" % (diff, int(decisive.sum()), same, len(pairs), sum(tied), len(rows_cpu)))


def match_iou(runs, refs, min_iou=0.5):
    """Per page, each box of `runs` greedily matched to the unmatched box of
    `refs` with the highest IoU of their bounding rectangles. Returns the
    number matched at `min_iou` or more, and how many of those share the
    text."""
    import numpy as np

    def rects(page):
        pts = np.array([np.reshape(b, (-1, 2)) for b, _, _ in page], np.float64).reshape(-1, 4, 2)
        return np.concatenate([pts.min(1), pts.max(1)], axis=1)

    matched = same = 0
    for page, ref in zip(runs, refs):
        if not page or not ref:
            continue
        a, b = rects(page), rects(ref)
        lo = np.maximum(a[:, None, :2], b[None, :, :2])
        hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
        inter = np.clip(hi - lo, 0, None).prod(-1)
        area = lambda r: (r[:, 2:] - r[:, :2]).prod(-1)  # noqa: E731
        iou = inter / (area(a)[:, None] + area(b)[None, :] - inter)
        for i in range(len(page)):
            j = int(iou[i].argmax())
            if iou[i, j] >= min_iou:
                iou[:, j] = -1.0
                matched += 1
                same += page[i][1] == ref[j][1]
    return matched, same


@beside
def card_events(fn):
    """The card's kernels and copies in one call of `fn`, from a torch.profiler
    trace of the card's activity (key_averages: one event per name, with its
    count and device time). The host's op events are not recorded: they
    carry their kernels' time again and cost the trace's post-processing
    seconds per 10,000 launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def device_time(fn, call_s, sums=()):
    """Card time of one call of `fn` (card_events): the time of the kernels
    and copies on the card summed (work that overlaps counts twice), as a
    share of `call_s`, the same call's unprofiled wall time, the five kernels
    that take the most, the total of the kernels whose name holds each string
    of `sums`, and the port's own kernels with the records the trace holds of
    them (the tracer can drop some)."""
    events = card_events(fn)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return "the trace holds no device time: not measured"
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    ours = [e for e in events if any(k in e.key for k in (
        "runmax_", "propagate_tile", "int8_conv_", "requant_kernel"))]
    totals = "".join("; all %s %.2f ms" % (name, sum(
        e.self_device_time_total for e in events if name in e.key) / 1e3) for name in sums)
    return "card busy %.1f ms of a %.1f ms call (%.1f%%); most: %s%s; the port's kernels: %s" % (
        busy_ms, call_s * 1e3, 100.0 * busy_ms / (call_s * 1e3),
        "; ".join("%s %.2f ms" % (e.key[:60], e.self_device_time_total / 1e3) for e in top),
        totals,
        "; ".join("%s %.3f ms over %d records" % (
            kernel_name(e.key), e.self_device_time_total / 1e3, e.count) for e in ours)
        or "none traced",
    )


@beside
def stage_breakdown(deter, pages, kind, recer=None, clser=None):
    """Host-clock stage times of one det (and, with `recer`, rec; with
    `clser`, cls before rec) pass over `pages`, each ending in a sync; the
    postprocess's device front half (`kind` db: db_front_half per page; pse,
    pan: the class's front_half, which holds the CC labelling and the
    expansion) is timed once more alone before the whole postprocess."""
    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy.common import padded_pow2_batch
    from pytorchocr_tpu_torch.deploy.run_ocr import crop_lines
    from pytorchocr_tpu_torch.ops.cc_label import db_front_half

    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    imgs = timed("decode", lambda: [cv2.imread(p) for p in pages])
    pre = timed("det_pre", lambda: [deter._preprocess(im) for im in imgs])
    batch, _ = padded_pow2_batch([p[0] for p in pre], combine=np.concatenate)
    shapes, _ = padded_pow2_batch([p[1] for p in pre], combine=np.concatenate)
    maps = timed("det_forward", lambda: deter.runner(batch))
    post_cls = deter.det_post_process_class
    if kind == "db":
        probs = maps["maps"][..., 0].float()
        timed("db_front_half", lambda: [
            db_front_half(probs[i], post_cls.thresh, post_cls.max_candidates)
            for i in range(len(pages))
        ])
    else:
        timed("%s_front_half" % kind, lambda: post_cls.front_half(maps["maps"]))
    post = timed("%s_post (front half + host tail)" % kind, lambda: post_cls(maps, shapes))
    if recer is not None:
        boxes = [post[i]["points"] for i in range(len(pages))]  # crop cost is order-free
        parts = timed("crops", lambda: [c for im, b in zip(imgs, boxes)
                                        for c in crop_lines(im, b)])
        if clser is not None:
            timed("cls", lambda: clser.run_batch(parts))
        timed("rec", lambda: recer.run_batch(parts))
    return ", ".join("%s %.1f ms" % (k, v * 1e3) for k, v in times.items())


TRAIN_CFG = os.path.join(REPO, "configs", "det", "det_r18_db_synth.yml")
# phase 11's run: 80 steps (20 epochs); 200 until the script ran past its
# time (the loss check held at 0.29 of the first 20 steps' mean there, and
# the loss at steps 40-80 already lay at 1.1-1.3 of 3.5)
TRAIN_PAGES, EVAL_PAGES, TRAIN_SIZE, TRAIN_BS, TRAIN_STEPS = 64, 8, 640, 16, 80


def make_train_pages(dirname, n, seed):
    """`n` synthetic TRAIN_SIZE-square pages of word-like text drawn with cv2
    (no font files), and their SimpleDataSet label file: per line the page's
    path and a json list of word boxes."""
    import cv2
    import numpy as np

    os.makedirs(dirname, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    lines = []
    for p in range(n):
        img = np.full((TRAIN_SIZE, TRAIN_SIZE, 3), int(rng.randint(200, 256)), np.uint8)
        words = []
        y = int(rng.randint(40, 70))
        while y < TRAIN_SIZE - 20:
            x = int(rng.randint(10, 120))
            scale = float(rng.uniform(0.7, 1.6))
            thick = int(rng.randint(1, 4))
            ink = tuple(int(v) for v in rng.randint(0, 90, 3))
            while x < TRAIN_SIZE - 160:
                word = "".join(rng.choice(letters, rng.randint(2, 8)))
                (tw, th), base = cv2.getTextSize(word, cv2.FONT_HERSHEY_SIMPLEX, scale, thick)
                cv2.putText(img, word, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale, ink, thick,
                            cv2.LINE_AA)
                words.append({"transcription": word, "points": [
                    [x, y - th], [x + tw, y - th], [x + tw, y + base], [x, y + base]]})
                x += tw + int(rng.randint(15, 50))
            y += int(rng.randint(45, 95))
        path = os.path.join(dirname, "page_%03d.png" % p)
        cv2.imwrite(path, img)
        lines.append("%s\t%s" % (path, json.dumps(words)))
    label = os.path.join(dirname, "label.txt")
    with open(label, "w") as f:
        f.write("\n".join(lines) + "\n")
    return label


def train_argv(out, train_label, eval_label, epochs, cfg=TRAIN_CFG):
    """A detection training config as published (by default
    det_r18_db_synth.yml at full width: ResNet-18, FPN 256, DBHead k=50, bs
    16 at 640x640, amsgrad + WarmupPolyLR, bf16 autocast), pointed at the
    drawn pages: eval and `latest` after the last epoch only."""
    return ["-c", cfg, "-o", "Global.save_model_dir=%s" % out,
            "Global.epoch_num=%d" % epochs, "Global.eval_epoch_step=[%d,1]" % (epochs - 1),
            "Global.save_latest_epoch_step=%d" % epochs, "Global.print_batch_step=20",
            "Train.dataset.label_file_list=[%s]" % train_label,
            "Eval.dataset.label_file_list=[%s]" % eval_label]


def first_batches(config, n, bs, label=None):
    """The first `n` batches of `bs` of the config's train loader, over
    `label` in place of its label files if given (whole epoch drained: no
    worker keeps drawing from the global generators)."""
    import copy

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.utils.logging import get_logger

    config = copy.deepcopy(config)
    config["Train"]["loader"]["batch_size_per_card"] = bs
    if label is not None:
        config["Train"]["dataset"]["label_file_list"] = [label]
    loader, _ = build_dataloader(config, "Train", get_logger(name="root"))
    return list(loader)[:n]


def train_parts(config, device, amp, schedule=None, wrap_loss=None, frozen=(), remat=False):
    """A model with the trainer's seeded init, its optimizer (the LR
    schedule over `schedule`, (epochs, steps an epoch); by default phase
    11's) and train step; `wrap_loss` wraps the step's loss; `frozen` and
    `remat` go to the step (trainer.make_train_step)."""
    from pytorchocr_tpu_torch.losses import build_loss
    from pytorchocr_tpu_torch.optimizer import build_optimizer
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.trainer import build_input_transform, make_train_step

    if schedule is None:
        schedule = (TRAIN_STEPS // (TRAIN_PAGES // TRAIN_BS), TRAIN_PAGES // TRAIN_BS)
    model = build_train_model(config, device)
    opt, _ = build_optimizer(config["Optimizer"], epochs=schedule[0],
                             step_each_epoch=schedule[1], parameters=model.parameters())
    spec = config["Global"].get("_device_normalize_spec", {}).get("Train")
    loss = build_loss(config["Loss"])
    step = make_train_step(model, wrap_loss(loss) if wrap_loss else loss, opt,
                           input_transform=build_input_transform(spec), amp=amp, frozen=frozen,
                           remat=remat)
    return model, opt, step


class Branches:
    """Which piece of each piecewise-linear function every element took in
    one run's model forward (relu's two, leaky_relu's two; relu6's and
    hardtanh's three, so hard_swish's and hard_sigmoid's at -3 and 3;
    max_pool2d's argmax; the integer that floor gives, so the corners and
    weights of the TPS's bilinear sampler, whose gradient with respect to the
    grid jumps where a coordinate crosses an integer; and the values of
    argmax and rand, so the tokens that SLAHead's scheduled sampling feeds
    back and its coins) and,
    where the loss is wrapped too, in its loss (abs's sign, clamp's three
    pieces, and the result of every comparison: OHEM's cut and the bisection
    that finds it), recorded there (`wrap` / `wrap_loss` with replay False)
    and taken again in another run (replay True). Where a value lies within
    rounding of a kink or a cut, or two pooled values within rounding of
    each other, a float32 and a float64 run take different pieces, whose
    derivatives differ by a whole unit: one such element moves the
    gradients of the layers under it by far more than rounding. A float64
    step that takes the card's pieces differs from the card's step by
    rounding alone. `flips` counts, by function, the elements whose own
    piece in the replaying run differs from the recorded one (pooled ties
    left out: either argmax gives the same value)."""

    KINKS = {"relu": (0.0, None), "relu6": (0.0, 6.0), "hardtanh": (-1.0, 1.0)}
    POOLS = ("_max_pool2d", "max_pool2d", "max_pool2d_with_indices")
    FLOORS = ("floor",)
    RECORDED = ("argmax", "rand")  # replayed as the recorded values
    POOL_ARGS = ("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode",
                 "return_indices")
    CLAMPS = ("clamp", "clip")
    COMPARISONS = ("__gt__", "__ge__", "__lt__", "__le__", "gt", "ge", "lt", "le", "greater",
                   "greater_equal", "less", "less_equal")

    def __init__(self):
        self.records, self.pos, self.flips = {}, {}, {}

    def wrap(self, model, replay):
        """Record or replay the pieces of `model`'s forward."""
        model.forward = self._wrapped(model.forward, "model", replay)
        return model

    def wrap_loss(self, loss, replay):
        """`loss` as a function whose pieces are recorded or replayed."""
        return self._wrapped(loss, "loss", replay)

    def _wrapped(self, fn, role, replay):
        from torch.overrides import TorchFunctionMode

        state = self
        loss = role == "loss"

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                name = getattr(func, "__name__", "")
                kwargs = kwargs or {}
                if name in Branches.KINKS:
                    return state._kink(role, name, func, args, kwargs, replay)
                if name == "leaky_relu":
                    return state._leaky(role, func, args, kwargs, replay)
                if name in Branches.RECORDED:
                    return state._recorded(role, name, func, args, kwargs, replay)
                if name in Branches.POOLS:
                    return state._pool(role, func, args, kwargs, replay)
                if name in Branches.FLOORS:
                    return state._floor(role, func, args, kwargs, replay)
                if loss and name in Branches.CLAMPS + ("abs",):
                    return state._kink(role, name, func, args, kwargs, replay)
                if loss and name in Branches.COMPARISONS:
                    return state._compare(role, func, args, kwargs, replay)
                if name.rstrip("_") in tuple(Branches.KINKS) + ("leaky_relu",) or (
                        loss and name.rstrip("_") in Branches.CLAMPS + ("abs",)):
                    raise NotImplementedError("Branches: in-place %s" % name)
                return func(*args, **kwargs)

        def wrapped(*args, **kwargs):
            if not replay:
                self.records[role] = []
            self.pos[role] = 0
            with Mode():
                out = fn(*args, **kwargs)
            if self.pos[role] != (len(self.records[role]) if replay else 0):
                raise RuntimeError("Branches: the replaying %s made %d of the %d recorded calls"
                                   % (role, self.pos[role], len(self.records[role])))
            return out

        return wrapped

    def _next(self, role, name, shape):
        i, records = self.pos[role], self.records[role]
        if i >= len(records) or records[i][0] != name or tuple(records[i][1].shape) != tuple(shape):
            raise RuntimeError("Branches: %s call %d is %s %s, not what was recorded" % (
                role, i, name, tuple(shape)))
        self.pos[role] += 1
        return records[i][1]

    def _count(self, name, n):
        self.flips[name] = self.flips.get(name, 0) + int(n)

    def _kink(self, role, name, func, args, kwargs, replay):
        """relu / relu6 / hardtanh / clamp: piece 0 below the low end, 1
        between (the gradient passes: open at the ends for the first three,
        closed for clamp, as their backward passes it), 2 above; abs: the
        sign (sgn(0) = 0 is its gradient at 0)."""
        import torch

        if name == "hardtanh":
            names = ("input", "min_val", "max_val", "inplace")
        elif name in Branches.CLAMPS:
            names = ("input", "min", "max")
        else:
            names = ("input", "inplace")
        v = dict(zip(names, args), **kwargs)
        if v.get("inplace"):
            raise NotImplementedError("Branches: in-place %s" % name)
        x = v["input"]
        lo, hi = Branches.KINKS.get(name, (None, None))
        lo, hi = v.get("min_val", v.get("min", lo)), v.get("max_val", v.get("max", hi))
        if any(torch.is_tensor(t) for t in (lo, hi)):
            raise NotImplementedError("Branches: %s with tensor bounds" % name)
        with torch.no_grad():
            if name == "abs":
                piece = torch.sign(x).to(torch.int8)
            elif name in Branches.CLAMPS:
                piece = torch.ones_like(x, dtype=torch.uint8)
                if lo is not None:
                    piece -= (x < lo).to(torch.uint8)
                if hi is not None:
                    piece += (x > hi).to(torch.uint8)
            else:
                piece = (x > lo).to(torch.uint8)
                if hi is not None:
                    piece += (x >= hi).to(torch.uint8)
        if not replay:
            self.records[role].append((name, piece))
            return func(*args, **kwargs)
        # the output keeps x's strides, as the function's own does (a conv
        # after it takes another path, and rounds otherwise, on other strides)
        card = torch.empty_like(piece).copy_(self._next(role, name, x.shape))
        self._count(name, (piece != card).sum())
        if name == "abs":
            return x * card.to(x.dtype)
        out = x if lo is None else torch.where(card == 0, torch.tensor(lo, dtype=x.dtype), x)
        if hi is not None:
            out = torch.where(card == 2, torch.tensor(hi, dtype=x.dtype), out)
        return out

    def _leaky(self, role, func, args, kwargs, replay):
        """leaky_relu: piece 1 above 0 (the gradient passes whole, as its
        backward takes x > 0), 0 at or below (negative_slope)."""
        import torch

        v = dict(zip(("input", "negative_slope", "inplace"), args), **kwargs)
        if v.get("inplace"):
            raise NotImplementedError("Branches: in-place leaky_relu")
        x, slope = v["input"], v.get("negative_slope", 0.01)
        with torch.no_grad():
            piece = (x > 0).to(torch.uint8)
        if not replay:
            self.records[role].append(("leaky_relu", piece))
            return func(*args, **kwargs)
        card = torch.empty_like(piece).copy_(self._next(role, "leaky_relu", x.shape))
        self._count("leaky_relu", (piece != card).sum())
        return torch.where(card == 1, x, x * slope)

    def _recorded(self, role, name, func, args, kwargs, replay):
        """argmax / rand: replayed as the recorded values (on this run's
        device), argmax's elements that differ counted."""
        import torch

        out = func(*args, **kwargs)
        if not replay:
            self.records[role].append((name, out.detach().clone()))
            return out
        card = self._next(role, name, out.shape).to(device=out.device, dtype=out.dtype)
        if name == "argmax":  # another run's rand draws differ from the card's by design
            self._count(name, (out != card).sum())
        return torch.empty_like(out).copy_(card)

    def _pool(self, role, func, args, kwargs, replay):
        import torch
        import torch.nn.functional as F

        v = dict(zip(Branches.POOL_ARGS, args), **kwargs)
        x = v["input"]
        pool = dict(kernel_size=v["kernel_size"], stride=v.get("stride") or v["kernel_size"],
                    padding=v.get("padding", 0), dilation=v.get("dilation", 1),
                    ceil_mode=v.get("ceil_mode", False))
        if not replay:
            with torch.no_grad():
                _, idx = F.max_pool2d_with_indices(x, **pool)
            self.records[role].append(("max_pool2d", idx))
            return func(*args, **kwargs)
        own, own_idx = F.max_pool2d_with_indices(x, **pool)
        idx = self._next(role, "max_pool2d", own.shape).to(x.device)
        out = torch.empty_like(own).copy_(x.flatten(2).gather(2, idx.flatten(2)).view_as(own))
        with torch.no_grad():
            self._count("max_pool2d", ((idx != own_idx) & (out != own)).sum())
        return (out, idx) if v.get("return_indices") else out

    def _floor(self, role, func, args, kwargs, replay):
        """floor: the integer each element takes (its gradient is 0 either
        way); replayed as the recorded integers in the input's dtype."""
        import torch

        out = func(*args, **kwargs)
        if not replay:
            self.records[role].append(("floor", out.detach().clone()))
            return out
        card = self._next(role, "floor", out.shape).to(device=out.device, dtype=out.dtype)
        self._count("floor", (out != card).sum())
        return torch.empty_like(out).copy_(card)

    def _compare(self, role, func, args, kwargs, replay):
        import torch

        out = func(*args, **kwargs)
        if not torch.is_tensor(out):
            return out
        if not replay:
            self.records[role].append(("comparison", out))
            return out
        card = torch.empty_like(out).copy_(self._next(role, "comparison", out.shape))
        self._count("comparison", (out != card).sum())
        return card

    def report(self):
        return ", ".join("%s %d" % kv for kv in sorted(self.flips.items())) or "none recorded"


def f64_reference_step(config, batch, schedule=None, select=None, branches=None,
                       loss_pieces=False, prepare=None):
    """The same train step on the CPU in float64 (model, input, labels and
    loss; the DB head's sigmoids stay float32, as the module computes them):
    the reference the card's float32 step is held to. The CPU's own float32
    step lands several times further from it than the card's (phase 11
    reports both), so the CPU's float32 is no reference. `select` replaces
    the loss's `select` (PSE/PAN: the masks it thresholds out of the
    predictions); `branches` (a recorded Branches) makes its forward, and
    with `loss_pieces` its loss, take the card's pieces (SLAHead's coins
    and fed-back tokens too: a head that takes a generator gets one, whose
    draws the card's replace); `prepare(model)` changes the seeded weights
    first, as card_step's does."""
    import torch

    from pytorchocr_tpu_torch.losses import build_loss
    from pytorchocr_tpu_torch.trainer import (batch_to_device, build_input_transform, float_preds,
                                              takes_generator)

    cpu = torch.device("cpu")
    model, opt, _ = train_parts(config, cpu, amp=False, schedule=schedule)
    if prepare is not None:
        prepare(model)
    model.double().train()
    if branches is not None:
        branches.wrap(model, replay=True)
    b = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
              for x in batch_to_device(batch, cpu))
    transform = build_input_transform(
        config["Global"].get("_device_normalize_spec", {}).get("Train"))
    x = b[0] if transform is None else transform(b[0])
    kw = {"generator": torch.Generator()} if takes_generator(model) else {}  # coins replayed
    preds = model(x.double().permute(0, 3, 1, 2), data=b, **kw)
    loss = build_loss(config["Loss"])
    if select is not None:
        loss.select = select
    if loss_pieces:
        loss = branches.wrap_loss(loss, replay=True)
    losses = loss(float_preds(preds, torch.float64), b)
    opt.zero_grad(set_to_none=True)
    losses["loss"].backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    return model, opt, {k: float(v.detach()) for k, v in losses.items()}, grads


def card_step(config, dev, batch, tf32, schedule=None, branches=None, replay=False,
              loss_pieces=False, prepare=None):
    """One float32 train step through the trainer's step on `dev` from the
    seeded weights, TF32 on or off: (losses, gradients, state_dict after the
    update, parameters before it), on the CPU in float64. `branches` records
    the pieces of the piecewise-linear functions that its forward (and with
    `loss_pieces` its loss) takes (Branches), or with `replay` makes it take
    the recorded ones. `prepare(model)` changes the seeded weights first (a
    CPU generator's draws, so every run gets the same)."""
    import torch

    from pytorchocr_tpu_torch.trainer import batch_to_device

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        wrap_loss = (lambda loss: branches.wrap_loss(loss, replay)) if loss_pieces else None
        model, _, step = train_parts(config, dev, amp=False, schedule=schedule,
                                     wrap_loss=wrap_loss)
        if prepare is not None:
            prepare(model)
        if branches is not None:
            branches.wrap(model, replay)
        p0 = {k: v.detach().double().cpu() for k, v in model.named_parameters()}
        losses = {k: float(v) for k, v in step(batch_to_device(batch, dev)).items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    return losses, grads, {k: v.double().cpu() for k, v in model.state_dict().items()}, p0


# the worst relative L2 of a gradient leaf that the card's float32 step may
# show against the float64 step: between the TF32-off and TF32-on readings
# (3.73e-3 and 1.67e-1 on an H100, chip_smoke.py phase 11)
GRAD_LIMIT = 2e-2
# phases 12-13: the card's float32 step lands further from float64 than the
# CPU's float32 step in some leaves (CRNN up to 8.1x the CPU's worst error in
# a leaf: CUDA's float32 F.ctc_loss gradient, which computed in float64 takes
# every leaf under 0.5x; the classifier up to 1.7x, spread over the leaves,
# no single piece: chip_f32_steps.py --swap, ROADMAP.md C), so a leaf's floor
# is also this share of its largest |g|: between the worst TF32-off reading of the error
# over a leaf's largest |g| and the least TF32-on one (CRNN 1.49e-2 and
# 4.42e-2 over five runs, classifier 5.48e-3 and 6.48e-2 over four, on an
# NVIDIA H100 80GB HBM3, 700 W)
ELEM_SCALE = 2.5e-2


def db_zero_grad_leaves(g_ref):
    """DB's biases whose gradient is 0 up to rounding: the deconv1 biases,
    which feed a train-mode BN."""
    return {k for k in g_ref if k.endswith("deconv1.bias")}


def db_student_zero_grad(g_ref):
    """Phase 19's det students: DB's deconv1 biases and the MobileNetV3
    biases that feed a train-mode BN."""
    return db_zero_grad_leaves(g_ref) | bn_fed_biases(g_ref)


def bn_fed_biases(g_ref):
    """Biases whose float64 gradient is under 1e-4 of their weight's: a
    conv's bias that feeds a train-mode BN, whose gradient is 0 up to
    rounding (the VGG and MobileNetV3 convs)."""
    return {k for k in g_ref if k.endswith(".bias") and k[:-4] + "weight" in g_ref
            and float(g_ref[k].norm()) < 1e-4 * float(g_ref[k[:-4] + "weight"].norm())}


def held_step(step, ref, floor, lr, skip=frozenset(), focus=None):
    """How far a card step `step` (card_step's tuple) lands from the float64
    reference `ref` (losses, gradients, state_dict), each leaf's rounding
    floor `floor` being the CPU float32 step's worst gradient error in that
    leaf (the card does not enter it): the worst relative loss error; the
    worst gradient leaf by relative L2 (and among the leaves whose name
    holds `focus`); `elem`, the worst leaf's largest elementwise gradient
    error over its floor; the parameters after the update, which may move
    up to 2 lr where the reference gradient is within rounding of 0 (|g| at
    most the floor, or under 1e-6: Adam's eps region) and elsewhere within
    1e-2 lr + 1e-6 |p|; and the BN running statistics. `margin` is the least
    ratio of a leaf's floor to the largest |g| that needed it: how many
    times smaller the floors could be and still excuse every move past 1e-2
    lr. The leaves of `skip` (gradient 0 up to rounding) stay out of the
    gradient figures. `first` names the first parameter past its bound:
    its leaf, |diff| / lr, the two gradients and p before the update."""
    l_card, g_card, card_sd, p0 = step
    l_ref, g_ref, ref_sd = ref
    loss = max((abs(l_card[k] - l_ref[k]) / abs(l_ref[k]), k) for k in l_ref)
    worst, elem, focused = (0.0, ""), (0.0, ""), (0.0, "")
    leaves = []  # (elementwise error over the floor, name, over max |g| of the leaf)
    rels = {}  # relative L2 of each held leaf
    for k, g in g_ref.items():
        if k not in skip:
            rel = (float((g_card[k] - g).norm() / g.norm()), k)
            rels[k] = rel[0]
            worst = max(worst, rel)
            if focus and focus in k:
                focused = max(focused, rel)
            err = float((g_card[k] - g).abs().max())
            elem = max(elem, (err / floor[k], k))
            leaves.append((err / floor[k], k, err / float(g.abs().max())))
    excused = total = outside = 0
    margin = float("inf")
    first = None
    for k, g in g_ref.items():
        diff = (card_sd[k] - ref_sd[k]).abs()
        near0 = (g.abs() <= floor[k]) | (g.abs() < 1e-6)
        moved = (diff > 1e-2 * lr + 1e-6 * p0[k].abs()) & (g.abs() >= 1e-6)
        past = (near0 & (diff > 2 * lr)) | (moved & ~near0)
        outside += int(past.sum())
        if first is None and past.any():
            i = int(past.flatten().nonzero()[0])
            first = "%s[%d]: %.6g lr from the float64 step, gradient %.3g (card %.3g), p %.6g" % (
                k, i, float(diff.flatten()[i]) / lr, float(g.flatten()[i]),
                float(g_card[k].flatten()[i]), float(p0[k].flatten()[i]))
        if moved.any():
            margin = min(margin, floor[k] / float(g.abs()[moved].max()))
        excused += int(near0.sum())
        total += g.numel()
    bn = 0.0  # |diff| / (|v| + 1e-2): relative, absolute near 0
    for k, v in ref_sd.items():
        if "running" in k:
            bn = max(bn, float(((card_sd[k] - v).abs() / (v.abs() + 1e-2)).max()))
    return dict(value=l_card["loss"], loss=loss, grad=worst, focused=focused, elem=elem,
                outside=outside, first=first, excused=excused, total=total, margin=margin, bn=bn,
                leaves=sorted(leaves, reverse=True), rels=rels)


def compare_f32_step(config, dev, batch, card, what="bs 2, %dx%d" % (TRAIN_SIZE, TRAIN_SIZE),
                     tag="train-f32", schedule=None, zero_grad=db_zero_grad_leaves,
                     focus=None, card_floors=False, explained=None, select=None,
                     loss_pieces=False, prepare=None):
    """One float32 train step (TF32 off) through the trainer's step on the
    card against the float64 reference on the CPU (f64_reference_step), from
    the same seeded weights and batch: the loss and its terms (rtol 1e-4),
    every gradient (relative L2 <= GRAD_LIMIT, and elementwise within the
    CPU float32 step's worst error in its leaf; the leaves `zero_grad`
    names, biases that feed a train-mode BN and so have gradient 0 up to
    rounding, by a norm under 1e-4 of their weight's gradient norm), the
    parameters after the update (held_step) and the BN running statistics
    (|diff| <= 1e-3 (|v| + 1e-2)). The control: the same step with TF32 on
    must fail the gradient limit (with `card_floors`, the relative L2 limit
    or the elementwise one), or the limits tell float32 from TF32 apart no
    more. With `card_floors` (phases 12-13) a leaf's floor is the larger of
    its CPU float32 error and ELEM_SCALE of its largest |g|, in the
    elementwise figure and in held_step's rounding-of-0 region alike.
    `focus` (a name part, e.g. the LSTM's "rnn.") adds that group's worst
    gradient, TF32 off and on, to the report. `explained` maps loss terms
    that only log a binarisation of the predictions (PSE/PAN's IoUs) to the
    value they take on the card's own binarisation: where a pixel lies
    within rounding of the threshold the two runs binarise it differently,
    so such a term is held to that value (1e-6) and its float64 value is
    reported beside it. `select` goes to the float64 step (f64_reference_step).
    The float64 step and the CPU float32 step (the floors) take the pieces
    of the piecewise-linear functions that the card's TF32-off forward took
    (Branches), and with `loss_pieces` those of its loss and its
    comparisons (phase 11: DB's OHEM cut, its L1's sign, its BCE's clamp);
    the elements where they would have taken another piece are counted and
    reported. `prepare(model)` changes the seeded weights of every step
    alike (phase 17: STAR-Net's TPS off its RARE init). The float64 and CPU
    float32 steps run in the CPU reference process (f64_steps); this
    returns a function that waits for them and makes the checks and the
    report (held_f32_step), so the card goes on meanwhile. The returned
    function returns (got, control), held_step's readings."""
    name = tag.split("-")[0]
    branches = Branches()
    step = card_step(config, dev, batch, tf32=False, schedule=schedule, branches=branches,
                     loss_pieces=loss_pieces, prepare=prepare)
    records = {role: [(kind, t.cpu()) for kind, t in recs]
               for role, recs in branches.records.items()}
    job = cpu_job(f64_steps, config, batch, schedule, select, records, loss_pieces, prepare)
    control_step = card_step(config, dev, batch, tf32=True, schedule=schedule, prepare=prepare)
    return lambda: held_f32_step(job.result(), step, control_step, name, card, what, tag,
                                 zero_grad, focus, card_floors, explained, loss_pieces)


def f64_steps(config, batch, schedule, select, records, loss_pieces, prepare):
    """compare_f32_step's CPU work (a job of the CPU reference process): the
    float64 reference step and the CPU float32 step, both taking the card's
    pieces (`records`, a Branches' records on the CPU)."""
    import torch

    branches = Branches()
    branches.records = records
    m_ref, opt, l_ref, g_ref = f64_reference_step(config, batch, schedule, select, branches,
                                                  loss_pieces, prepare)
    f64_flips, branches.flips = branches.report(), {}
    l_cpu, g_cpu32 = card_step(config, torch.device("cpu"), batch, tf32=False,
                               schedule=schedule, branches=branches, replay=True,
                               loss_pieces=loss_pieces, prepare=prepare)[:2]
    return dict(l_ref=l_ref, g_ref=g_ref, ref_sd=m_ref.state_dict(),
                lr=float(opt.lr_schedule(0)), f64_flips=f64_flips, cpu_flips=branches.report(),
                l_cpu=l_cpu["loss"],
                floor={k: float((g - g_ref[k]).abs().max()) for k, g in g_cpu32.items()},
                rel_cpu={k: float((g - g_ref[k]).norm() / g_ref[k].norm())
                         for k, g in g_cpu32.items()})


def held_f32_step(steps, step, control_step, name, card, what, tag, zero_grad, focus, card_floors,
                  explained, loss_pieces):
    """compare_f32_step's checks and report, on f64_steps's result `steps`."""
    l_ref, g_ref = steps["l_ref"], steps["g_ref"]
    ref = l_ref, g_ref, steps["ref_sd"]
    skip = zero_grad(g_ref)
    l_cpu, floor, lr = steps["l_cpu"], steps["floor"], steps["lr"]
    rel_cpu = {k: v for k, v in steps["rel_cpu"].items() if k not in skip}
    g_cpu = max(rel_cpu.values())
    if card_floors:
        floor = {k: max(f, ELEM_SCALE * float(g_ref[k].abs().max())) for k, f in floor.items()}
    got = held_step(step, ref, floor, lr, skip, focus)
    control = held_step(control_step, ref, floor, lr, skip, focus)
    l_card, g_card = step[:2]
    floor_name = ("floor (the larger of its CPU float32 worst error and %g of its largest |g|)"
                  % ELEM_SCALE if card_floors else "CPU float32 worst error")
    for what_, r in (("TF32 off", got), ("TF32 on", control)):
        say(tag, "%s, the leaves furthest from the float64 step against their %s: %s (error "
            "over the floor, error over the leaf's largest |g|); the worst error over a leaf's "
            "largest |g| %.3g" % (
                what_, floor_name,
                "; ".join("%s %.3g, %.3g" % (k, e, sc) for e, k, sc in r["leaves"][:4]),
                max(sc for _, _, sc in r["leaves"])))
    check(set(g_card) == set(g_ref), "%s f32 step: the card's trained leaves differ" % name)
    explained = explained or {}
    for k in l_ref:
        if k in explained:
            check(abs(l_card[k] - explained[k]) <= 1e-6, "%s f32 step: %s %.7g on the card, "
                  "%.7g on its own binarised maps (%s)" % (name, k, l_card[k], explained[k], what))
            continue
        check(abs(l_card[k] - l_ref[k]) <= 1e-4 * abs(l_ref[k]),
              "%s f32 step: %s %.7g on the card against %.7g (CPU float64; %s)"
              % (name, k, l_card[k], l_ref[k], what))
    for k in skip:
        scale = 1e-4 * float(g_ref[k[:-4] + "weight"].norm())
        check(float(g_ref[k].norm()) < scale and float(g_card[k].norm()) < scale,
              "%s f32 step: %s has a gradient" % (name, k))
    def over_limit(step_):
        g = step_[1]
        return max((float((g[k] - g_ref[k]).norm() / g_ref[k].norm()) / GRAD_LIMIT, k)
                   for k in rel_cpu)

    over, over_control = over_limit(step), over_limit(control_step)
    check(over[0] <= 1.0, "%s f32 step: gradient %s off by %.3g of the relative-L2 limit %.3g"
          % (name, over[1], over[0], GRAD_LIMIT))
    check(got["elem"][0] <= 1.0, "%s f32 step: gradient %s off by %.3g of its leaf's %s"
          % ((name,) + got["elem"][::-1] + (floor_name,)))
    check(got["outside"] == 0, "%s f32 step: %d parameters moved past their bound after the "
          "update; the first: %s" % (name, got["outside"], got["first"]))
    check(got["bn"] <= 1e-3, "%s f32 step: BN running statistics off by %.3g" % (name, got["bn"]))
    check(over_control[0] > 1.0 or (card_floors and control["elem"][0] > 1.0),
          "%s f32 step: the TF32 control's worst gradient is %.3g of its limit%s"
          % (name, over_control[0], " and elementwise within its floor (%.3g of it)"
             % control["elem"][0] if card_floors else ""))
    say(tag, "one float32 step (%s, TF32 off) through the trainer's step on %s "
        "against the same step in float64 on the CPU: loss %.6f against %.6f (rtol 1e-4, each "
        "term too), gradients worst %.2e relative L2 (%s; limit %s) and elementwise at most "
        "%.3g of the leaf's %s (%s; limit 1), parameters within 1e-2 lr but %d of %d elements "
        "whose float64 gradient is within rounding of 0 (under that floor or 1e-6; within 2 lr "
        "= %.2e; the floors could be %.3g times smaller), BN running statistics worst %.2e of "
        "|v| + 1e-2; %d biases that feed a train-mode BN at gradient 0 on both"
        % (what, card, l_card["loss"], l_ref["loss"], got["grad"][0], got["grad"][1],
           "%.0e" % GRAD_LIMIT,
           got["elem"][0], floor_name, got["elem"][1], got["excused"], got["total"],
           2 * lr, got["margin"], got["bn"], len(skip)))
    say(tag, "the control, the same step with TF32 on: loss %.6f (worst term %.2e "
        "relative), gradients worst %.2e relative L2 (%s) and elementwise %.3g of the "
        "floor, %d parameters past their bound, BN statistics worst %.2e; the CPU's own "
        "float32 step (a report): loss %.6f, gradients worst %.2e relative L2"
        % (control["value"], control["loss"][0], control["grad"][0], control["grad"][1],
           control["elem"][0], control["outside"], control["bn"], l_cpu, g_cpu))
    got["pieces"] = "float64 %s; CPU float32 %s" % (steps["f64_flips"], steps["cpu_flips"])
    say(tag, "elements on another piece of a piecewise-linear function (or another side of "
        "a comparison) of the %s than on the card with TF32 off, by function (the float64 "
        "and CPU float32 steps take the card's): %s"
        % ("forward and the loss" if loss_pieces else "forward", got["pieces"]))
    if explained:
        say(tag, "the binarisation logs, on the card / on the card's binarised maps recomputed "
            "/ in float64: %s" % ", ".join("%s %.7f / %.7f / %.7f" % (
                k, l_card[k], v, l_ref[k]) for k, v in sorted(explained.items())))
    if focus:
        say(tag, "the leaves holding %r: worst gradient %.2e relative L2 with TF32 off (%s), "
            "%.2e with TF32 on (%s)" % (focus, got["focused"][0], got["focused"][1],
                                        control["focused"][0], control["focused"][1]))
    return got, control


@quiet
def loader_breakdown(config, label, n=8):
    """Host ms per sample of each op of the config's train chain, one thread,
    over the first `n` pages of `label` (decode included: it is cached after
    the first epoch), and the polygons a sample keeps after the crop."""
    import numpy as np

    from pytorchocr_tpu_torch.data import create_operators

    ops = create_operators(config["Train"]["dataset"]["transforms"], config["Global"])
    times = {type(op).__name__: 0.0 for op in ops}
    polys = []
    lines = open(label).read().splitlines()[:n]
    for line in lines:
        path, text = line.split("\t")
        with open(path, "rb") as f:
            data = {"img_path": path, "label": text, "image": f.read()}
        for op in ops:
            t0 = time.perf_counter()
            data = op(data)
            times[type(op).__name__] += time.perf_counter() - t0
            if type(op).__name__ in ("FusedDetAugCrop", "EastRandomCropData"):
                polys.append(len(data["polys"]))
    return ", ".join("%s %.2f" % (k, 1e3 * v / len(lines)) for k, v in times.items()), \
        float(np.mean(polys)) if polys else None


def checkpoint_round_trip(config, dev, batches, tmp, tag="train-ckpt", schedule=None):
    """Save `latest` after step 1, load it into a fresh model and optimizer,
    take step 2: bit for bit the uninterrupted run's step 2 (float32, cuDNN
    deterministic)."""
    import copy

    import torch

    from pytorchocr_tpu_torch.trainer import batch_to_device
    from pytorchocr_tpu_torch.utils.save_load import load_model, save_model

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        b1, b2 = (batch_to_device(b, dev) for b in batches[:2])
        model, opt, step = train_parts(config, dev, amp=False, schedule=schedule)
        step(b1)
        out = os.path.join(tmp, tag)
        save_model(model, opt, {"start_epoch": 0, "global_step": 1, "best_model": {}}, out,
                   prefix="latest")
        step(b2)
        fresh, fresh_opt, fresh_step = train_parts(config, dev, amp=False, schedule=schedule)
        cfg = copy.deepcopy(config)
        cfg["Global"]["checkpoints"] = os.path.join(out, "latest")
        check(load_model(cfg, fresh, fresh_opt)["global_step"] == 1, "%s: global_state" % tag)
        fresh_step(b2)
        torch.cuda.synchronize()
        worst, n = 0.0, 0
        for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
            n += 1
            if not torch.equal(a, b):
                worst = max(worst, float((a.double() - b.double()).abs().max()))
        for p, q in zip(opt.param_groups[0]["params"], fresh_opt.param_groups[0]["params"]):
            for key in ("mu", "nu", "nu_max"):
                if not torch.equal(opt.state[p][key], fresh_opt.state[q][key]):
                    worst = max(worst, float((opt.state[p][key] - fresh_opt.state[q][key])
                                             .abs().max()))
        check(worst == 0.0, "%s: the resumed step differs by %.3g" % (tag, worst))
        say(tag, "save latest after step 1, load into a fresh model and optimizer, "
            "step 2: equal bit for bit to the uninterrupted step 2 (%d state tensors and the "
            "amsgrad moments; float32, cuDNN deterministic)" % n)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


class recorded_kernels:
    """Inside the block every K1 call (cc_label.segmented_runmax) and every
    K2 call (propagate.propagate_rounds) is recorded, inputs and outputs
    cloned, with the kernels' counts set to 0 on entry and read on exit;
    `hold(tag)` then holds each call, with its changed flag, to the plain
    version (segmented_runmax_ref, propagate_rounds_ref) exactly and returns
    the calls by shape."""

    def __enter__(self):
        import torch

        from pytorchocr_tpu_torch.ops import cc_label, propagate, runmax

        self.k1, self.k2 = [], []
        self.wrapped = cc_label.segmented_runmax, propagate.propagate_rounds
        k1, k2 = self.wrapped

        def record_k1(vals, mask, axis, prev=None):
            out = k1(vals, mask, axis, prev)
            got, changed = (out, None) if prev is None else out
            self.k1.append((axis,) + tuple(None if t is None else t.clone()
                                           for t in (vals, mask, prev, got, changed)))
            return out

        def record_k2(labels, mask, fill_only):
            out = k2(labels, mask, fill_only)
            self.k2.append((fill_only, labels.clone(), mask.clone(), out[0].clone(),
                            out[1].clone()))
            return out

        runmax.launches = propagate.launches = cc_label.alternations = 0
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        cc_label.segmented_runmax, propagate.propagate_rounds = record_k1, record_k2
        return self

    def __exit__(self, *exc):
        from pytorchocr_tpu_torch.ops import cc_label, propagate, runmax

        cc_label.segmented_runmax, propagate.propagate_rounds = self.wrapped
        self.k1_launches, self.k2_launches = runmax.launches, propagate.launches
        self.alternations = cc_label.alternations

    def hold(self, tag):
        import torch

        from pytorchocr_tpu_torch.ops import propagate, runmax

        check(len(self.k1) == self.k1_launches and len(self.k2) == self.k2_launches,
              "%s: %d K1 and %d K2 calls recorded for %d and %d launches"
              % (tag, len(self.k1), len(self.k2), self.k1_launches, self.k2_launches))
        shapes = {}
        for axis, vals, mask, prev, got, changed in self.k1:
            want = runmax.segmented_runmax_ref(vals, mask, axis)
            check(torch.equal(got, want), "%s: runmax %s axis %d differs from the plain "
                  "version" % (tag, tuple(vals.shape), axis))
            if prev is not None:
                check(int(changed.item()) == int((want != prev).any()),
                      "%s: runmax changed flag at %s" % (tag, tuple(vals.shape)))
            key = "K1 %dx%d axis %d" % (tuple(vals.shape) + (axis,))
            shapes[key] = shapes.get(key, 0) + 1
        for fill_only, labels, mask, got, changed in self.k2:
            want, want_changed = propagate.propagate_rounds_ref(labels, mask, fill_only)
            check(torch.equal(got, want) and torch.equal(changed, want_changed),
                  "%s: propagate %s (fill %s) differs from the plain version, or its changed "
                  "flag does" % (tag, tuple(labels.shape), fill_only))
            key = "K2 %dx%d %s" % (tuple(labels.shape) + ("fill" if fill_only else "CC",))
            shapes[key] = shapes.get(key, 0) + 1
        self.k1 = self.k2 = None
        return ", ".join("%s: %d" % kv for kv in sorted(shapes.items()))


def phase_train(dev, card, tmp):
    """The training slice (phase 11). Returns K1's launches on the
    training-eval path and the drawn pages' train and eval label files."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.utils.logging import get_logger

    from pytorchocr_tpu_torch import native

    t_phase = time.perf_counter()
    check(native.native_available(), "the native geometry library (g++) did not build: "
          "MakeBorderMap would take its numpy path")
    logger = get_logger(name="root")  # the CLI's logger: its console at WARNING here
    for h in logger.handlers:
        h.setLevel(logging.WARNING)
    train_label = make_train_pages(os.path.join(tmp, "train"), TRAIN_PAGES, SEED + 11)
    eval_label = make_train_pages(os.path.join(tmp, "eval"), EVAL_PAGES, SEED + 12)
    epochs = TRAIN_STEPS // (TRAIN_PAGES // TRAIN_BS)
    out = os.path.join(tmp, "train_out")
    argv = train_argv(out, train_label, eval_label, epochs)
    config = program.preprocess(is_train=True, argv=argv)[0]
    ops_ms, polys = loader_breakdown(config, train_label)
    say("train-loader", "host ms per sample, one thread: %s (%.1f polygons a sample after the "
        "crop; the native border map)" % (ops_ms, polys))
    batches = first_batches(config, 2, 2)
    f32_check = compare_f32_step(config, dev, batches[0], card, loss_pieces=True)
    checkpoint_round_trip(config, dev, batches, tmp)

    # the entry point, as `python -m pytorchocr_tpu_torch.tools.train` runs it;
    # every K1 call of its evaluate is recorded and held to the plain version after
    with recorded_kernels() as rec:
        report, run_s = train_run(argv)
    k1 = rec.k1_launches
    shapes = rec.hold("train-eval")
    losses = report["losses"]
    check(report["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          "train: %d steps, not %d" % (report["steps"], TRAIN_STEPS))
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(last < 0.5 * first, "train: the loss fell from %.4f to %.4f only" % (first, last))
    check(k1 > 0, "train: the evaluate after training launched no run-max kernel")
    best = report["best"]
    say("train", "det_r18_db_synth.yml through tools.train.run: %d steps of bs %d at %dx%d, bf16 "
        "autocast, on %d drawn pages; mean loss of the first 20 steps %.4f, of the last 20 %.4f; "
        "loss every 20 steps: %s" % (
            report["steps"], TRAIN_BS, TRAIN_SIZE, TRAIN_SIZE, TRAIN_PAGES, first, last,
            ", ".join("%.3f" % v for v in losses[::20])))
    say("train", "%.3f steps/s, %.1f samples/s over the train iterations (%.1f s of %.1f s in "
        "the call); loader wait %.1f%% of it, the batches' host-to-device copies (with the "
        "wait for the step before them) %.1f%%; %s"
        % (report["steps"] / report["wall_s"], report["samples"] / report["wall_s"],
           report["wall_s"], run_s, 100.0 * report["reader_s"] / report["wall_s"],
           100.0 * report["copy_s"] / report["wall_s"], card))
    say("train-eval", "bucketed evaluate after the last epoch on %d pages: runmax.launches %d "
        "(alternations %d), each launch's output == the plain version on its inputs (%s), "
        "hmean %.4f, precision %.4f, recall %.4f, %.2f pages/s (its first call, recording "
        "each launch's inputs) on %s"
        % (EVAL_PAGES, k1, rec.alternations, shapes, best["hmean"], best["precision"],
           best["recall"], best["fps"], card))

    eval_argv = argv + ["Global.checkpoints=%s" % os.path.join(out, "latest")]
    eval_run(eval_argv)
    metric = eval_run(eval_argv)  # warm: cuDNN has seen the shapes
    say("train-eval", "tools.eval.run on the latest checkpoint, second call: hmean %.4f (the "
        "train run's %.4f), %.2f pages/s on %s" % (metric["hmean"], best["hmean"], metric["fps"],
                                                    card))
    later(f32_check)

    say("train", "profiler, %d train steps with their loader waits: %s on %s"
        % (PROFILE_STEPS, profile_loop(config, dev, metric=False,
                                       sums=("reduce_kernel", "batch_norm")), card))
    say("train", "phase 11 took %.1f s" % (time.perf_counter() - t_phase))
    return k1, train_label, eval_label


REC_TRAIN_CFG = os.path.join(REPO, "configs", "rec", "rec_vgg_bilstm_ctc_synth.yml")
CLS_TRAIN_CFG = os.path.join(REPO, "configs", "cls", "cls_mbv3small_synth.yml")
# phases 12 and 13: drawn lines (train, eval), batch, steps of tools.train.run
LINES_TRAIN, LINES_EVAL, LINES_BS = 2560, 512, 128
# (rates, the eval CLI and serving: 2 epochs each; the convergence checks
# run on the fixed batch)
LINES_STEPS = {"rec": 40, "cls": 40}
F32_BS = 8  # the float32-against-float64 step and the checkpoint round trip
# phases 12 and 13's convergence check, written down in PERF.md before the
# first run that checked it: one fixed batch of 128 drawn lines, no
# augmentation, bf16, Adam at a constant LR of 3e-3 as tests/test_overfit.py
# trains the JAX CRNN; the eval-mode forward must give back >= 120 of the 128
# strings (rec) or directions (cls) within 3,000 steps (read every 50).
# Phase 13 held the classifier to an eval accuracy >= 0.8 after 800 steps
# through tools.train.run before (500 steps read 0.7852-0.9453 over seven
# runs, the loader's 8 threads drawing other batches in every run; 800 steps
# read 0.9824 and took 225.6 s of the script's 866.7 s on an H100's host):
# that run now takes 40 steps, for the rates, the eval CLI and serving, and
# the fixed batch holds the convergence (PERF.md, section 6)
OVERFIT_N, OVERFIT_HITS, OVERFIT_CAP, OVERFIT_EVERY = 128, 120, 3000, 50
OVERFIT_OPTIMIZER = {"base_lr": 3e-3, "optim": {"name": "Adam"}}
ALNUM = "0123456789abcdefghijklmnopqrstuvwxyz"
HERSHEY = ("FONT_HERSHEY_SIMPLEX", "FONT_HERSHEY_DUPLEX", "FONT_HERSHEY_COMPLEX",
           "FONT_HERSHEY_TRIPLEX")


def make_lines(dirname, n, seed, lengths=(1, 25), turn_half=False):
    """`n` text lines of `lengths` lowercase alphanumerics drawn with cv2's
    Hershey fonts (no font files), each on its own cropped image, and their
    SimpleDataSet label file: the text, or with `turn_half` the direction,
    half of the lines turned by 180 degrees and labelled "180"."""
    import cv2
    import numpy as np

    os.makedirs(dirname, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        text = "".join(rng.choice(list(ALNUM), rng.randint(lengths[0], lengths[1] + 1)))
        font = getattr(cv2, HERSHEY[rng.randint(len(HERSHEY))])
        scale, thick = float(rng.uniform(0.6, 1.2)), int(rng.randint(1, 3))
        (tw, th), base = cv2.getTextSize(text, font, scale, thick)
        top, bottom, left, right = (int(v) for v in rng.randint(2, 9, 4))
        img = np.full((th + base + top + bottom, tw + left + right, 3),
                      int(rng.randint(170, 256)), np.uint8)
        cv2.putText(img, text, (left, top + th), font, scale,
                    tuple(int(v) for v in rng.randint(0, 90, 3)), thick, cv2.LINE_AA)
        label = text
        if turn_half:
            label = "180" if i % 2 else "0"
            if label == "180":
                img = cv2.rotate(img, cv2.ROTATE_180)
        path = os.path.join(dirname, "line_%05d.png" % i)
        cv2.imwrite(path, img)
        lines.append("%s\t%s" % (path, label))
    label_file = os.path.join(dirname, "label.txt")
    with open(label_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    return label_file


def lines_argv(cfg, out, train_label, eval_label, epochs):
    """A rec or cls training config as published, pointed at drawn lines:
    eval and `latest` after the last epoch only."""
    return ["-c", cfg, "-o", "Global.save_model_dir=%s" % out, "Global.epoch_num=%d" % epochs,
            "Global.eval_epoch_step=[%d,1]" % (epochs - 1),
            "Global.save_latest_epoch_step=%d" % epochs, "Global.print_batch_step=20",
            "Train.dataset.label_file_list=[%s]" % train_label,
            "Eval.dataset.label_file_list=[%s]" % eval_label]


def lines_config(argv):
    """The config tools.train.run reads from `argv`, with the CTC head sized
    by the charset as tools.train sizes it."""
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools.train import set_head_channels

    config = program.preprocess(is_train=True, argv=argv)[0]
    set_head_channels(config, build_post_process(config["PostProcess"], config["Global"]))
    return config


def eval_reading(config, model, dev, amp, label=None, batch_size=None):
    """The eval post process over the config's eval loader (or over `label`
    in batches of `batch_size`): per line its text or label, and the
    smallest gap between the two largest probabilities of any of its frames
    (rec) or of its two classes (cls), which says how near a tie it is."""
    import copy

    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.trainer import make_eval_step
    from pytorchocr_tpu_torch.utils.logging import get_logger

    config = copy.deepcopy(config)
    if label is not None:
        config["Eval"]["dataset"]["label_file_list"] = [label]
        config["Eval"]["loader"]["batch_size_per_card"] = batch_size
    loader, _ = build_dataloader(config, "Eval", get_logger(name="root"))
    post = build_post_process(config["PostProcess"], config["Global"])
    eval_step = make_eval_step(model, amp=amp)
    texts, gaps = [], []
    for batch in loader:
        probs = eval_step(torch.from_numpy(batch[0]).to(dev))
        texts += [t for t, _ in post(probs)]
        top2 = probs.float().topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        gaps += (gap.amin(dim=1) if gap.dim() == 2 else gap).cpu().tolist()
    return texts, gaps


def served_equals_eval(tag, kind, cfg_path, ckpt, label, dev, card, batch_size, dtype):
    """The serving CLI's class (Recer or Clser, as `python -m
    pytorchocr_tpu_torch.deploy.infer_rec` / `infer_cls` builds it) on the
    training checkpoint directory `ckpt` (Runner.load_state reads its
    `state.pt`), over the lines of `label` read from their files in chunks
    of `batch_size`: its texts or labels must equal the eval post process's
    on the same lines with the same checkpoint and dtype, but where a line
    has a frame (or the classifier its two classes) within 1e-4 of a tie.
    Returns the served texts or labels."""
    import cv2
    import torch

    from pytorchocr_tpu_torch.deploy.infer_cls import Clser
    from pytorchocr_tpu_torch.deploy.infer_rec import Recer
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.utils.config import load_config
    from pytorchocr_tpu_torch.utils.save_load import load_model

    config = load_config(cfg_path)
    config["Global"]["checkpoints"] = ckpt
    server = (Recer if kind == "rec" else Clser)(cfg_path, ckpt, device=dev, dtype=dtype)
    if kind == "rec":
        config["Architecture"]["Head"]["out_channels"] = len(
            server.rec_post_process_class.character)
    model = build_train_model(config, dev)
    load_model(config, model)
    with float32_on_card():
        want, gaps = eval_reading(config, model, dev, dtype != torch.float32, label, batch_size)
        paths = [ln.split("\t")[0] for ln in open(label).read().splitlines()]
        imgs = [cv2.imread(p) for p in paths]
        with paused():
            t0 = time.perf_counter()
            got = []
            for c in range(0, len(imgs), batch_size):
                got += [t for t, _ in server.run_batch(imgs[c : c + batch_size])]
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
    differ = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    excused = [i for i in differ if gaps[i] < 1e-4]
    check(len(got) == len(want) == len(paths) and len(differ) == len(excused),
          "%s: the served %s differ from the eval's on %d of %d lines away from a tie"
          % (tag, "texts" if kind == "rec" else "labels", len(differ) - len(excused), len(got)))
    say(tag, "%s on the training checkpoint directory %s (%s): its %s equal the eval post "
        "process's on %d of %d lines (%d differ, each with a frame within 1e-4 of a tie), "
        "%.1f lines/s served (first call, host resize included) on %s"
        % ("Recer (deploy.infer_rec)" if kind == "rec" else "Clser (deploy.infer_cls)",
           os.path.basename(ckpt), str(dtype).replace("torch.", ""),
           "texts" if kind == "rec" else "labels", len(got) - len(differ), len(got),
           len(differ), len(got) / serve_s, card))
    return got


# iterations of the training loop that profile_loop traces (4 before phase
# 18 was added, 2 before phase 19: the script needed the time)
PROFILE_STEPS = 1


@quiet
def profile_loop(config, dev, metric=True, sums=(), steps=PROFILE_STEPS):
    """Card busy over `steps` iterations of the trainer's loop (device_time,
    with `sums`): the loader wait, the copy, the step and, with `metric`
    (cal_metric_during_train), the eval forward, post process and metric on
    the train batch."""
    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.metrics import build_metric
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step
    from pytorchocr_tpu_torch.utils.logging import get_logger

    model, _, step = train_parts(config, dev, amp=True)
    eval_step = make_eval_step(model, amp=True)
    post = build_post_process(config["PostProcess"], config["Global"])
    eval_class = build_metric(config["Metric"])
    loader, _ = build_dataloader(config, "Train", get_logger(name="root"))

    def forever():
        for epoch in range(1 << 20):
            loader.set_epoch(epoch)
            yield from loader

    threads = threading.active_count()
    it = forever()

    def run(n=steps):
        for _ in range(n):
            batch_np = next(it)
            batch = batch_to_device(batch_np, dev)
            step(batch)
            if metric:
                eval_class(post(eval_step(batch[0]), batch_np[1]), batch_np)
                eval_class.get_metric()
        torch.cuda.synchronize()

    run(1)
    t0 = time.perf_counter()
    run()
    call_s = time.perf_counter() - t0
    out = device_time(run, call_s, sums)
    it.close()
    deadline = time.perf_counter() + 30  # the loader's batches in flight finish
    while threading.active_count() > threads and time.perf_counter() < deadline:
        time.sleep(0.05)
    return out


def report_lines_train(tag, report, run_s, card):
    """The train run's rates and where its iterations went."""
    wall = report["wall_s"]
    say(tag, "%.3f steps/s, %.1f samples/s over the train iterations (%.1f s of %.1f s in the "
        "call); loader wait %.1f%%, the batches' host-to-device copies (with the wait for the "
        "step before them) %.1f%%, the per-step metric (eval forward on the train batch, post "
        "process, metric; it waits for the step) %.1f%% = %.2f ms a step; %s"
        % (report["steps"] / wall, report["samples"] / wall, wall, run_s,
           100.0 * report["reader_s"] / wall, 100.0 * report["copy_s"] / wall,
           100.0 * report["metric_s"] / wall, 1e3 * report["metric_s"] / report["steps"], card))


def ctc_on_card(dev):
    """CTCLoss on the card against the CPU at the main path's shapes (N 128,
    T 80, 37 classes, labels of 1-25), with three rows that cannot fit in T
    (the port's copy of optax's recursion there) and an empty one: values
    rtol 1e-5, gradients atol 1e-6 on the rows that fit and 3e-4 on the
    others (a float32 value near 1e5 carries an ulp of 7.8e-3), all finite."""
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.losses import build_loss

    rng = np.random.RandomState(SEED + 24)
    n, t, c, s = 128, 80, 37, 25
    lengths = rng.randint(1, s + 1, n)
    labels = np.zeros((n, s), np.int64)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.randint(1, c, k)
    labels[0], lengths[0] = 0, 0
    for i in (1, 2, 3):  # 25 characters with 56+ adjacent repeats do not fit in 80 frames
        labels[i] = 7
        lengths[i] = s
    logits = (2 * rng.randn(n, t, c)).astype(np.float32)
    loss = build_loss({"name": "CTCLoss"})
    out = []
    for d in (torch.device("cpu"), dev):
        x = torch.tensor(logits, device=d, requires_grad=True)
        val = loss(x, (None, torch.from_numpy(labels).to(d), torch.from_numpy(lengths).to(d)))
        val["loss"].backward()
        out.append((float(val["loss"]), x.grad.cpu().numpy()))
    (v_cpu, g_cpu), (v_card, g_card) = out
    bad = np.zeros(n, bool)
    bad[1:4] = True
    err_fit = float(np.abs(g_card[~bad] - g_cpu[~bad]).max())
    err_bad = float(np.abs(g_card[bad] - g_cpu[bad]).max())
    check(np.isfinite(g_card).all() and abs(v_card - v_cpu) <= 1e-5 * abs(v_cpu)
          and err_fit <= 1e-6 and err_bad <= 3e-4,
          "rec-ctc: CTCLoss on the card %.7g against %.7g on the CPU, gradients off by %.3g "
          "(rows that fit) and %.3g (rows that cannot)" % (v_card, v_cpu, err_fit, err_bad))
    say("rec-ctc", "CTCLoss on the card (F.ctc_loss; the plain optax recursion on the 3 rows "
        "that cannot fit in 80 frames) against the CPU at N 128, T 80, C 37: loss %.6f against "
        "%.6f, gradients off by at most %.2e on the rows that fit and %.2e on the others, all "
        "finite" % (v_card, v_cpu, err_fit, err_bad))


def lines_overfit(kind, config, dev, card, tmp):
    """Phase 12's and 13's convergence check at full width (module
    docstring; the constants above), and the overfit model served from a
    training checkpoint directory: rec reads back the strings, cls the
    directions of one fixed batch of drawn lines, half of them turned."""
    import copy

    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step
    from pytorchocr_tpu_torch.utils.config import save_config
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import save_model

    rec = kind == "rec"
    tag = kind + "-overfit"
    label = make_lines(os.path.join(tmp, tag), OVERFIT_N, SEED + (23 if rec else 24),
                       (1, 25) if rec else (5, 25), turn_half=not rec)
    cfg = copy.deepcopy(config)
    cfg["Eval"]["dataset"]["label_file_list"] = [label]
    cfg["Eval"]["loader"]["batch_size_per_card"] = OVERFIT_N
    cfg["Optimizer"] = copy.deepcopy(OVERFIT_OPTIMIZER)
    batch_np = next(iter(build_dataloader(cfg, "Eval", get_logger(name="root"))[0]))
    batch = batch_to_device(batch_np, dev)
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    want = ([t for t, _ in post.decode(batch_np[1])] if rec
            else [post.label_list[int(i)] for i in batch_np[1]])
    model, opt, step = train_parts(cfg, dev, amp=True, schedule=(OVERFIT_CAP, 1))
    eval_step = make_eval_step(model, amp=True)
    curve, hits, done = [], 0, 0
    note = beside_worker()
    t0 = time.perf_counter()
    while done < OVERFIT_CAP and hits < OVERFIT_HITS:
        for _ in range(OVERFIT_EVERY):
            losses = step(batch)
        done += OVERFIT_EVERY
        got = [t for t, _ in post(eval_step(batch[0]))]
        hits = sum(g == w for g, w in zip(got, want))
        curve.append((done, float(losses["loss"]), hits))
    secs = time.perf_counter() - t0
    what = "strings" if rec else "directions"
    check(hits >= OVERFIT_HITS, "%s: %d of %d lines read back after %d steps (at least %d "
          "within %d)" % (tag, hits, OVERFIT_N, done, OVERFIT_HITS, OVERFIT_CAP))
    say(tag, "one fixed batch of %d drawn lines (%s, no augmentation), bf16, Adam at LR %g: "
        "%d of %d %s read back (eval mode) after %d steps (threshold %d within %d), %.1f s "
        "(%.2f steps/s with a read every %d%s); loss and lines read every %d steps: %s on %s"
        % (OVERFIT_N, "1-25 characters" if rec else "5-25 characters, half turned by 180 "
           "degrees", OVERFIT_OPTIMIZER["base_lr"], hits, OVERFIT_N, what, done, OVERFIT_HITS,
           OVERFIT_CAP, secs, done / secs, OVERFIT_EVERY, note, OVERFIT_EVERY,
           ", ".join("%d: %.3f %d" % c for c in curve[:: max(1, len(curve) // 12)]), card))
    out = os.path.join(tmp, tag + "_out")
    save_model(model, opt, {"start_epoch": 1, "global_step": done, "best_model": {}}, out,
               prefix="best_accuracy")
    cfg_path = os.path.join(out, "config.yml")
    save_config(cfg, cfg_path)
    served = served_equals_eval(tag + "-serve", kind, cfg_path,
                                os.path.join(out, "best_accuracy"), label, dev, card, OVERFIT_N,
                                torch.bfloat16)
    say(tag + "-serve", "the served %s give back %d of the %d %s"
        % ("texts" if rec else "labels", sum(g == w for g, w in zip(served, want)), OVERFIT_N,
           what))


def phase_lines_train(dev, card, tmp, kind, lines):
    """Phase 12 (kind "rec": CRNN) or 13 (kind "cls": the direction
    classifier): the config as published on drawn lines (`lines`, job_lines's
    train and eval label files)."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.utils.config import load_config
    from pytorchocr_tpu_torch.utils.logging import get_logger

    t_phase = time.perf_counter()
    logger = get_logger(name="root")
    for h in logger.handlers:
        h.setLevel(logging.WARNING)
    rec = kind == "rec"
    cfg_file, shape = (REC_TRAIN_CFG, "1x32x320") if rec else (CLS_TRAIN_CFG, "3x48x192")
    train_label, eval_label = lines.result()
    small = os.path.join(tmp, kind + "_train", "first.txt")
    with open(small, "w") as f:
        f.write("".join(open(train_label).readlines()[: 2 * F32_BS]))
    steps = LINES_STEPS[kind]
    epochs = steps // (LINES_TRAIN // LINES_BS)
    schedule = (epochs, LINES_TRAIN // LINES_BS)
    out = os.path.join(tmp, kind + "_out")
    argv = lines_argv(cfg_file, out, train_label, eval_label, epochs)
    config = lines_config(argv)
    ops_ms, _ = loader_breakdown(config, train_label, n=32)
    say(kind + "-loader", "host ms per line, one thread: %s (%s, %d drawn lines)"
        % (ops_ms, "RecAug with TIA" if rec else "RecAug without TIA, RandAugment (PIL)",
           LINES_TRAIN))
    batches = first_batches(config, 2, F32_BS, small)
    f32_check = compare_f32_step(config, dev, batches[0], card,
                                 what="bs %d, %s" % (F32_BS, shape), tag=kind + "-f32",
                                 schedule=schedule, zero_grad=bn_fed_biases,
                                 focus="rnn." if rec else None, card_floors=True)
    if rec:
        ctc_on_card(dev)
        checkpoint_round_trip(config, dev, batches, tmp, tag="rec-ckpt", schedule=schedule)
    beside_run(lines_overfit, kind, config, dev, card, tmp)
    later(f32_check)

    torch.cuda.synchronize()
    report, run_s = train_run(argv)
    losses = report["losses"]
    check(report["steps"] == steps and len(losses) == steps,
          "%s-train: %d steps, not %d" % (kind, report["steps"], steps))
    check(bool(np.isfinite(losses).all()), "%s-train: a loss is not finite" % kind)
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    best = report["best"]
    say(kind + "-train", "%s as published (bs %d at %s, bf16 autocast, amsgrad + WarmupPolyLR, "
        "8 loader threads, cal_metric_during_train) through tools.train.run; cut to %d steps "
        "(the config: %d epochs), %d lines drawn with cv2's Hershey fonts (in place of %s's "
        "TTF lines) and one eval on %d lines; mean loss of the first 20 steps %.4f, of the last "
        "20 %.4f; loss every 20 steps: %s; the eval: %s"
        % (os.path.relpath(cfg_file, REPO), LINES_BS, shape, report["steps"],
           load_config(cfg_file)["Global"]["epoch_num"], LINES_TRAIN,
           "gen_synth_rec.py" if rec else "gen_synth_cls.py", LINES_EVAL, first, last,
           ", ".join("%.3f" % v for v in losses[::20]),
           ", ".join("%s %.4f" % (k, v) for k, v in best.items() if k != "best_model_epoch")))
    report_lines_train(kind + "-train", report, run_s, card)

    ckpt = os.path.join(out, "best_accuracy")
    metric = eval_run(argv + ["Global.checkpoints=%s" % ckpt])
    keys = ("acc", "norm_edit_dis") if rec else ("acc",)
    check(all(metric[k] == best[k] for k in keys), "%s-eval: tools.eval.run gives %s, the train "
          "run logged %s" % (kind, [metric[k] for k in keys], [best[k] for k in keys]))
    say(kind + "-eval", "tools.eval.run on best_accuracy: %s, equal to the train run's; %.1f "
        "lines/s (forward and sync, bs %d) on %s"
        % (", ".join("%s %.4f" % (k, metric[k]) for k in keys), metric["fps"],
           config["Eval"]["loader"]["batch_size_per_card"], card))
    served_equals_eval(kind + "-serve", kind, os.path.join(out, "config.yml"), ckpt, eval_label,
                       dev, card, config["Eval"]["loader"]["batch_size_per_card"], torch.float32)
    say(kind + "-train", "profiler, %d iterations of the loop (loader wait, copy, step, "
        "per-step metric): %s on %s" % (PROFILE_STEPS, profile_loop(config, dev), card))
    say(kind + "-train", "phase %d took %.1f s" % (12 if rec else 13,
                                                  time.perf_counter() - t_phase))
    return train_label, eval_label, small


PSE_TRAIN_CFG = os.path.join(REPO, "configs", "det", "det_r50_pse_synth.yml")
PAN_TRAIN_CFG = os.path.join(REPO, "configs", "det", "det_r18_pan_synth.yml")
# phases 14 and 15: the config, its batch, the steps of tools.train.run (whole
# epochs of phase 11's 64 pages: PSE 12 x 8, PAN 10 x 4; at 104 and 100 steps
# the two phases took 264 s on an H100's host and the whole script ran past
# 850 s; PAN's loss check held with room at 60 steps (0.355 of the first 20
# steps'), PSE's barely at 64 (0.481, 0.367 at 104)), the side of the
# float32 step's crops (ResNet-50 at 320 keeps the CPU's float64 step short)
# and the loss check, fixed in PERF.md before the first run that checked it
# from the JAX package's runs of these configs (output/quality/*/train.log:
# PSE 0.239 at iter 20 to 0.098 at iter 99, PAN 0.756 at iter 20 to 0.355 at
# iter 74): the mean loss of the last 20 steps under this share of the first
# 20's
DET_TRAIN = {
    "pse": dict(cfg=PSE_TRAIN_CFG, phase=14, bs=8, steps=96, f32_size=320, fall=0.5),
    "pan": dict(cfg=PAN_TRAIN_CFG, phase=15, bs=16, steps=40, f32_size=TRAIN_SIZE, fall=0.6),
}


def sized(config, side):
    """A copy of a DB, PSE or PAN training config whose crops (and the GT
    makers' upscale target) are `side` square."""
    import copy

    config = copy.deepcopy(config)
    for op in config["Train"]["dataset"]["transforms"]:
        name = next(iter(op))
        if name in ("RandomCropImgMask", "FusedDetAugCrop", "EastRandomCropData"):
            op[name]["size"] = [side, side]
        elif name in ("MakePseGt", "MakePanGt"):
            op[name]["size"] = side
    return config


def step_flips(config, dev, batch, schedule):
    """The seeded model's train-mode forward in float32 on the card (TF32
    off), and the same forward in float64 on the CPU as a job of the CPU
    reference process (float64_selections). Returns that job (its result:
    the pixels that the two put on different sides of the loss's thresholds,
    per selection of `selections`: OHEM's cut, the kernel-sample mask, the
    IoU logs' binarisations; and the float64 loss terms with the float64
    run's own masks); the IoU logs on the card's binarised maps (computed on
    the CPU from them and the batch's labels); and a `select` that hands the
    loss the card's two masks, for the float64 reference step."""
    import torch

    from pytorchocr_tpu_torch.losses import basic, build_loss
    from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform

    loss = build_loss(config["Loss"])
    transform = build_input_transform(
        config["Global"].get("_device_normalize_spec", {}).get("Train"))
    model = train_parts(config, dev, amp=False, schedule=schedule)[0].train()
    b = batch_to_device(batch, dev)
    x = b[0] if transform is None else transform(b[0])
    with torch.no_grad(), float32_on_card():
        maps = model(x.permute(0, 3, 1, 2), data=b)["maps"].float()
    card = {k: v.cpu() for k, v in loss.selections({"maps": maps}, b).items()}
    del model
    b = batch_to_device(batch, torch.device("cpu"))
    gt_texts, masks = b[1], b[-1]
    gt_kernel = b[2][:, -1] if b[2].dim() == 4 else b[2]
    explained = {
        "iou_text": float(basic.iou_binary(card["text>0"].int(), gt_texts, masks)),
        "iou_kernel": float(basic.iou_binary(card["kernel>0"].int(), gt_kernel,
                                             masks * gt_texts)),
    }
    return (cpu_job(float64_selections, config, batch, schedule, card), explained,
            CardSelections(card))


def float64_selections(config, batch, schedule, card):
    """step_flips's float64 forward on the CPU: the pixels on another side
    of a loss threshold than on the card (`card`, its selections), and the
    float64 loss terms with its own masks."""
    import torch

    from pytorchocr_tpu_torch.losses import build_loss
    from pytorchocr_tpu_torch.losses.det_pse_loss import flipped_pixels
    from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform

    loss = build_loss(config["Loss"])
    transform = build_input_transform(
        config["Global"].get("_device_normalize_spec", {}).get("Train"))
    cpu = torch.device("cpu")
    model = train_parts(config, cpu, amp=False, schedule=schedule)[0].double().train()
    b = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
              for x in batch_to_device(batch, cpu))
    x = b[0] if transform is None else transform(b[0])
    with torch.no_grad():
        maps = model(x.double().permute(0, 3, 1, 2), data=b)["maps"].double()
        own = {k: float(v) for k, v in loss({"maps": maps}, b).items()}
    return flipped_pixels(card, loss.selections({"maps": maps}, b)), own


class CardSelections:
    """The float64 step's PSE/PAN loss `select`: the card's OHEM selection
    and kernel-sample mask (step_flips)."""

    def __init__(self, card):
        self.card = {k: v.cpu() for k, v in card.items()}

    def __call__(self, texts, gt_texts, training_masks):
        return (self.card["ohem"].to(texts.dtype), self.card["kernel_mask"].to(texts.dtype))


@quiet
def loss_ms(config, dev, batch):
    """Card ms of the config's loss, forward and backward, on a train batch
    with random logits at its maps' shape, and of its embedding loss alone
    (PAN; None for PSE), CUDA events over 5 calls after 2."""
    import torch

    from pytorchocr_tpu_torch.losses import basic, build_loss
    from pytorchocr_tpu_torch.losses.det_pse_loss import upsample_maps
    from pytorchocr_tpu_torch.trainer import batch_to_device

    loss = build_loss(config["Loss"])
    b = batch_to_device(batch, dev)
    n, h, w = b[1].shape
    channels = config["Architecture"]["Head"]["out_channels"]
    maps = torch.randn(n, h // 4, w // 4, channels, device=dev, requires_grad=True)
    whole = cuda_ms(lambda: loss({"maps": maps}, b)["loss"].backward(), iters=5, warmup=2)
    emb = None
    if len(b) == 5:
        emb = cuda_ms(lambda: basic.emb_loss(upsample_maps(maps)[..., 2:], b[3], b[2],
                                             b[4]).backward(), iters=5, warmup=2)
    return whole, emb


# served_det_equals_eval's bound on the two runs' maps: they differ only in
# the input's normalisation (an ulp of each pixel), and runs on an H100 read
# 0 (DB++, PSE) to 7.63e-5 (PAN) as the largest difference (PERF.md)
SERVED_MAPS_ATOL = 1e-3


def served_det_equals_eval(tag, config, cfg_path, ckpt, dev, card, channels):
    """Deter (deploy.infer_det) on the training checkpoint directory `ckpt`,
    float32 on the card, page by page over the config's eval pages, against
    the eval forward and post process of the same checkpoint (its own
    normalisation: /255 where the Runner multiplies by float32(1/255)): the
    maps of `channels` within SERVED_MAPS_ATOL of each other on every page,
    and the same boxes, at least one, but a box that holds, or lies in a
    text component that holds, a map pixel on the other side of the post
    process's threshold in one of the two runs (compare_boxes's rule)."""
    import copy

    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.trainer import build_input_transform, make_eval_step
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import load_model
    from pytorchocr_tpu_torch.utils.utility import sort_boxes

    config = copy.deepcopy(config)
    config["Global"]["checkpoints"] = ckpt
    loader, _ = build_dataloader(config, "Eval", get_logger(name="root"))
    paths = [ln.decode().split("\t")[0] for ln in loader.dataset.data_lines]
    post = build_post_process(config["PostProcess"], config["Global"])
    thresh = post.thresh
    equal = excused = flipped = 0
    diff = 0.0
    with float32_on_card():
        deter = Deter(cfg_path, ckpt, device=dev, dtype=torch.float32)
        model = build_train_model(config, dev)
        load_model(config, model)
        eval_step = make_eval_step(model, build_input_transform(
            config["Global"].get("_device_normalize_spec", {}).get("Eval")))
        with paused():
            t0 = time.perf_counter()
            served = [deter.run(p) for p in paths]
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        for i, (path, batch) in enumerate(zip(paths, loader)):
            maps_eval = eval_step(torch.from_numpy(batch[0]).to(dev))["maps"].float()
            want = sort_boxes(post({"maps": maps_eval}, batch[1])[0]["points"])
            det_img, _ = deter._preprocess(cv2.imread(path))
            maps_served = deter.runner(det_img)["maps"].float()
            got = served[i]
            gap = float((maps_eval - maps_served)[0, ..., channels].abs().max())
            diff = max(diff, gap)
            check(gap <= SERVED_MAPS_ATOL, "%s: page %d: the served maps lie %.3g from the "
                  "eval's (bound %g)" % (tag, i, gap, SERVED_MAPS_ATOL))
            flips = ((maps_eval > thresh) != (maps_served > thresh))[0, ..., channels].cpu()
            flipped += int(flips.sum())
            ys, xs = np.nonzero(flips.any(-1).numpy())
            text = ((maps_eval[0, ..., 0] > thresh) | (maps_served[0, ..., 0] > thresh))
            _, lab, stats, _ = cv2.connectedComponentsWithStats(
                text.cpu().numpy().astype(np.uint8), connectivity=4)
            hit = np.unique(lab[ys, xs])
            hit = hit[hit > 0]
            cell = np.array([batch[1][0][1] / flips.shape[1], batch[1][0][0] / flips.shape[0]])
            lo = np.concatenate([np.stack([xs, ys], 1) * cell, stats[hit, 0:2] * cell])
            hi = np.concatenate([(np.stack([xs, ys], 1) + 1) * cell,
                                 (stats[hit, 0:2] + stats[hit, 2:4]) * cell])
            left = [tuple(np.asarray(b).reshape(-1).tolist()) for b in got]
            for box in want:
                key = tuple(np.asarray(box).reshape(-1).tolist())
                if key in left:
                    left.remove(key)
                    equal += 1
                else:
                    check(_holds_flip(key, lo, hi), "%s: page %d: the eval's box %s has no "
                          "equal among Deter's and holds no flipped pixel" % (tag, i, key))
                    excused += 1
            for key in left:
                check(_holds_flip(key, lo, hi), "%s: page %d: Deter's box %s has no equal "
                      "among the eval's and holds no flipped pixel" % (tag, i, key))
                excused += 1
    check(equal > 0, "%s: no box on the eval pages" % tag)
    say(tag, "Deter (deploy.infer_det) on %s, float32 (TF32 off), page by page: maps within "
        "%.3g of the eval forward's on the same checkpoint (bound %g), %d boxes equal to its post "
        "process's, %d without an equal, each holding or beside a map pixel that the two "
        "normalisations put on the other side of the threshold (%d such pixels over %d pages); "
        "%.2f pages/s served (host resize included) on %s"
        % (os.path.basename(ckpt), diff, SERVED_MAPS_ATOL, equal, excused, flipped, len(paths),
           len(paths) / serve_s, card))


def phase_det_train(dev, card, tmp, kind, train_label, eval_label):
    """Phase 14 (kind "pse": det_r50_pse_synth.yml) or 15 ("pan":
    det_r18_pan_synth.yml), each as published, on phase 11's drawn pages.
    Returns the training eval's (K1, K2) launches."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.utils.config import load_config
    from pytorchocr_tpu_torch.utils.logging import get_logger

    spec = DET_TRAIN[kind]
    t_phase = time.perf_counter()
    logger = get_logger(name="root")
    for h in logger.handlers:
        h.setLevel(logging.WARNING)
    per_epoch = TRAIN_PAGES // spec["bs"]
    epochs = spec["steps"] // per_epoch
    schedule = (epochs, per_epoch)
    out = os.path.join(tmp, kind + "_train_out")
    argv = train_argv(out, train_label, eval_label, epochs, spec["cfg"])
    config = program.preprocess(is_train=True, argv=argv)[0]
    name = os.path.relpath(spec["cfg"], REPO)
    ops_ms, _ = loader_breakdown(config, train_label)
    say(kind + "-loader", "host ms per sample, one thread: %s" % ops_ms)

    few = os.path.join(tmp, kind + "_few.txt")  # the loader draws only these pages
    with open(few, "w") as f:
        f.write("".join(open(train_label).readlines()[: max(spec["bs"], 4)]))
    small = sized(config, spec["f32_size"])
    batches = first_batches(small, 2, 2, few)
    flips, explained, select = step_flips(small, dev, batches[0], schedule)
    what = ("bs 2, %dx%d%s; the float64 step sums over the card's OHEM selection and "
            "kernel-sample mask" % (spec["f32_size"], spec["f32_size"],
                                    " (cut from 640 to keep the CPU's float64 step short)"
                                    if spec["f32_size"] != TRAIN_SIZE else ""))
    f32_check = compare_f32_step(small, dev, batches[0], card, what=what, tag=kind + "-f32",
                                 schedule=schedule, zero_grad=bn_fed_biases,
                                 explained=explained, select=select)

    def flips_report():
        pixels, own = flips.result()
        say(kind + "-f32", "pixels on the other side of a loss threshold than in float64: %s; "
            "the float64 forward's loss terms with its own masks (a report): %s"
            % (pixels, ", ".join("%s %.7f" % kv for kv in sorted(own.items()))))
    checkpoint_round_trip(small, dev, batches, tmp, tag=kind + "-ckpt", schedule=schedule)

    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_kernels() as rec:
        report, run_s = train_run(argv)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = rec.k1_launches, rec.k2_launches
    shapes = rec.hold(kind + "-train-eval")
    losses = report["losses"]
    check(report["steps"] == spec["steps"] and len(losses) == spec["steps"],
          "%s-train: %d steps, not %d" % (kind, report["steps"], spec["steps"]))
    check(bool(np.isfinite(losses).all()), "%s-train: a loss is not finite" % kind)
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(last < spec["fall"] * first, "%s-train: the mean loss went from %.4f (first 20 steps) "
          "to %.4f (last 20), not under %g of it" % (kind, first, last, spec["fall"]))
    check(launches[0] > 0, "%s-train: the evaluate after training launched no run-max kernel"
          % kind)
    if kind == "pse":
        check(launches[1] > 0, "pse-train: the evaluate after training launched no "
              "propagation kernel")
    best = report["best"]
    wall = report["wall_s"]
    say(kind + "-train", "%s as published (bs %d at %dx%d, bf16 autocast, amsgrad + "
        "WarmupPolyLR, 8 loader threads, the published augmentations) through tools.train.run: "
        "%d steps (%d epochs of %d drawn pages; the config: %d epochs of gen_synth_det.py's "
        "TTF pages); mean loss of the first 20 steps %.4f, of the last 20 %.4f (%.3f of it; "
        "the check: under %g); loss every 10 steps: %s"
        % (name, spec["bs"], TRAIN_SIZE, TRAIN_SIZE, report["steps"], epochs, TRAIN_PAGES,
           load_config(spec["cfg"])["Global"]["epoch_num"], first, last, last / first,
           spec["fall"], ", ".join("%.3f" % v for v in losses[::10])))
    say(kind + "-train", "%.3f steps/s, %.1f samples/s over the train iterations (%.1f s of "
        "%.1f s in the call); loader wait %.1f%%, the batches' host-to-device copies (with the "
        "wait for the step before them) %.1f%%; torch.cuda.max_memory_allocated %.2f GB; %s"
        % (report["steps"] / wall, report["samples"] / wall, wall, run_s,
           100.0 * report["reader_s"] / wall, 100.0 * report["copy_s"] / wall, peak / 1e9, card))
    say(kind + "-train-eval", "bucketed evaluate after the last epoch on %d pages (736x736): "
        "runmax.launches %d (alternations %d), propagate.launches %d, each launch's output and "
        "changed flag == the plain version on its inputs (%s); hmean %.4f, precision %.4f, "
        "recall %.4f, %.2f pages/s (its first call, recording each launch's inputs) on %s"
        % (EVAL_PAGES, launches[0], rec.alternations, launches[1], shapes, best["hmean"],
           best["precision"], best["recall"], best["fps"], card))

    metric = eval_run(argv + ["Global.checkpoints=%s" % os.path.join(out, "latest")])
    keys = ("precision", "recall", "hmean")
    check(all(metric[k] == best[k] for k in keys), "%s-eval: tools.eval.run on latest gives "
          "%s, the train run's evaluate %s" % (kind, [metric[k] for k in keys],
                                               [best[k] for k in keys]))
    say(kind + "-eval", "tools.eval.run on latest: hmean %.4f, precision %.4f, recall %.4f, "
        "equal to the train run's; %.2f pages/s on %s"
        % (metric["hmean"], metric["precision"], metric["recall"], metric["fps"], card))
    served_det_equals_eval(kind + "-serve", config, os.path.join(out, "config.yml"),
                           os.path.join(out, "best_accuracy"), dev, card,
                           list(range(7)) if kind == "pse" else [0, 1])
    later(flips_report)
    later(f32_check)
    whole, emb = loss_ms(config, dev, first_batches(config, 1, spec["bs"], few)[0])
    say(kind + "-train", "the loss, forward and backward, on a train batch of %d at %dx%d: "
        "%.2f ms%s (CUDA events) on %s"
        % (spec["bs"], TRAIN_SIZE, TRAIN_SIZE, whole,
           "; the embedding loss alone %.2f ms" % emb if emb is not None else "", card))
    say(kind + "-train", "profiler, %d train steps with their loader waits: %s on %s"
        % (PROFILE_STEPS, profile_loop(config, dev, metric=False,
                                       sums=("batch_norm", "reduce_kernel")), card))
    say(kind + "-train", "phase %d took %.1f s" % (spec["phase"], time.perf_counter() - t_phase))
    return launches


DBPP_CFG = os.path.join(REPO, "configs", "det", "det_r18_dbpp.yml")
STARNET_CFG = os.path.join(REPO, "configs", "rec", "rec_vgg_tps_bilstm_ctc.yml")
# phase 16: Deter.run_batch paths, (tag, config, seed)
ZOO_DET = tuple((tag, os.path.join(REPO, "configs", "det", name), SEED + 62 + i)
                for i, (tag, name) in enumerate((
                    ("MBv3-small DB", "det_mbv3_db.yml"),
                    ("MBv3-large-0.5 DB", "det_mbv3large05_db_synth.yml"),
                    ("SFv2 DB", "det_sfv2_db.yml"),
                    ("RepVGG DB", "det_repvgg_db_synth.yml"),
                    ("R50 DB", "det_r50_db.yml"))))
# the zoo's float32 card runs are held to the CPU's on the first 2 of the 4
# pages (the CPU's full-width forwards of seven models; each head is made
# text-like on those 2), the bf16 main-path runs take all 4
ZOO_CPU_PAGES = 2
# the folded RepVGG's fused map (the FPN's output) against the train form's,
# both float32 on the card: max |diff| over the map's max |value|, written
# down in PERF.md before the first run that checked it
REPVGG_FUSED_TOL = 1e-4


def zoo_ocr_path(dev, card, tag, det_cfg, det_pt, margin, rec_cfg, rec_pt, pages, ref):
    """OCRer.run_many of a det and a rec config: float32 on the card (TF32
    off) against the CPU (`ref`, its ref_ocr) on the first ZOO_CPU_PAGES
    pages (compare_boxes, compare_texts), then the bf16 main path on all
    pages, every K1 launch recorded and held to the plain version, timed and
    broken into stages. Returns its K1 launches."""
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer

    few = pages[:ZOO_CPU_PAGES]
    cpu, cpu_s = ref["cpu"], ref["cpu_s"]
    check(sum(len(p) for p in cpu) > 0, "%s: no text boxes on the CPU" % tag)
    with float32_on_card():
        ocr32 = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev, dtype=torch.float32)
        f32 = flat(ocr32.run_many(few))
        pairs, _ = compare_boxes(ref["det"], ocr32.deter, few, box_lists(cpu),
                                 box_lists(f32), margin, tag=tag + "-f32")
        compare_texts(ref["text"], ocr32, cpu, f32, pairs, tag=tag + "-f32")
    del ocr32
    say(tag + "-f32", "float32 on %s against the CPU on %d of the %d pages (the CPU's run %.1f "
        "s)" % (card, len(few), len(pages), cpu_s))

    ocr = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev)  # bf16 default
    with recorded_kernels() as rec:
        bf16 = flat(ocr.run_many(pages))
        torch.cuda.synchronize()
    launches = rec.k1_launches
    shapes = rec.hold(tag + "-bf16")
    check(launches > 0, "%s: the main-path run launched no run-max kernel" % tag)
    lines = sum(len(p) for p in bf16)
    check(lines > 0, "%s: the bf16 run found no text boxes" % tag)
    secs, _ = timed_runs(lambda: ocr.run_many(pages), 1)
    say(tag + "-bf16", "main path: runmax.launches %d, each == the plain version on its inputs "
        "(%s); %d lines; %.3f pages/s, %.1f lines/s (%d pages of %dx%d, one timed run) on %s"
        % (launches, shapes, lines, PAGES / secs, lines / secs, PAGES, H, W, card))
    say(tag + "-bf16", "stages per %d-page call: %s on %s"
        % (PAGES, stage_breakdown(ocr.deter, pages, "db", ocr.recer), card))
    return launches


def zoo_det_path(dev, card, tag, det_cfg, det_pt, margin, pages, ref):
    """Deter.run_batch of a DB config: float32 on the card against the CPU
    (`ref`, its ref_det) on the first ZOO_CPU_PAGES pages, then the bf16
    main path on all pages with every K1 launch held to the plain version,
    timed and broken into stages. Returns its K1 launches."""
    import cv2
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter

    few = pages[:ZOO_CPU_PAGES]
    imgs = [cv2.imread(p) for p in pages]
    cpu = ref["cpu"]
    check(sum(len(p) for p in cpu) > 0, "%s: no text boxes on the CPU" % tag)
    with float32_on_card():
        deter32 = Deter(det_cfg, det_pt, device=dev, dtype=torch.float32)
        f32 = box_lists(deter32.run_batch(imgs[: len(few)]))
        compare_boxes(ref["det"], deter32, few, cpu, f32, margin, tag=tag + "-f32")
    del deter32

    deter = Deter(det_cfg, det_pt, device=dev)  # bf16 default
    with recorded_kernels() as rec:
        boxes = sum(len(p) for p in deter.run_batch(imgs))
        torch.cuda.synchronize()
    launches = rec.k1_launches
    shapes = rec.hold(tag + "-bf16")
    check(launches > 0, "%s: the main-path run launched no run-max kernel" % tag)
    check(boxes > 0, "%s: the bf16 run found no text boxes" % tag)
    secs, _ = timed_runs(lambda: deter.run_batch(imgs), 1)
    say(tag + "-bf16", "main path: runmax.launches %d, each == the plain version on its inputs "
        "(%s); %d boxes; %.3f pages/s, %.1f boxes/s (%d pages of %dx%d, one timed run) on %s"
        % (launches, shapes, boxes, PAGES / secs, boxes / secs, PAGES, H, W, card))
    say(tag + "-bf16", "stages per %d-page call: %s on %s"
        % (PAGES, stage_breakdown(deter, pages, "db"), card))
    return launches


def repvgg_fold(tmp, det_cfg, det_pt):
    """The RepVGG fold (reparameterize_state_dict, float64 on the CPU, from
    the seeded non-trivial BN statistics) as the config's deploy form
    (Backbone.deploy: True): its .pt, its config and the fold's seconds."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.modeling.backbones.det_repvgg import reparameterize_state_dict
    from pytorchocr_tpu_torch.utils.config import load_config, save_config

    train_cpu = Deter(det_cfg, det_pt, device="cpu")
    t0 = time.perf_counter()
    folded = reparameterize_state_dict(train_cpu.runner.model)
    fold_s = time.perf_counter() - t0
    deploy_pt = os.path.join(tmp, "repvgg_deploy.pt")
    torch.save(folded, deploy_pt)
    cfg = load_config(det_cfg)
    cfg["Architecture"]["Backbone"]["deploy"] = True
    deploy_cfg = os.path.join(tmp, "repvgg_deploy.yml")
    save_config(cfg, deploy_cfg)
    return deploy_pt, deploy_cfg, fold_s


def repvgg_deploy_check(dev, card, det_cfg, det_pt, margin, pages, fold):
    """The RepVGG fold (repvgg_fold's) served as the config's deploy form:
    float32 on the card, its boxes against the train form's on the same card
    (compare_boxes's rule), its fused map within REPVGG_FUSED_TOL of the
    train form's."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter

    few = pages[:ZOO_CPU_PAGES]
    deploy_pt, deploy_cfg, fold_s = fold
    fused = {}

    def keep(name):
        def hook(mod, inp, out):
            fused[name] = out.float()
        return hook

    with float32_on_card():
        train = Deter(det_cfg, det_pt, device=dev, dtype=torch.float32)
        deploy = Deter(deploy_cfg, deploy_pt, device=dev, dtype=torch.float32)
        n_reparam = sum(1 for k in deploy.runner.model.state_dict() if k.endswith("reparam.weight"))
        hooks = [d.runner.model.neck.register_forward_hook(keep(n))
                 for n, d in (("train", train), ("deploy", deploy))]
        batch, _ = _det_batch(train, few)
        train.runner(batch)
        deploy.runner(batch)
        for h in hooks:
            h.remove()
        rel = float((fused["train"] - fused["deploy"]).abs().max() / fused["train"].abs().max())
        check(rel <= REPVGG_FUSED_TOL, "repvgg-deploy: the folded model's fused map is %.3g of "
              "its max from the train form's (tolerance %g)" % (rel, REPVGG_FUSED_TOL))
        import cv2

        imgs = [cv2.imread(p) for p in few]
        a, b = box_lists(train.run_batch(imgs)), box_lists(deploy.run_batch(imgs))
        compare_boxes(det_reference(train, few), deploy, few, a, b, margin, tag="repvgg-deploy")
    say("repvgg-deploy", "the fold of %d blocks (float64 on the CPU, %.2f s, from seeded BN "
        "statistics: running mean ~ N(0, 0.1), var in [0.5, 1.5], scale ~ N(1, 0.1)) served as "
        "Backbone.deploy: True, float32 on %s: fused map max |deploy - train| %.3g of its max "
        "(tolerance %g); boxes against the train form's on the same card above"
        % (n_reparam, fold_s, card, rel, REPVGG_FUSED_TOL))


def seeded_star_net(tmp, pages):
    """The published STAR-Net (TPS large, F=20; VGG v1; BiLSTM 256; CTC over
    6,624 classes) with seeded weights, its TPS perturbed from RARE's init
    (utils.seeded.perturbed_tps_) and its CTC head made decisive on strips
    of the first page. Returns the .pt path and the share of the strips'
    grid points outside [-1, 1]."""
    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy.infer_rec import Recer
    from pytorchocr_tpu_torch.utils.seeded import (
        decisive_ctc_head_, perturbed_tps_, seeded_init_,
    )

    gen = torch.Generator().manual_seed(SEED + 61)
    recer = Recer(STARNET_CFG, None, device="cpu")
    model = perturbed_tps_(seeded_init_(recer.runner.model, gen), gen)
    page_img = cv2.imread(pages[0])
    strips = [recer._prep(page_img[y : y + 48, : W // 2]) for y in range(30, H - 48, 90)]
    x = torch.from_numpy(np.stack(strips)).permute(0, 3, 1, 2)
    decisive_ctc_head_(model, x)
    with torch.no_grad():
        outside = float((model.eval().transform.grid(x).abs() > 1).any(-1).float().mean())
    path = os.path.join(tmp, "starnet.pt")
    torch.save(model.state_dict(), path)
    return path, outside


def phase_zoo_serve(dev, card, tmp, pages, db, refs):
    """Phase 16: the rest of the configured zoo served at full width on the
    DB slice's pages with seeded weights, held to the CPU references of
    job_zoo (`refs`). Returns K1's launches by path."""
    t_phase = time.perf_counter()
    k1 = {}
    ref = refs["dbpp"].result()
    say("dbpp", "seeded DB++ (det_r18_dbpp.yml: ResNet-18, FPN 256 with ASF "
        "scale_channel_spatial, DBHead k=50), head text-like on %d pages: margin %s logits; "
        "with phase 5's CRNN" % (ZOO_CPU_PAGES, _fmt(ref["margin"])))
    k1["DB++"] = zoo_ocr_path(dev, card, "dbpp", DBPP_CFG, ref["det_pt"], ref["margin"], REC_CFG,
                              db["rec_pt"], pages, ref)
    ref = refs["starnet"].result()
    say("starnet", "seeded STAR-Net (rec_vgg_tps_bilstm_ctc.yml: TPS large F=20, VGG v1, BiLSTM "
        "256, CTC over 6,624 classes), its TPS RARE's init perturbed (fc2 weight ~ N(0, 0.02), "
        "fiducials x1.1): %.1f%% of the grid points outside [-1, 1] on strips of page 0; behind "
        "phase 5's DB" % (100.0 * ref["outside"]))
    check(ref["outside"] > 0, "starnet: no grid point leaves [-1, 1]")
    k1["STAR-Net"] = zoo_ocr_path(dev, card, "starnet", DET_CFG, db["det_pt"], db["margin"],
                                  STARNET_CFG, ref["star_pt"], pages, ref)
    for tag, cfg, _ in ZOO_DET:
        ref = refs[tag].result()
        say(tag, "seeded %s, head text-like on %d pages: margin %s logits"
            % (os.path.basename(cfg), ZOO_CPU_PAGES, _fmt(ref["margin"])))
        k1[tag] = zoo_det_path(dev, card, tag, cfg, ref["det_pt"], ref["margin"], pages, ref)
        if "fold" in ref:
            repvgg_deploy_check(dev, card, cfg, ref["det_pt"], ref["margin"], pages, ref["fold"])
    say("zoo", "phase 16 took %.1f s" % (time.perf_counter() - t_phase))
    return k1


def off_rare(model):
    """STAR-Net's TPS off RARE's init, so its every layer has a gradient (a
    CPU generator's draws: every step alike)."""
    import torch

    from pytorchocr_tpu_torch.utils.seeded import perturbed_tps_

    perturbed_tps_(model, torch.Generator().manual_seed(SEED + 71))


DBPP_TRAIN_CFG = os.path.join(REPO, "configs", "det", "det_r18_dbpp_synth.yml")
STARNET_TRAIN_CFG = os.path.join(REPO, "configs", "rec", "rec_vgg_tps_bilstm_ctc_synth.yml")
# phase 17: DB++'s steps of tools.train.run (10 epochs of phase 11's 64
# pages at bs 16) and their check that the loss leaves its start: the mean
# loss of the last 10 steps under this share of the first step's. The JAX
# package's run of this config (output/quality/det_r18_dbpp_synth/train.log)
# holds a plateau near 2.8 from iter ~40 until ~200, where the binary map's
# dice loss stays at 0.95 (no text found), and the port's 40 steps (their
# LR warm-up 12 steps, the JAX run's 75) reach it by step ~8, so the first
# form of the check, written down in PERF.md before the first card run (the
# last 10 steps' mean under 0.6 of the first 10's), measured the plateau's
# noise: 0.577, 0.589 and 0.640 in three card runs. The fall past the
# plateau is held on one fixed batch (below). STAR-Net's steps (one epoch of
# phase 12's 2,560 lines at bs 128) and the steps of its freeze check
DBPP_STEPS, DBPP_FALL = 40, 0.5
STARNET_STEPS, FREEZE_STEPS = 20, 3
# DB++'s convergence check: one fixed batch of the first 4 of phase 11's
# pages through the config's train chain (its augmentation drawn once),
# bf16, the config's amsgrad at a constant LR, read every 25 steps: within
# 1,500 steps the batch's binary-map dice loss falls under 0.2 (the
# plateau's 0.92-0.95) and the eval forward then finds at least 20 boxes on
# the batch's 4 crops, written out as pages (what the model has fit: a crop
# may show its page's text zoomed up to 3x); the model, saved as a training
# checkpoint, is served by Deter there. The LR is 2e-4, not the config's 1e-3: within ~25 steps the
# ASF attention's scores fall to ~0 (the fused map then carries nothing:
# the plateau), and at a constant 1e-3 on one batch some runs stay there for
# the whole cap, where at 2e-4 they leave it after 50-425 steps
# (chip_dbpp_plateau.py). Boxes need the text's mean probability over the
# post process's box_thresh of 0.5, which comes some steps after the fall;
# the total loss is no gauge of it (its threshold-map term stays at 0.65 on
# the smoke's batch, ~0.2 on another; PERF.md, section 6)
DBPP_OVERFIT_N, DBPP_OVERFIT_LR, DBPP_OVERFIT_DICE, DBPP_OVERFIT_BOXES = 4, 2e-4, 0.2, 20
DBPP_OVERFIT_CAP, DBPP_OVERFIT_EVERY = 1500, 25


def starnet_freeze(config, dev, batches, schedule):
    """A few bf16 steps of the published STAR-Net with its transform frozen
    (as Global.freeze_transform_epochs freezes it): the transform's
    parameters stay bit for bit, its BN running statistics move, and every
    other trained parameter moves."""
    import torch

    from pytorchocr_tpu_torch.trainer import batch_to_device

    model, opt, step = train_parts(config, dev, amp=True, schedule=schedule,
                                   frozen=(("transform", 10 ** 9),))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters() if v.requires_grad}
    s0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    for i in range(FREEZE_STEPS):
        step(batch_to_device(batches[i % len(batches)], dev))
    torch.cuda.synchronize()
    sd = model.state_dict()
    named = dict(model.named_parameters())
    tps = [k for k in p0 if k.startswith("transform.")]
    rest = [k for k in p0 if not k.startswith("transform.")]
    check(all(torch.equal(named[k].detach(), p0[k]) for k in tps),
          "starnet-freeze: a frozen transform parameter moved")
    stats = [k for k in s0 if k.startswith("transform.")]
    check(stats and all(not torch.equal(sd[k], s0[k]) for k in stats),
          "starnet-freeze: the transform's BN statistics did not move")
    still = [k for k in rest if torch.equal(named[k].detach(), p0[k])]
    check(not still, "starnet-freeze: %d trained parameters did not move: %s"
          % (len(still), still[:4]))
    say("starnet-freeze", "%d bf16 steps with the transform frozen (the published "
        "freeze_transform_epochs): its %d parameters bit for bit, its %d BN statistics moved, "
        "all %d other trained parameters moved; the optimizer's count %d"
        % (FREEZE_STEPS, len(tps), len(stats), len(rest), opt.param_groups[0]["count"]))


def dbpp_overfit(config, cfg_path, dev, card, tmp, train_label):
    """DB++'s convergence check at full width (the constants above), and
    the model served from a training checkpoint directory on its batch's
    crops, written out as pages. `cfg_path` is the config as tools.train
    wrote it (its host normalisation in place, which `config` has moved to
    the device)."""
    import copy

    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform, make_eval_step
    from pytorchocr_tpu_torch.utils.config import load_config, save_config
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import save_model

    tag = "dbpp-overfit"
    label = os.path.join(tmp, tag + "_label.txt")
    with open(train_label) as f, open(label, "w") as g:
        g.writelines(f.readlines()[:DBPP_OVERFIT_N])
    cfg = copy.deepcopy(config)
    cfg["Optimizer"].pop("lr_decay")
    cfg["Optimizer"]["base_lr"] = DBPP_OVERFIT_LR
    raw = first_batches(cfg, 1, DBPP_OVERFIT_N, label)[0]
    batch = batch_to_device(raw, dev)
    crops = os.path.join(tmp, tag + "_crops")
    os.makedirs(crops)
    lines = []
    for i, image in enumerate(raw[0]):  # RGB, as the chain decodes it
        path = os.path.join(crops, "crop_%d.png" % i)
        cv2.imwrite(path, np.ascontiguousarray(image[..., ::-1]))
        lines.append("%s\t%s\n" % (path, json.dumps([{"transcription": "x", "points": [
            [0, 0], [8, 0], [8, 8], [0, 8]]}])))  # no metric here: a placeholder box
    with open(os.path.join(crops, "label.txt"), "w") as f:
        f.writelines(lines)
    cfg["Eval"]["dataset"]["label_file_list"] = [os.path.join(crops, "label.txt")]
    model, opt, step = train_parts(cfg, dev, amp=True, schedule=(DBPP_OVERFIT_CAP, 1))
    base = cfg["Optimizer"]["base_lr"]
    check(abs(opt.current_lr() - base) <= 1e-6 * base, "%s: LR %g, not the constant %g"
          % (tag, opt.current_lr(), base))
    eval_step = make_eval_step(model, build_input_transform(
        cfg["Global"]["_device_normalize_spec"].get("Eval")))
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    pages = list(build_dataloader(cfg, "Eval", get_logger(name="root"))[0])

    def boxes_found():
        return sum(len(post({"maps": eval_step(torch.from_numpy(p[0]).to(dev))["maps"].float()},
                            p[1])[0]["points"]) for p in pages)

    curve, done, dice, boxes = [], 0, 1.0, 0
    note = beside_worker()
    t0 = time.perf_counter()
    while done < DBPP_OVERFIT_CAP and boxes < DBPP_OVERFIT_BOXES:
        for _ in range(DBPP_OVERFIT_EVERY):
            losses = step(batch)
        done += DBPP_OVERFIT_EVERY
        losses = {k: float(v) for k, v in losses.items()}
        dice = losses["loss_binary_maps"]
        if dice < DBPP_OVERFIT_DICE:
            boxes = boxes_found()
        curve.append((done, losses["loss"], dice, boxes))
    secs = time.perf_counter() - t0
    say(tag, "one fixed batch of %d drawn %dx%d pages (the train chain's augmentation drawn "
        "once), bf16, amsgrad at LR %g: after %d steps the binary dice loss %.4f (under %g) and "
        "%d boxes on its %d crops (at least %d; within %d steps), its terms %s; %.1f s (%.2f "
        "steps/s with the reads%s); loss, dice loss and boxes every %d steps: %s on %s"
        % (DBPP_OVERFIT_N, TRAIN_SIZE, TRAIN_SIZE, base, done, dice, DBPP_OVERFIT_DICE, boxes,
           len(pages), DBPP_OVERFIT_BOXES, DBPP_OVERFIT_CAP,
           ", ".join("%s %.4f" % kv for kv in losses.items()), secs, done / secs, note,
           DBPP_OVERFIT_EVERY,
           ", ".join("%d: %.3f %.3f %d" % c for c in curve[:: max(1, len(curve) // 12)]), card))
    check(dice < DBPP_OVERFIT_DICE and boxes >= DBPP_OVERFIT_BOXES, "%s: after %d steps the "
          "binary dice loss %.4f (under %g) and %d boxes (at least %d)"
          % (tag, done, dice, DBPP_OVERFIT_DICE, boxes, DBPP_OVERFIT_BOXES))
    out = os.path.join(tmp, tag + "_out")
    save_model(model, opt, {"start_epoch": 1, "global_step": done, "best_model": {}}, out,
               prefix="best_accuracy")
    written = load_config(cfg_path)
    written["Eval"]["dataset"]["label_file_list"] = cfg["Eval"]["dataset"]["label_file_list"]
    save_config(written, os.path.join(out, "config.yml"))
    served_det_equals_eval(tag + "-serve", cfg, os.path.join(out, "config.yml"),
                           os.path.join(out, "best_accuracy"), dev, card, [0])


def phase_zoo_train(dev, card, tmp, train_label, eval_label, lines):
    """Phase 17: DB++ and STAR-Net training as published, on phase 11's
    pages and phase 12's lines. Returns K1's launches on DB++'s training-eval
    path."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import model_state
    from pytorchocr_tpu_torch.utils.seeded import perturbed_tps_

    t_phase = time.perf_counter()
    logger = get_logger(name="root")
    for h in logger.handlers:
        h.setLevel(logging.WARNING)

    # DB++
    per_epoch = TRAIN_PAGES // TRAIN_BS
    epochs = DBPP_STEPS // per_epoch
    schedule = (epochs, per_epoch)
    out = os.path.join(tmp, "dbpp_train_out")
    argv = train_argv(out, train_label, eval_label, epochs, DBPP_TRAIN_CFG)
    config = program.preprocess(is_train=True, argv=argv)[0]
    batches = first_batches(config, 2, 2)
    dbpp_check = compare_f32_step(config, dev, batches[0], card, tag="dbpp-f32",
                                  schedule=schedule, loss_pieces=True)
    checkpoint_round_trip(config, dev, batches, tmp, tag="dbpp-ckpt", schedule=schedule)
    with recorded_kernels() as rec:
        report, run_s = train_run(argv)
    k1 = rec.k1_launches
    shapes = rec.hold("dbpp-train-eval")
    losses = report["losses"]
    check(report["steps"] == DBPP_STEPS and len(losses) == DBPP_STEPS,
          "dbpp-train: %d steps, not %d" % (report["steps"], DBPP_STEPS))
    first, last = float(losses[0]), float(np.mean(losses[-10:]))
    check(last < DBPP_FALL * first, "dbpp-train: the loss went from %.4f (the first step) to "
          "%.4f (the mean of the last 10), not under %g of it" % (first, last, DBPP_FALL))
    check(bool(np.isfinite(losses).all()), "dbpp-train: a loss is not finite")
    check(k1 > 0, "dbpp-train: the evaluate after training launched no run-max kernel")
    best, wall = report["best"], report["wall_s"]
    say("dbpp-train", "det_r18_dbpp_synth.yml as published (bs %d at %dx%d, bf16 autocast, "
        "amsgrad + WarmupPolyLR, 8 loader threads) through tools.train.run: %d steps (%d "
        "epochs of %d drawn pages); loss of the first step %.4f, mean of the last 10 %.4f (%.3f "
        "of it; the check: under %g), mean of the first 10 %.4f; loss every 4 steps: %s"
        % (TRAIN_BS, TRAIN_SIZE, TRAIN_SIZE, report["steps"], epochs, TRAIN_PAGES, first, last,
           last / first, DBPP_FALL, float(np.mean(losses[:10])),
           ", ".join("%.3f" % v for v in losses[::4])))
    say("dbpp-train", "%.3f steps/s, %.1f samples/s over the train iterations (%.1f s of %.1f s "
        "in the call); loader wait %.1f%%, the batches' host-to-device copies (with the wait "
        "for the step before them) %.1f%%; %s"
        % (report["steps"] / wall, report["samples"] / wall, wall, run_s,
           100.0 * report["reader_s"] / wall, 100.0 * report["copy_s"] / wall, card))
    say("dbpp-train-eval", "bucketed evaluate after the last epoch on %d pages: runmax.launches "
        "%d (alternations %d), each launch's output and changed flag == the plain version on "
        "its inputs (%s); hmean %.4f, precision %.4f, recall %.4f, %.2f pages/s on %s"
        % (EVAL_PAGES, k1, rec.alternations, shapes, best["hmean"], best["precision"],
           best["recall"], best["fps"], card))
    metric = eval_run(argv + ["Global.checkpoints=%s" % os.path.join(out, "latest")])
    keys = ("precision", "recall", "hmean")
    check(all(metric[k] == best[k] for k in keys), "dbpp-eval: tools.eval.run on latest gives "
          "%s, the train run's evaluate %s" % ([metric[k] for k in keys], [best[k] for k in keys]))
    say("dbpp-eval", "tools.eval.run on latest: hmean %.4f, equal to the train run's; %.2f "
        "pages/s on %s" % (metric["hmean"], metric["fps"], card))
    # here, not in the side process: there its escape from the ASF plateau
    # took 250 to over 1,500 steps across runs; in this process, before the
    # side process, 800 in each of four (PERF.md §6)
    dbpp_overfit(config, os.path.join(out, "config.yml"), dev, card, tmp, train_label)
    later(dbpp_check)

    # STAR-Net
    line_train, line_eval, small = lines
    per_epoch = LINES_TRAIN // LINES_BS
    epochs = STARNET_STEPS // per_epoch
    schedule = (epochs, per_epoch)
    out = os.path.join(tmp, "starnet_train_out")
    argv = lines_argv(STARNET_TRAIN_CFG, out, line_train, line_eval, epochs)
    config = lines_config(argv)
    batches = first_batches(config, 2, F32_BS, small)

    starnet_check = compare_f32_step(
        config, dev, batches[0], card, what="bs %d, 1x32x320, the freeze off and the TPS off "
        "RARE's init (fc2 weight ~ N(0, 0.02), fiducials x1.1): its gradients held too" % F32_BS,
        tag="starnet-f32", schedule=schedule, zero_grad=bn_fed_biases, focus="transform.",
        card_floors=True, prepare=off_rare)
    starnet_freeze(config, dev, batches, schedule)
    checkpoint_round_trip(config, dev, batches, tmp, tag="starnet-ckpt", schedule=schedule)
    torch.cuda.synchronize()
    report, run_s = train_run(argv)
    losses = report["losses"]
    check(report["steps"] == STARNET_STEPS and len(losses) == STARNET_STEPS,
          "starnet-train: %d steps, not %d" % (report["steps"], STARNET_STEPS))
    check(bool(np.isfinite(losses).all()), "starnet-train: a loss is not finite")
    start = build_train_model(config, torch.device("cpu")).state_dict()
    latest = model_state(os.path.join(out, "latest"), torch.device("cpu"))
    tps = [k for k in start if k.startswith("transform.") and "running" not in k
           and "num_batches" not in k]
    check(all(torch.equal(latest[k], start[k]) for k in tps), "starnet-train: the transform "
          "moved inside the published freeze")
    best = report["best"]
    say("starnet-train", "rec_vgg_tps_bilstm_ctc_synth.yml as published (TPS large, VGG v1, "
        "BiLSTM 256, bs %d at 1x32x320, bf16 autocast, amsgrad + WarmupPolyLR, RecAug, 8 loader "
        "threads, freeze_transform_epochs %d) through tools.train.run: %d steps on phase 12's "
        "%d lines, the transform's %d parameters at their init bit for bit after them; mean "
        "loss of the first 10 steps %.4f, of the last 10 %.4f; the eval: %s"
        % (LINES_BS, config["Global"]["freeze_transform_epochs"], report["steps"], LINES_TRAIN,
           len(tps), float(np.mean(losses[:10])), float(np.mean(losses[-10:])),
           ", ".join("%s %.4f" % (k, v) for k, v in best.items() if k != "best_model_epoch")))
    report_lines_train("starnet-train", report, run_s, card)
    ckpt = os.path.join(out, "best_accuracy")
    metric = eval_run(argv + ["Global.checkpoints=%s" % ckpt])
    keys = ("acc", "norm_edit_dis")
    check(all(metric[k] == best[k] for k in keys), "starnet-eval: tools.eval.run gives %s, the "
          "train run logged %s" % ([metric[k] for k in keys], [best[k] for k in keys]))
    say("starnet-eval", "tools.eval.run on best_accuracy: acc %.4f, norm_edit_dis %.4f, equal to "
        "the train run's; %.1f lines/s on %s" % (metric["acc"], metric["norm_edit_dis"],
                                                 metric["fps"], card))
    served_equals_eval("starnet-serve", "rec", os.path.join(out, "config.yml"), ckpt, line_eval,
                       dev, card, config["Eval"]["loader"]["batch_size_per_card"], torch.float32)
    later(starnet_check)
    say("zoo-train", "phase 17 took %.1f s" % (time.perf_counter() - t_phase))
    return k1

TABLE_CH_CFG = os.path.join(REPO, "configs", "table", "table_sla_ch.yml")
TABLE_TRAIN_CFG = os.path.join(REPO, "configs", "table", "table_sla_synth.yml")
# phase 18: drawn tables (train, eval; eval one batch of table_sla_ch.yml's
# 48), the float32 serving comparison's tables, the steps of
# tools.train.run (4 epochs of 10 batches of 16), the loss check (the mean
# of the last 10 steps under this share of the first 10's), and the
# decoded boxes' tolerance between the card and the CPU in source pixels
TABLE_TRAIN, TABLE_EVAL, TABLE_F32_N, TABLE_STEPS, TABLE_FALL = 160, 48, 8, 40, 0.7
TABLE_BOX_TOL = 1e-3  # px; 0.05 until the card read 6.1e-5 in four runs
TABLE_MIN_TOKENS = 20  # the seeded decode: tokens before eos on most tables
# phase 18's convergence check, written down in PERF.md before the first
# card run: one fixed batch of 8 drawn tables (table_sla_synth.yml's train
# chain, which has no augmentation), bf16, Adam at a constant LR, the
# config's scheduled sampling and aux count kept; the eval forward's greedy
# decode must read back at least 7 of the 8 structures exactly (TableMetric's
# acc) within the cap, read every TABLE_OVERFIT_EVERY steps; the untrained
# model must fail the same reading. The cap was 600 for the first two card
# runs, which read 7 of 8 at step 125 both times (a step takes ~0.55 s)
TABLE_OVERFIT_N, TABLE_OVERFIT_HITS, TABLE_OVERFIT_LR = 8, 7, 2e-3
TABLE_OVERFIT_CAP, TABLE_OVERFIT_EVERY = 300, 25
# the fixed batch's decode: 81 steps (its tables need at most 70). At the
# published 161 it read 7 of 8 at step 125 in each of five card runs, and a
# step's launches, which bound it, follow the decode's length
TABLE_OVERFIT_LEN = 80


def make_tables(dirname, n, seed):
    """`n` tables drawn with cv2 (no font files): 2-8 rows and 2-6 columns,
    a header row (thead, ruled off) on most, a colspan of 2 in some headers,
    empty cells, Hershey text; and their PubTabNet jsonl (xyxyxyxy boxes of
    each non-empty cell's text; empty cells carry no box)."""
    import cv2
    import numpy as np

    os.makedirs(dirname, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for t in range(n):
        rows, cols = int(rng.randint(2, 9)), int(rng.randint(2, 7))
        cw, ch, pad = int(rng.randint(56, 96)), int(rng.randint(22, 34)), 10
        h, w = rows * ch + 2 * pad, cols * cw + 2 * pad
        img = np.full((h, w, 3), int(rng.randint(215, 256)), np.uint8)
        ink = tuple(int(v) for v in rng.randint(0, 80, 3))
        grid = rng.rand() < 0.5
        header = rng.rand() < 0.7
        span = header and cols >= 3 and rng.rand() < 0.4
        span_at = int(rng.randint(0, cols - 1)) if span else -1
        scale = float(rng.uniform(0.35, 0.5))
        tokens, cells = [], []
        for r in range(rows):
            if r == 0:
                tokens += ["<thead>"] if header else ["<tbody>"]
            elif r == 1 and header:
                tokens += ["<tbody>"]
            tokens.append("<tr>")
            c = 0
            while c < cols:
                wide = r == 0 and c == span_at
                x0, x1 = pad + c * cw, pad + (c + (2 if wide else 1)) * cw
                y0, y1 = pad + r * ch, pad + (r + 1) * ch
                tokens += ["<td", ' colspan="2"', ">", "</td>"] if wide else ["<td>", "</td>"]
                if grid:
                    cv2.rectangle(img, (x0, y0), (x1, y1), ink, 1)
                if rng.rand() < 0.15 and r > 0:
                    cells.append({"tokens": []})
                else:
                    k = int(rng.randint(1, max(2, (x1 - x0 - 8) // 9)))
                    text = "".join(rng.choice(list(ALNUM), k))
                    (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
                    tx, ty = x0 + 4, y0 + (ch + th) // 2
                    cv2.putText(img, text, (tx, ty), cv2.FONT_HERSHEY_SIMPLEX, scale, ink, 1,
                                cv2.LINE_AA)
                    cells.append({"tokens": list(text), "bbox": [
                        tx, ty - th, tx + tw, ty - th, tx + tw, ty + base, tx, ty + base]})
                c += 2 if wide else 1
            tokens.append("</tr>")
            if r == 0 and header:
                tokens.append("</thead>")
                cv2.line(img, (pad, pad + ch), (w - pad, pad + ch), ink, 2)
        tokens.append("</tbody>")
        cv2.line(img, (pad, pad), (w - pad, pad), ink, 1)
        cv2.line(img, (pad, h - pad), (w - pad, h - pad), ink, 1)
        path = os.path.join(dirname, "table_%04d.png" % t)
        cv2.imwrite(path, img)
        lines.append(json.dumps({"img_path": path, "html": {
            "cells": cells, "structure": {"tokens": tokens}}}))
    label = os.path.join(dirname, "label.jsonl")
    with open(label, "w") as f:
        f.write("\n".join(lines) + "\n")
    return label


def table_config(cfg_path, eval_label):
    """The table config as published (its head sized by the post process's
    table), its eval pointed at drawn tables."""
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools.train import set_head_channels

    config = program.preprocess(argv=["-c", cfg_path, "-o",
                                      "Eval.dataset.label_file_list=[%s]" % eval_label])[0]
    post = build_post_process(config["PostProcess"], config["Global"])
    set_head_channels(config, post)
    return config, post


def tokens_to_eos(tokens, eos):
    """Each row's steps before its first eos past step 0, where
    TableLabelDecode stops."""
    out = []
    for row in tokens.tolist():
        end = row.index(eos, 1) if eos in row[1:] else len(row)
        out.append(row[:end])
    return out


def table_serve(dev, card, tmp, eval_label):
    """Phase 18 (a): table_sla_ch.yml served with seeded weights through
    program.evaluate (the module docstring)."""
    import copy

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.metrics import build_metric
    from pytorchocr_tpu_torch.ops import int8_conv, propagate, requant, runmax
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.trainer import build_input_transform, make_eval_step
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.seeded import decisive_sla_head_

    t_start = time.perf_counter()
    config, post = table_config(TABLE_CH_CFG, eval_label)
    eos = post.dict["eos"]
    steps = config["Architecture"]["Head"]["max_text_length"] + 1
    loader, _ = build_dataloader(config, "Eval", get_logger(name="root"))
    batches = list(loader)
    check(len(batches) == 1 and len(batches[0][0]) == TABLE_EVAL, "table-serve: the eval loader "
          "gave %s tables a batch" % [len(b[0]) for b in batches])
    batch = batches[0]
    # table_sla_ch.yml normalizes on the host: its images arrive as float32
    norm = build_input_transform(config["Global"].get("_device_normalize_spec", {}).get(
        "Eval")) or (lambda x: x.float())
    model = build_train_model(config, dev)
    with float32_on_card():
        images = norm(torch.from_numpy(batch[0]).to(dev)).permute(0, 3, 1, 2)
        td = [post.dict[t] for t in post.td_token if t in post.dict]
        first_eos, td_share = decisive_sla_head_(model, images, eos, boxes=td,
                                                 min_tokens=TABLE_MIN_TOKENS)
    del images
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t_seeded = time.perf_counter()

    # float32 on the card (TF32 off) against the CPU on the first tables
    cpu = torch.device("cpu")
    model_cpu = build_train_model(config, cpu)
    model_cpu.load_state_dict(state)
    sub = [x[:TABLE_F32_N] for x in batch]
    runs = []
    with float32_on_card():
        for m, d in ((model, dev), (model_cpu, cpu)):
            preds = make_eval_step(m, input_transform=norm)(torch.from_numpy(sub[0]).to(d))
            preds = {k: v.float().cpu() for k, v in preds.items()}
            runs.append((preds, post(preds, sub)))
    (p_card, r_card), (p_cpu, r_cpu) = runs
    t_card, t_cpu = p_card["structure_probs"].argmax(-1), p_cpu["structure_probs"].argmax(-1)
    top2 = p_cpu["structure_probs"].double().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    firsts, diff = [], 0.0
    for i in range(TABLE_F32_N):
        seq_cpu, seq_card = tokens_to_eos(t_cpu[i : i + 1], eos)[0], \
            tokens_to_eos(t_card[i : i + 1], eos)[0]
        differ = (t_card[i] != t_cpu[i]).nonzero()
        d = int(differ[0]) if len(differ) else steps
        if seq_cpu == seq_card:
            d = max(d, len(seq_cpu) + 1)  # equal up to eos: later steps are not read
        firsts.append(d)
        upto = min(d, steps)
        diff = max(diff, float((p_card["structure_probs"][i, :upto]
                                - p_cpu["structure_probs"][i, :upto]).abs().max()))
    excused, equal = 0, 0
    for i, d in enumerate(firsts):
        n_cpu = len(tokens_to_eos(t_cpu[i : i + 1], eos)[0])
        if d > n_cpu:
            equal += 1
            continue
        near = float(margin[i, : d + 1].min())
        check(near <= 2 * diff, "table-serve-f32: table %d's token sequence differs from the "
              "CPU's at step %d, the CPU's smallest top-2 margin up to there %.3g (2x the largest "
              "probability difference before it: %.3g)" % (i, d, near, 2 * diff))
        excused += 1
    box_err, boxes = 0.0, 0
    td = set(td)
    for i, d in enumerate(firsts):
        a, b = r_card[0]["bbox_batch_list"][i], r_cpu[0]["bbox_batch_list"][i]
        # the boxes of the td steps that both runs decode alike (before the first difference)
        n_td = sum(c in td for c in tokens_to_eos(t_cpu[i : i + 1], eos)[0][:d])
        check(len(a) >= n_td and len(b) >= n_td, "table-serve-f32: table %d decoded %d and %d "
              "td boxes, %d steps alike" % (i, len(a), len(b), n_td))
        if n_td:
            box_err = max(box_err, float(np.abs(np.asarray(a[:n_td]) - np.asarray(b[:n_td]))
                                     .max()))
            boxes += n_td
    check(box_err <= TABLE_BOX_TOL, "table-serve-f32: decoded td boxes %.4g px apart (tolerance "
          "%g px)" % (box_err, TABLE_BOX_TOL))
    lengths = [len(x) for x in tokens_to_eos(t_cpu, eos)]
    long = sum(n >= TABLE_MIN_TOKENS for n in lengths)
    check(long >= (3 * TABLE_F32_N) // 4, "table-serve: the seeded decode gives %s tokens before "
          "eos (at least %d on %d of %d tables wanted)" % (lengths, TABLE_MIN_TOKENS,
                                                           (3 * TABLE_F32_N) // 4, TABLE_F32_N))
    say("table-serve-f32", "table_sla_ch.yml (PPLCNet x1.0, CSPPAN 96, SLAHead 256, %d classes, "
        "%d decode steps at 480x480) with seeded weights and the decisive head "
        "(utils.seeded.decisive_sla_head_: eos's first win at steps %s on the %d tables, td "
        "tokens raised to %.2f of the steps), float32 "
        "on the card (TF32 off) against the CPU on %d tables: token sequences equal up to eos on "
        "%d, %d excused (they differ only after a step whose CPU top-2 margin is within 2x the "
        "largest probability difference before it, %.3g), tokens before eos %s; decoded td "
        "boxes %.4g px apart at most over %d boxes (tolerance %g px); %s"
        % (len(post.character), steps, first_eos[:TABLE_F32_N], TABLE_EVAL, td_share,
           TABLE_F32_N, equal,
           excused, 2 * diff, lengths, box_err, boxes, TABLE_BOX_TOL, card))
    del model_cpu
    t_f32 = time.perf_counter()

    # the bf16 main path: program.evaluate over the 48 tables, one batch
    runmax.launches = propagate.launches = int8_conv.launches = requant.launches = 0
    eval_step = make_eval_step(model, input_transform=norm, amp=True)
    metric_class = build_metric(config["Metric"])
    eval_step(torch.from_numpy(batch[0]).to(dev))  # warm
    torch.cuda.synchronize()
    timed = paused()  # the bf16 runs' times, through the profiler's
    timed.__enter__()
    t0 = time.perf_counter()
    metric = program.evaluate(eval_step, loader, post, metric_class, "table", dev)
    wall = time.perf_counter() - t0
    ours = (runmax.launches, propagate.launches, int8_conv.launches, requant.launches)
    check(ours == (0, 0, 0, 0), "table-serve: the table path launched the port's kernels %s"
          % (ours,))
    images = torch.from_numpy(batch[0]).to(dev)
    marks = {}

    def mark(name):
        def hook(*args):
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()
        return hook

    hooks = [model.head.register_forward_pre_hook(mark("head0")),
             model.head.register_forward_hook(mark("head1"))]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    preds = eval_step(images)
    end.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    fwd_ms, head_ms = start.elapsed_time(end), marks["head0"].elapsed_time(marks["head1"])
    decoded = post(preds, batch)[0]["structure_batch_list"]
    n_tokens = [len(x) for x, _ in decoded]
    def encoder():
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            model.eval()
            model.neck(model.backbone(norm(images).permute(0, 3, 1, 2)))

    t1 = time.perf_counter()
    eval_step(images)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t1
    events = card_events(lambda: eval_step(images))
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    # the head's launches: the backbone's and the neck's taken out
    launches = sum(e.count for e in events) - sum(e.count for e in card_events(encoder))
    timed.__exit__()
    busy = "card busy %.1f ms of a %.1f ms call (%.1f%%, torch.profiler)" % (
        busy_ms, 1e3 * call_s, 100.0 * busy_ms / (1e3 * call_s))
    say("table-serve", "bf16 (the config's use_amp) through program.evaluate (the port's eval "
        "CLI path) on %d tables, one batch of %d: %.2f tables/s (the evaluate's forward and "
        "sync), %.2f tables/s over the call (%.3f s, the post process and metric included); "
        "acc %.4f, token_acc %.4f (seeded weights); tokens decoded per table %d-%d (mean %.1f); "
        "the decode loop %.1f of the forward's %.1f ms (%.1f%%, CUDA events around the head); "
        "%d kernel launches in the head's %d steps, %.1f a step (torch.profiler); %s; the "
        "port's four kernels launched 0 times on this path; %s"
        % (TABLE_EVAL, TABLE_EVAL, metric["fps"], TABLE_EVAL / wall, wall, metric["acc"],
           metric["token_acc"], min(n_tokens), max(n_tokens), float(np.mean(n_tokens)), head_ms,
           fwd_ms, 100.0 * head_ms / fwd_ms, launches, steps, launches / steps, busy, card))
    say("table-serve", "took %.1f s: the seeded model and its decisive head %.1f s, the float32 "
        "comparison %.1f s, the bf16 runs %.1f s" % (
            time.perf_counter() - t_start, t_seeded - t_start, t_f32 - t_seeded,
            time.perf_counter() - t_f32))
    return copy.deepcopy(metric)


def table_overfit(dev, card, tmp):
    """Phase 18 (c): the convergence check (the constants above), the
    untrained model's reading failing it, and the checkpoint read by the
    eval CLI's entry point. The config is table_sla_synth.yml with its
    decode cut to TABLE_OVERFIT_LEN steps (the drawn tables' structures
    take at most 68 tokens; a train step's cost follows the decode's
    length: its launches bound it)."""
    import torch

    from pytorchocr_tpu_torch.metrics import build_metric
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools.train import set_head_channels
    from pytorchocr_tpu_torch.trainer import (batch_to_device, build_input_transform,
                                              make_eval_step)
    from pytorchocr_tpu_torch.utils.config import load_config, save_config
    from pytorchocr_tpu_torch.utils.save_load import save_model

    tag = "table-overfit"
    label = make_tables(os.path.join(tmp, tag), TABLE_OVERFIT_N, SEED + 83)
    written = load_config(TABLE_TRAIN_CFG)
    written["Global"]["max_text_length"] = TABLE_OVERFIT_LEN
    written["Architecture"]["Head"]["max_text_length"] = TABLE_OVERFIT_LEN
    for mode in ("Train", "Eval"):
        written[mode]["dataset"]["label_file_list"] = [label]
        for op in written[mode]["dataset"]["transforms"]:
            if "TableLabelEncode" in op:
                op["TableLabelEncode"]["max_text_length"] = TABLE_OVERFIT_LEN
    cfg_path = os.path.join(tmp, tag + ".yml")
    save_config(written, cfg_path)
    cfg = program.preprocess(argv=["-c", cfg_path])[0]
    set_head_channels(cfg, build_post_process(cfg["PostProcess"], cfg["Global"]))
    cfg["Optimizer"] = {"base_lr": TABLE_OVERFIT_LR, "optim": {"name": "Adam"}}
    raw = first_batches(cfg, 1, TABLE_OVERFIT_N, label)[0]
    check(len(raw[0]) == TABLE_OVERFIT_N, "%s: a batch of %d tables" % (tag, len(raw[0])))
    batch = batch_to_device(raw, dev)
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    metric = build_metric(cfg["Metric"])
    model, opt, step = train_parts(cfg, dev, amp=True, schedule=(TABLE_OVERFIT_CAP, 1))
    eval_step = make_eval_step(model, build_input_transform(
        cfg["Global"]["_device_normalize_spec"].get("Eval")), amp=True)

    def reading():
        metric(post(eval_step(batch[0]), raw), raw)
        out = metric.get_metric()
        return int(round(out["acc"] * TABLE_OVERFIT_N)), out["token_acc"]

    untrained = reading()
    check(untrained[0] < TABLE_OVERFIT_HITS, "%s: the untrained model reads back %d of %d "
          "structures: the check cannot fail" % (tag, untrained[0], TABLE_OVERFIT_N))
    curve, done, hits = [], 0, untrained
    note = beside_worker()
    t0 = time.perf_counter()
    while done < TABLE_OVERFIT_CAP and hits[0] < TABLE_OVERFIT_HITS:
        for _ in range(TABLE_OVERFIT_EVERY):
            losses = step(batch)
        done += TABLE_OVERFIT_EVERY
        hits = reading()
        curve.append((done, float(losses["loss"]), hits[0], hits[1]))
    secs = time.perf_counter() - t0
    say(tag, "one fixed batch of %d drawn tables (table_sla_synth.yml's chain, no "
        "augmentation, the decode cut to %d steps), bf16, Adam at LR %g, scheduled sampling %g "
        "and aux count as published: "
        "%d of %d structures read back exactly (eval-mode greedy decode, TableMetric's acc) "
        "after %d steps (threshold %d within %d; untrained: %d, token_acc %.4f), %.1f s (%.2f "
        "steps/s with the reads%s); loss, structures and token_acc every %d steps: %s on %s"
        % (TABLE_OVERFIT_N, TABLE_OVERFIT_LEN + 1, TABLE_OVERFIT_LR,
           cfg["Architecture"]["Head"]["scheduled_sampling_p"],
           hits[0], TABLE_OVERFIT_N, done, TABLE_OVERFIT_HITS, TABLE_OVERFIT_CAP, untrained[0],
           untrained[1], secs, done / secs, note, TABLE_OVERFIT_EVERY,
           ", ".join("%d: %.3f %d %.3f" % c for c in curve[:: max(1, len(curve) // 12)]), card))
    check(hits[0] >= TABLE_OVERFIT_HITS, "%s: %d of %d structures read back after %d steps (at "
          "least %d within %d)" % (tag, hits[0], TABLE_OVERFIT_N, done, TABLE_OVERFIT_HITS,
                                   TABLE_OVERFIT_CAP))
    out = os.path.join(tmp, tag + "_out")
    save_model(model, opt, {"start_epoch": 1, "global_step": done, "best_model": {}}, out,
               prefix="best_accuracy")
    cli = eval_run(["-c", cfg_path, "-o",
                        "Global.checkpoints=%s" % os.path.join(out, "best_accuracy")])
    # token_acc is a mean over the tables, summed here in the train loader's order
    check(round(cli["acc"] * TABLE_OVERFIT_N) == hits[0] and abs(cli["token_acc"] - hits[1])
          <= 1e-9,
          "%s: python -m pytorchocr_tpu_torch.tools.eval reads acc %.4f, token_acc %.6f; the "
          "loop read %d of %d, %.6f" % (tag, cli["acc"], cli["token_acc"], hits[0],
                                        TABLE_OVERFIT_N, hits[1]))
    say(tag + "-eval", "tools.eval.run (what python -m pytorchocr_tpu_torch.tools.eval runs) on "
        "that checkpoint: acc %.4f (%d of %d), token_acc %.4f, the loop's reading; %.1f tables/s"
        % (cli["acc"], hits[0], TABLE_OVERFIT_N, cli["token_acc"], cli["fps"]))


def phase_table(dev, card, tmp):
    """Phase 18: SLANet on the card (the module docstring)."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools.train import set_head_channels
    from pytorchocr_tpu_torch.utils.logging import get_logger

    t_phase = time.perf_counter()
    logger = get_logger(name="root")
    for h in logger.handlers:
        h.setLevel(logging.WARNING)
    train_label = make_tables(os.path.join(tmp, "tables_train"), TABLE_TRAIN, SEED + 81)
    eval_label = make_tables(os.path.join(tmp, "tables_eval"), TABLE_EVAL, SEED + 82)
    say("table-data", "%d train and %d eval tables drawn with cv2 (2-8 rows, 2-6 columns, "
        "headers, colspans, empty cells, Hershey text) in %.1f s"
        % (TABLE_TRAIN, TABLE_EVAL, time.perf_counter() - t_phase))

    parts = {}

    def part(name, t):
        parts[name] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    # (a) serving table_sla_ch.yml
    table_serve(dev, card, tmp, eval_label)
    t = part("serve", t)

    # (b) training table_sla_synth.yml as published
    per_epoch = TABLE_TRAIN // 16
    epochs = TABLE_STEPS // per_epoch
    schedule = (epochs, per_epoch)
    out = os.path.join(tmp, "table_train_out")
    argv = train_argv(out, train_label, eval_label, epochs, TABLE_TRAIN_CFG)
    config = program.preprocess(is_train=True, argv=argv)[0]
    set_head_channels(config, build_post_process(config["PostProcess"], config["Global"]))
    check(config["Train"]["loader"]["batch_size_per_card"] == 16, "table-train: bs %s"
          % config["Train"]["loader"]["batch_size_per_card"])
    small = os.path.join(tmp, "tables_train", "first.jsonl")
    with open(small, "w") as f:
        f.write("".join(open(train_label).readlines()[: 2 * 2]))
    batches = first_batches(config, 2, 2, small)
    f32_check = compare_f32_step(
        config, dev, batches[0], card, what="bs 2, 480x480, 161 decode steps, scheduled "
        "sampling 0.25 (the card's coins and fed-back tokens replayed)", tag="table-f32",
        schedule=schedule, zero_grad=bn_fed_biases, focus="head.decode.rnn.", card_floors=True,
        loss_pieces=True)
    t = part("f32 step", t)
    checkpoint_round_trip(config, dev, batches, tmp, tag="table-ckpt", schedule=schedule)
    t = part("round trip", t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    report, run_s = train_run(argv)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = report["losses"]
    check(report["steps"] == TABLE_STEPS and len(losses) == TABLE_STEPS,
          "table-train: %d steps, not %d" % (report["steps"], TABLE_STEPS))
    check(bool(np.isfinite(losses).all()), "table-train: a loss is not finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < TABLE_FALL * first, "table-train: the mean loss of the last 10 steps %.4f is "
          "not under %g of the first 10's %.4f" % (last, TABLE_FALL, first))
    best = report["best"]
    say("table-train", "table_sla_synth.yml as published (PPLCNet x1.0, CSPPAN 96, SLAHead 256, "
        "161 steps, aux count, scheduled sampling 0.25, label smoothing 0.1, bs 16 at 480x480, "
        "bf16 autocast, amsgrad + WarmupPolyLR, 8 loader threads) through tools.train.run: %d "
        "steps (%d epochs of %d drawn tables); mean loss of the first 10 steps %.4f, of the last "
        "10 %.4f (%.3f of it; the check: under %g); loss every 4 steps: %s; the eval on %d "
        "tables: %s; peak memory %.2f GB (max_memory_allocated)"
        % (report["steps"], epochs, TABLE_TRAIN, first, last, last / first, TABLE_FALL,
           ", ".join("%.3f" % v for v in losses[::4]), TABLE_EVAL,
           ", ".join("%s %.4f" % (k, v) for k, v in best.items() if k != "best_model_epoch"),
           peak))
    report_lines_train("table-train", report, run_s, card)
    ckpt = os.path.join(out, "best_accuracy")
    metric = eval_run(argv + ["Global.checkpoints=%s" % ckpt])
    keys = ("acc", "token_acc")
    check(all(metric[k] == best[k] for k in keys), "table-eval: tools.eval.run gives %s, the "
          "train run logged %s" % ([metric[k] for k in keys], [best[k] for k in keys]))
    say("table-eval", "tools.eval.run on best_accuracy: acc %.4f, token_acc %.4f, equal to the "
        "train run's; %.2f tables/s (forward and sync, bs 16) on %s"
        % (metric["acc"], metric["token_acc"], metric["fps"], card))
    t = part("train and eval CLIs", t)

    # (c) the fixed-batch convergence check
    beside_run(table_overfit, dev, card, tmp)
    part("convergence (handed to the side process)", t)
    later(f32_check)
    say("table", "phase 18 took %.1f s: %s" % (time.perf_counter() - t_phase, ", ".join(
        "%s %.1f s" % kv for kv in parts.items())))


CML_CFG = os.path.join(REPO, "configs", "det", "distillation", "det_cml_db_synth.yml")
DISTILL_CFG = os.path.join(REPO, "configs", "det", "distillation", "det_distill_db_synth.yml")
DML_CFG = os.path.join(REPO, "configs", "det", "distillation", "det_dml_db_synth.yml")
REC_DML_CFG = os.path.join(REPO, "configs", "rec", "distillation", "rec_dml_ctc_synth.yml")
DISTILL_BS = 8  # the det distillation configs' batch
# phase 19's tools.train.run steps (epochs of 64 / 8 pages, or 2,560 / 128 lines); CML's
# mean loss of the last 8 steps must fall under CML_FALL of the first 8's
CML_STEPS, CML_FALL, DISTILL_STEPS, DML_STEPS, REC_DML_STEPS = 24, 0.8, 8, 8, 40
# phase 19 (b)'s convergence check, written down in PERF.md before the run
# that first checked it in this form: one fixed batch of DISTILL_OVERFIT_N of
# phase 11's pages through det_distill_db_synth.yml's train chain (its
# augmentation drawn once), bf16, its amsgrad at the constant LR
# DISTILL_OVERFIT_LR, the teacher phase 11's checkpoint; read every
# DISTILL_OVERFIT_EVERY steps at the scale it trains at: the student's eval
# boxes on the batch's crops must match at least DISTILL_OVERFIT_SHARE of the
# teacher's (IoU >= 0.5 of their rectangles, one to one) within
# DISTILL_OVERFIT_CAP steps; the untrained student must not. (Read at the
# eval chain's 736, a student of 4 or 2 crops matched at most 0.585 within
# 1,200 steps: PERF.md.)
DISTILL_OVERFIT_N, DISTILL_OVERFIT_LR, DISTILL_OVERFIT_SHARE = 2, 2e-3, 0.8
DISTILL_OVERFIT_CAP, DISTILL_OVERFIT_EVERY, DISTILL_OVERFIT_MIN_BOXES = 1000, 50, 20


class SubmodelPretrained:
    """A distillation model's `pretrained` sub-models loaded as tools.train
    loads them (load_submodel_pretrained), as the float32-step check's
    `prepare` (the teacher's weights in every step alike)."""

    def __init__(self, arch):
        self.arch = arch

    def __call__(self, model):
        from pytorchocr_tpu_torch.utils.save_load import load_submodel_pretrained

        load_submodel_pretrained(model, self.arch)


def distill_train(tag, cfg_path, dev, card, tmp, train_label, eval_label, steps, teacher=None,
                  fall=None):
    """A det distillation config as published (bs 8 at 640x640, bf16, 8
    loader threads; the teacher, if any, from phase 11's checkpoint
    directory `teacher`) through tools.train.run for `steps` steps on phase
    11's pages, every K1 launch of its evaluate (DistillationDBPostProcess:
    one DBPostProcess a student) held to the plain version, then
    tools.eval.run on best_accuracy equal to it. Returns the K1 launches,
    the output directory and the argv."""
    import numpy as np
    import torch

    name = os.path.relpath(cfg_path, REPO)
    epochs = steps // (TRAIN_PAGES // DISTILL_BS)
    out = os.path.join(tmp, tag + "_out")
    argv = train_argv(out, train_label, eval_label, epochs, cfg_path)
    if teacher:
        argv.append("Architecture.Models.Teacher.pretrained=%s" % teacher)
    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_kernels() as rec:
        report, run_s = train_run(argv)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    k1 = rec.k1_launches
    shapes = rec.hold(tag + "-train-eval")
    losses = report["losses"]
    check(report["steps"] == steps and len(losses) == steps,
          "%s-train: %d steps, not %d" % (tag, report["steps"], steps))
    check(bool(np.isfinite(losses).all()), "%s-train: a loss is not finite" % tag)
    first, last = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    if fall is not None:
        check(last < fall * first, "%s-train: the mean loss of the last 8 steps %.4f is not under "
              "%g of the first 8's %.4f" % (tag, last, fall, first))
    check(k1 > 0, "%s-train: the evaluate after training launched no run-max kernel" % tag)
    best, wall = report["best"], report["wall_s"]
    students = [k[: -len("_hmean")] for k in best if k.endswith("_hmean")]
    check(best["hmean"] == max(best[s + "_hmean"] for s in students), "%s-train: the metric's "
          "hmean %.4f is not its best student's" % (tag, best["hmean"]))
    say(tag + "-train", "%s as published (bs %d at %dx%d, bf16 autocast, amsgrad + WarmupPolyLR, "
        "8 loader threads%s) through tools.train.run: %d steps (%d epochs of %d drawn pages); mean "
        "loss of the first 8 steps %.4f, of the last 8 %.4f (%.3f of it%s); loss every 4 "
        "steps: %s; the evaluate's %s"
        % (name, DISTILL_BS, TRAIN_SIZE, TRAIN_SIZE,
           ", the teacher phase 11's checkpoint" if teacher else "", report["steps"], epochs,
           TRAIN_PAGES, first, last, last / first,
           "; the check: under %g" % fall if fall is not None else "",
           ", ".join("%.3f" % v for v in losses[::4]),
           ", ".join("%s %.4f" % (k, v) for k, v in best.items()
                     if k.endswith(("hmean", "precision", "recall")))))
    say(tag + "-train", "%.3f steps/s, %.1f samples/s over the train iterations (%.1f s of %.1f s "
        "in the call); loader wait %.1f%%, the batches' host-to-device copies (with the wait for "
        "the step before them) %.1f%%; torch.cuda.max_memory_allocated %.2f GB; %s"
        % (report["steps"] / wall, report["samples"] / wall, wall, run_s,
           100.0 * report["reader_s"] / wall, 100.0 * report["copy_s"] / wall, peak, card))
    say(tag + "-train-eval", "bucketed evaluate after the last epoch on %d pages through "
        "DistillationDBPostProcess (%s): runmax.launches %d (alternations %d), each launch's "
        "output and changed flag == the plain version on its inputs (%s); %.2f pages/s on %s"
        % (EVAL_PAGES, ", ".join(students), k1, rec.alternations, shapes, best["fps"], card))
    metric = eval_run(argv + ["Global.checkpoints=%s" % os.path.join(out, "best_accuracy")])
    keys = ["hmean"] + [s + "_" + m for s in students for m in ("hmean", "precision", "recall")]
    check(all(metric[k] == best[k] for k in keys), "%s-eval: tools.eval.run on best_accuracy "
          "gives %s, the train run's evaluate %s" % (tag, [metric[k] for k in keys],
                                                     [best[k] for k in keys]))
    say(tag + "-eval", "tools.eval.run on best_accuracy: %s, equal to the train run's; %.2f "
        "pages/s on %s" % (", ".join("%s %.4f" % (k, metric[k]) for k in keys), metric["fps"],
                           card))
    return k1, out, argv


def distill_overfit(config, dev, card, tmp, train_label):
    """Phase 19 (b)'s convergence check (the constants above): the distill
    student, trained on one fixed batch with the teacher's maps and the
    ground truth (the config's losses), reproduces the teacher's eval boxes
    on the batch's crops."""
    import copy

    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform, make_eval_step
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import load_submodel_pretrained

    tag = "distill-overfit"
    label = os.path.join(tmp, tag + "_label.txt")
    with open(train_label) as f, open(label, "w") as g:
        g.writelines(f.readlines()[:DISTILL_OVERFIT_N])
    cfg = copy.deepcopy(config)
    cfg["Optimizer"].pop("lr_decay")
    cfg["Optimizer"]["base_lr"] = DISTILL_OVERFIT_LR
    raw = first_batches(cfg, 1, DISTILL_OVERFIT_N, label)[0]
    batch = batch_to_device(raw, dev)
    crops = os.path.join(tmp, tag + "_crops")
    os.makedirs(crops)
    lines = []
    for i, image in enumerate(raw[0]):  # RGB, as the chain decodes it
        path = os.path.join(crops, "crop_%d.png" % i)
        cv2.imwrite(path, np.ascontiguousarray(image[..., ::-1]))
        lines.append("%s\t%s\n" % (path, json.dumps([{"transcription": "x", "points": [
            [0, 0], [8, 0], [8, 8], [0, 8]]}])))  # no metric here: a placeholder box
    with open(os.path.join(crops, "label.txt"), "w") as f:
        f.writelines(lines)
    cfg["Eval"]["dataset"]["label_file_list"] = [os.path.join(crops, "label.txt")]
    for op in cfg["Eval"]["dataset"]["transforms"]:  # read at the scale the batch trains at
        if "DetResizeForTest" in op:
            op["DetResizeForTest"] = {"limit_side_len": TRAIN_SIZE, "limit_type": "min"}
    model, opt, step = train_parts(cfg, dev, amp=True, schedule=(DISTILL_OVERFIT_CAP, 1))
    load_submodel_pretrained(model, cfg["Architecture"])
    check(abs(opt.current_lr() - DISTILL_OVERFIT_LR) <= 1e-6 * DISTILL_OVERFIT_LR,
          "%s: LR %g, not the constant %g" % (tag, opt.current_lr(), DISTILL_OVERFIT_LR))
    eval_step = make_eval_step(model, build_input_transform(
        cfg["Global"]["_device_normalize_spec"].get("Eval")), amp=True)
    post = build_post_process(cfg["PostProcess"], cfg["Global"]).post_process
    pages = list(build_dataloader(cfg, "Eval", get_logger(name="root"))[0])

    def boxes(preds, shape):
        points = post({"maps": preds["maps"].float()}, shape)[0]["points"]
        return [(np.asarray(b).reshape(-1).tolist(), "", 0.0) for b in points]

    def reading():
        student, teacher = [], []
        for p in pages:
            preds = eval_step(torch.from_numpy(p[0]).to(dev))
            student.append(boxes(preds["Student"], p[1]))
            teacher.append(boxes(preds["Teacher"], p[1]))
        n = sum(len(t) for t in teacher)
        return match_iou(student, teacher)[0] / max(n, 1), n, sum(len(s) for s in student)

    untrained = reading()
    check(untrained[1] >= DISTILL_OVERFIT_MIN_BOXES, "%s: the teacher finds %d boxes on the %d "
          "crops (at least %d)" % (tag, untrained[1], len(pages), DISTILL_OVERFIT_MIN_BOXES))
    check(untrained[0] < DISTILL_OVERFIT_SHARE, "%s: the untrained student matches %.3f of the "
          "teacher's boxes: the check cannot fail" % (tag, untrained[0]))
    curve, done, got = [], 0, untrained
    note = beside_worker()
    t0 = time.perf_counter()
    while done < DISTILL_OVERFIT_CAP and got[0] < DISTILL_OVERFIT_SHARE:
        for _ in range(DISTILL_OVERFIT_EVERY):
            losses = step(batch)
        done += DISTILL_OVERFIT_EVERY
        got = reading()
        curve.append((done, float(losses["loss"]), got[0], got[2]))
    secs = time.perf_counter() - t0
    say(tag, "one fixed batch of %d drawn %dx%d pages (the train chain's augmentation drawn "
        "once), bf16, amsgrad at LR %g, the teacher phase 11's checkpoint: the student matches "
        "%.3f of the teacher's %d eval boxes on its crops (IoU >= 0.5; at least %g within %d "
        "steps) after %d steps (untrained: %.3f, %d boxes), %.1f s (%.2f steps/s with the "
        "reads%s); loss, share and the student's boxes every %d steps: %s on %s"
        % (DISTILL_OVERFIT_N, TRAIN_SIZE, TRAIN_SIZE, DISTILL_OVERFIT_LR, got[0], got[1],
           DISTILL_OVERFIT_SHARE, DISTILL_OVERFIT_CAP, done, untrained[0], untrained[2], secs,
           done / secs, note, DISTILL_OVERFIT_EVERY,
           ", ".join("%d: %.3f %.3f %d" % c for c in curve[:: max(1, len(curve) // 12)]), card))
    check(got[0] >= DISTILL_OVERFIT_SHARE, "%s: the student matches %.3f of the teacher's boxes "
          "after %d steps (at least %g within %d)" % (tag, got[0], done, DISTILL_OVERFIT_SHARE,
                                                      DISTILL_OVERFIT_CAP))


def phase_distill(dev, card, tmp, train_label, eval_label, lines):
    """Phase 19: distillation (module docstring). Returns K1's launches by
    path."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import model_state

    t_phase = time.perf_counter()
    logger = get_logger(name="root")
    for h in logger.handlers:
        h.setLevel(logging.WARNING)
    teacher = os.path.join(tmp, "train_out", "best_accuracy")  # phase 11's DB-ResNet18
    check(os.path.isdir(teacher), "distill: phase 11's checkpoint %s is missing" % teacher)
    parts, k1 = {}, {}

    def part(name, t):
        parts[name] = time.perf_counter() - t
        return time.perf_counter()

    # (a) CML as published: the float32 step, the round trip, training, the evaluate
    t = time.perf_counter()
    per_epoch = TRAIN_PAGES // DISTILL_BS
    schedule = (CML_STEPS // per_epoch, per_epoch)
    argv = train_argv(os.path.join(tmp, "cml_f32"), train_label, eval_label, schedule[0], CML_CFG)
    argv.append("Architecture.Models.Teacher.pretrained=%s" % teacher)
    config = program.preprocess(is_train=True, argv=argv)[0]
    batches = first_batches(config, 2, 2)
    cml_check = compare_f32_step(
        config, dev, batches[0], card, tag="cml-f32", schedule=schedule, loss_pieces=True,
        prepare=SubmodelPretrained(config["Architecture"]), zero_grad=db_student_zero_grad,
        card_floors=True,  # MobileNetV3 students: phase 13's floor form (PERF.md)
        what="bs 2, %dx%d, the teacher phase 11's checkpoint (its forward's pieces replayed "
        "too), the two students' gradients held" % (TRAIN_SIZE, TRAIN_SIZE))
    checkpoint_round_trip(config, dev, batches, tmp, tag="cml-ckpt", schedule=schedule)
    t = part("CML f32 step and round trip", t)
    k1["CML-train-eval"], out, _ = distill_train("cml", CML_CFG, dev, card, tmp, train_label,
                                                 eval_label, CML_STEPS, teacher, CML_FALL)
    want = model_state(teacher, torch.device("cpu"))
    latest = model_state(os.path.join(out, "latest"), torch.device("cpu"))
    held = [k for k in want if not k.startswith("head.thresh.")]
    check(all(torch.equal(latest["models_0." + k], want[k]) for k in held),
          "cml-train: the frozen teacher moved")
    say("cml-train", "the teacher's %d parameters and BN statistics in the latest checkpoint "
        "after %d steps equal phase 11's checkpoint bit for bit (its %d train-only threshold "
        "tower tensors left out: a frozen DB model is built without them)"
        % (len(held), CML_STEPS, len(want) - len(held)))
    t = part("CML training and eval CLI", t)

    # (b) distill and DML, short runs, and the distill student's convergence check
    k1["distill-train-eval"], _, argv = distill_train("distill", DISTILL_CFG, dev, card, tmp,
                                                      train_label, eval_label, DISTILL_STEPS,
                                                      teacher)
    k1["DML-train-eval"] = distill_train("dml", DML_CFG, dev, card, tmp, train_label, eval_label,
                                         DML_STEPS)[0]
    t = part("distill and DML training", t)
    beside_run(distill_overfit, program.preprocess(is_train=True, argv=argv)[0], dev, card, tmp,
               train_label)
    t = part("convergence (handed to the side process)", t)

    # (c) rec DML as published
    line_train, line_eval, small = lines
    per_epoch = LINES_TRAIN // LINES_BS
    schedule = (REC_DML_STEPS // per_epoch, per_epoch)
    out = os.path.join(tmp, "recdml_out")
    argv = lines_argv(REC_DML_CFG, out, line_train, line_eval, schedule[0])
    config = lines_config(argv)
    batches = first_batches(config, 2, F32_BS, small)
    rec_check = compare_f32_step(config, dev, batches[0], card, what="bs %d, 1x32x320, both "
                                 "students" % F32_BS, tag="recdml-f32", schedule=schedule,
                                 zero_grad=bn_fed_biases, focus="rnn.", card_floors=True)
    checkpoint_round_trip(config, dev, batches, tmp, tag="recdml-ckpt", schedule=schedule)
    with recorded_kernels() as rec:
        report, run_s = train_run(argv)
    check(rec.k1_launches == rec.k2_launches == 0, "recdml-train: the rec path launched a kernel")
    losses = report["losses"]
    check(report["steps"] == REC_DML_STEPS and len(losses) == REC_DML_STEPS,
          "recdml-train: %d steps, not %d" % (report["steps"], REC_DML_STEPS))
    check(bool(np.isfinite(losses).all()), "recdml-train: a loss is not finite")
    best = report["best"]
    check(best["acc"] == max(best["Student_acc"], best["Student2_acc"]), "recdml-train: the "
          "metric's acc %.4f is not its best student's" % best["acc"])
    say("recdml-train", "rec_dml_ctc_synth.yml as published (two CRNNs, VGG v1 x0.5, BiLSTM 96, "
        "CTC + DML on the softmax, use_log; bs %d at 1x32x320, bf16 autocast, amsgrad + "
        "WarmupPolyLR, RecAug, 8 loader threads, cal_metric_during_train) through "
        "tools.train.run: %d steps on phase 12's %d lines; mean loss of the first 10 steps "
        "%.4f, of the last 10 %.4f; no kernel launched; the eval: %s"
        % (LINES_BS, report["steps"], LINES_TRAIN, float(np.mean(losses[:10])),
           float(np.mean(losses[-10:])),
           ", ".join("%s %.4f" % (k, v) for k, v in best.items() if k != "best_model_epoch")))
    report_lines_train("recdml-train", report, run_s, card)
    metric = eval_run(argv + ["Global.checkpoints=%s" % os.path.join(out, "best_accuracy")])
    keys = ("acc", "norm_edit_dis", "Student_acc", "Student2_acc")
    check(all(metric[k] == best[k] for k in keys), "recdml-eval: tools.eval.run gives %s, the "
          "train run logged %s" % ([metric[k] for k in keys], [best[k] for k in keys]))
    say("recdml-eval", "tools.eval.run on best_accuracy: %s, equal to the train run's "
        "(DistillationMetric: the better student's); %.1f lines/s on %s"
        % (", ".join("%s %.4f" % (k, metric[k]) for k in keys), metric["fps"], card))
    part("rec DML", t)
    later(cml_check)
    later(rec_check)
    say("distill", "phase 19 took %.1f s: %s" % (time.perf_counter() - t_phase, ", ".join(
        "%s %.1f s" % kv for kv in parts.items())))
    return k1


# phase 20: training across ranks (parallel/) on the one card. (a) the float32
# DB step of phase 11's config at a global batch of DP_F32_BS on 2 gloo ranks;
# (b) DP_STEPS bf16 steps of DP_BS a rank on 2 ranks through torchrun; (c)
# NCCL_STEPS steps through torchrun at world 1 on NCCL against the plain
# process, NCCL_BS a step; (d) the float32 CRNN step of rec_vgg_bilstm_ctc.yml
# on 2 ranks with its CTC head split (model_parallel 2) against 1 rank, TP_BS
# lines
DP_F32_BS, DP_BS, DP_STEPS, NCCL_STEPS, NCCL_BS, TP_BS = 4, 16, 40, 4, 4, 8


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ranks:
    """Processes of this script (`args` after it) started at once: the
    ranks of one world (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT in their environment), or one process under `cmd` (torchrun
    gives its ranks their environment). `wait()` returns their outputs and
    fails on a non-zero exit; leaving the block kills what still runs."""

    def __init__(self, tag, args, world=None, cmd=None):
        self.tag = tag
        if cmd is not None:
            self.procs = [subprocess.Popen(cmd + [os.path.abspath(__file__)] + args, cwd=REPO,
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)]
            return
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + args, cwd=REPO,
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def __enter__(self):
        return self

    def wait(self, timeout=600):
        outs = []
        for p in self.procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            check(p.returncode == 0, "%s: a process exited %s:\n%s" % (self.tag, p.returncode,
                                                                      out[-4000:]))
            outs.append(out)
        return outs

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class RankBranches(Branches):
    """A Branches replaying, in one rank of a world, the pieces that one
    process recorded on the global batch: a record whose first axis is
    `world` times the call's gives the rank's rows (of the batch, or of the
    flattened maps of the OHEM bisection); one of the call's shape (a global
    count's comparison, a scalar) is taken whole."""

    def __init__(self, records, rank, world):
        super().__init__()
        self.records, self.rank, self.world = records, rank, world

    def _next(self, role, name, shape):
        i, records = self.pos[role], self.records[role]
        if i < len(records) and records[i][0] == name:
            rec = records[i][1]
            if (len(shape) == rec.dim() >= 1 and rec.shape[0] == self.world * shape[0]
                    and tuple(rec.shape[1:]) == tuple(shape[1:])):
                self.pos[role] += 1
                return rec[self.rank * shape[0]:(self.rank + 1) * shape[0]]
        return super()._next(role, name, shape)


def tp_config():
    """rec_vgg_bilstm_ctc.yml at full width, its head over the 6,624 classes
    of its character table."""
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools.train import set_head_channels
    from pytorchocr_tpu_torch.utils.config import load_config

    config = load_config(REC_CFG)
    set_head_channels(config, build_post_process(config["PostProcess"], config["Global"]))
    return config


def tp_batch(config):
    """TP_BS seeded lines (1x32x320 in [-1, 1]) with labels of 5-25 classes."""
    import numpy as np

    rng = np.random.RandomState(SEED + 201)
    c = config["Architecture"].get("in_channels", 3)
    images = rng.uniform(-1, 1, (TP_BS, 32, 320, c)).astype(np.float32)
    n_cls = config["Architecture"]["Head"]["out_channels"]
    lengths = rng.randint(5, 26, TP_BS).astype(np.int64)
    labels = np.zeros((TP_BS, 25), np.int64)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.randint(1, n_cls, n)
    return [images, labels, lengths]


def tp_step(config, dev, batch, shard):
    """One float32 CRNN step (TF32 off) from the seeded weights, its CTC
    head split over the model group when `shard`: (losses, gradients,
    state_dict after, parameters before, the split leaves, the LR), on the
    CPU in float64."""
    import torch

    from pytorchocr_tpu_torch.losses import build_loss
    from pytorchocr_tpu_torch.optimizer import build_optimizer
    from pytorchocr_tpu_torch.parallel.shardings import shard_params
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.trainer import batch_to_device, make_train_step

    with float32_on_card():
        model = build_train_model(config, dev)
        split = shard_params(model) if shard else []
        opt, _ = build_optimizer(config["Optimizer"], epochs=1, step_each_epoch=10,
                                 parameters=model.parameters())
        step = make_train_step(model, build_loss(config["Loss"]), opt)
        p0 = {k: v.detach().double().cpu() for k, v in model.named_parameters()}
        losses = {k: float(v) for k, v in step(batch_to_device(batch, dev)).items()}
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    return (losses, grads, {k: v.double().cpu() for k, v in model.state_dict().items()}, p0,
            split, float(opt.lr_schedule(0)))


def digest(tensors):
    """sha256 of a dict of tensors, names and bytes."""
    import hashlib

    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_job_main(job_path, out_path):
    """One of phase 20's two gloo ranks on the job's device (the card):
    (a) the DB step on its rows, replaying the 1-rank step's pieces, then
    (d) the CRNN step with the CTC head split over the same two ranks
    (model_parallel 2). Rank 0 saves its steps whole (in float32, as they
    were computed), rank 1 their digests and its shard of the head."""
    import torch

    from pytorchocr_tpu_torch.parallel import mesh

    job = torch.load(job_path, weights_only=False)
    dev = torch.device(job["device"])
    grid = mesh.setup("gloo", dev)
    db = job["db"]
    n = len(db["batch"][0]) // grid.data_world
    rows = [b[grid.data_rank * n:(grid.data_rank + 1) * n] for b in db["batch"]]
    branches = RankBranches(db["records"], grid.data_rank, grid.data_world)
    losses, grads, state, p0 = card_step(db["config"], dev, rows, tf32=False,
                                         schedule=db["schedule"], branches=branches,
                                         replay=True, loss_pieces=True)
    out = dict(rank=grid.rank, flips=branches.report(), db_losses=losses,
               db_state_digest=digest(state))
    if grid.rank == 0:
        out["db"] = tuple({k: v.float() for k, v in d.items()} for d in (grads, state, p0))
    grid = mesh.create_mesh(model_parallel=2)
    tp = job["tp"]
    losses, grads, state, p0, split, lr = tp_step(tp["config"], dev, tp["batch"], shard=True)
    out.update(tp_losses=losses, tp_split=split, tp_model_rank=grid.model_rank,
               tp_replicated_digest=digest({k: v for k, v in state.items() if k not in split}),
               tp_shards=tuple({k: d[k].float() for k in split} for d in (grads, state, p0)))
    if grid.rank == 0:
        out["tp"] = tuple({k: v.float() for k, v in d.items()} for d in (grads, state, p0))
    torch.save(out, "%s.rank%d.pt" % (out_path, grid.rank))
    mesh.teardown()


def traced_train(argv, deterministic, started=None):
    """tools.train.run(argv), every K1 call of its evaluate recorded and
    held to the plain version, cuDNN deterministic if asked: its report,
    the K1 launches and shapes, the digest of its final parameters and its
    place in the world. `started` names a file made when the evaluate
    begins (the train iterations are over)."""
    import torch

    from pytorchocr_tpu_torch.parallel import mesh
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools import train as train_cli

    kept = {}
    saved = (program.train, program.evaluate, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)

    def train(config, device, train_loader, valid_loader, model, *args, **kwargs):
        kept["model"] = model
        return saved[0](config, device, train_loader, valid_loader, model, *args, **kwargs)

    def evaluate(*args, **kwargs):
        if started is not None:
            open(started, "w").close()
        return saved[1](*args, **kwargs)

    program.train, program.evaluate = train, evaluate
    if deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        with recorded_kernels() as rec:
            report = train_cli.run(argv)
        run_s = time.perf_counter() - t0
    finally:
        (program.train, program.evaluate, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    shapes = rec.hold("dp-train-eval")
    grid = mesh.get_mesh()
    return dict(report=report, k1=rec.k1_launches, shapes=shapes,
                digest=digest(kept["model"].state_dict()), run_s=run_s,
                rank=grid.rank if grid else 0, world=grid.world if grid else 1,
                backend=grid.backend if grid else None)


def train_rank_main(out_path, argv, deterministic):
    """traced_train in one process of a torchrun world, written to
    `out_path`.rank<r>.json (`out_path`.evaluating made when rank 0's
    evaluate begins)."""
    from pytorchocr_tpu_torch.parallel import mesh

    out = traced_train(argv, deterministic, started=out_path + ".evaluating")
    with open("%s.rank%d.json" % (out_path, out["rank"]), "w") as f:
        json.dump(out, f, default=float)
    mesh.teardown()


def read_ranks(out_path, n, ext="json"):
    import torch

    paths = ["%s.rank%d.%s" % (out_path, r, ext) for r in range(n)]
    check(all(os.path.exists(p) for p in paths), "%s: %d rank outputs, not %d"
          % (out_path, sum(os.path.exists(p) for p in paths), n))
    if ext == "json":
        return [json.load(open(p)) for p in paths]
    return [torch.load(p, weights_only=False) for p in paths]


def dp_start_ranks(config, dev, tmp, train_label, stack):
    """Phase 20 (a) and (d): the 1-rank DB step recording its pieces, its
    float64 reference submitted, the 2 ranks started (in `stack`, an
    ExitStack) with both jobs, then the 1-rank CRNN step here. Returns what
    dp_ranks_held reads."""
    import torch

    schedule = (TRAIN_STEPS // (TRAIN_PAGES // TRAIN_BS), TRAIN_PAGES // TRAIN_BS)
    batch = first_batches(config, 1, DP_F32_BS, train_label)[0]
    branches = Branches()
    one = card_step(config, dev, batch, tf32=False, schedule=schedule, branches=branches,
                    loss_pieces=True)
    records = {role: [(kind, t.cpu()) for kind, t in recs]
               for role, recs in branches.records.items()}
    job = cpu_job(f64_steps, config, batch, schedule, None, records, True, None)
    tp_cfg = tp_config()
    tp_in = tp_batch(tp_cfg)
    path = os.path.join(tmp, "dp_ranks")
    torch.save(dict(device=str(dev), tp=dict(config=tp_cfg, batch=tp_in),
                    db=dict(config=config, batch=batch, records=records, schedule=schedule)),
               path + ".job")
    procs = stack.enter_context(ranks("dp-ranks", ["--rank-job", path + ".job", path], world=2))
    return dict(procs=procs, path=path, one=one, job=job, tp_one=tp_step(tp_cfg, dev, tp_in,
                                                                         shard=False),
                n_cls=tp_cfg["Architecture"]["Head"]["out_channels"])


def dp_ranks_held(started, card):
    """Phase 20 (a) and (d)'s checks on the ranks' outputs; returns (a)'s
    float64 check, held back to the end of the run."""
    import torch

    started["procs"].wait()
    got = read_ranks(started["path"], 2, "pt")
    check(got[0]["db_losses"] == got[1]["db_losses"]
          and got[0]["db_state_digest"] == got[1]["db_state_digest"],
          "dp-f32: the ranks' losses or parameters after the update differ: %s, %s"
          % (got[0]["db_losses"], got[1]["db_losses"]))
    say("dp-f32", "2 ranks over gloo on one card, one float32 step each on %d of %d pages, "
        "bit-identical parameters after the update (not NCCL) on %s"
        % (DP_F32_BS // 2, DP_F32_BS, card))
    dp_tp_held(got, started["tp_one"], started["n_cls"])
    two = (got[0]["db_losses"],) + tuple({k: v.double() for k, v in d.items()}
                                         for d in got[0]["db"])
    one, job, flips = started["one"], started["job"], got[0]["flips"]

    def held():
        steps = job.result()
        ref = steps["l_ref"], steps["g_ref"], steps["ref_sd"]
        skip = db_zero_grad_leaves(steps["g_ref"])
        lines = []
        for what, step in (("2 ranks", two), ("1 rank", one)):
            r = held_step(step, ref, steps["floor"], steps["lr"], skip)
            loss = max(abs(step[0][k] - v) / abs(v) for k, v in steps["l_ref"].items())
            check(loss <= 1e-4, "dp-f32 (%s): loss off by %.3g relative" % (what, loss))
            check(r["grad"][0] <= GRAD_LIMIT, "dp-f32 (%s): gradient %s off by %.3g relative L2"
                  % (what, r["grad"][1], r["grad"][0]))
            check(r["elem"][0] <= 1.0, "dp-f32 (%s): gradient %s off by %.3g of its leaf's CPU "
                  "float32 worst error" % (what, r["elem"][1], r["elem"][0]))
            check(r["outside"] == 0, "dp-f32 (%s): %d parameters past their bound; the first: "
                  "%s" % (what, r["outside"], r["first"]))
            check(r["bn"] <= 1e-3, "dp-f32 (%s): BN running statistics off by %.3g"
                  % (what, r["bn"]))
            lines.append("%s: loss %.6f (%.2e relative), gradients worst %.2e relative L2 (%s), "
                         "elementwise %.3g of the floor (%s), BN statistics %.2e" % (
                             what, step[0]["loss"], loss, r["grad"][0], r["grad"][1],
                             r["elem"][0], r["elem"][1], r["bn"]))
        apart = max((float((two[1][k] - one[1][k]).abs().max()) / steps["floor"][k], k)
                    for k in two[1] if k not in skip)
        say("dp-f32", "float32 DB-ResNet18 step (TF32 off, global batch %d at %dx%d, gloo, "
            "2 ranks on one card) against the float64 step within phase 11's floors (the CPU "
            "float32 step's worst error in each leaf), the ranks replaying the 1-rank step's "
            "pieces by rows (elements on another piece: %s): %s; the 2-rank gradients at most "
            "%.3g of a floor from the 1-rank ones (%s)"
            % (DP_F32_BS, TRAIN_SIZE, TRAIN_SIZE, flips, "; ".join(lines), *apart))

    return held


def dp_tp_held(got, one, n_cls):
    """Phase 20 (d): the split CRNN step of the two ranks (`got`) against
    the 1-rank step `one` on phase 12's floor form."""
    import torch

    got = sorted(got, key=lambda r: r["tp_model_rank"])
    split = got[0]["tp_split"]
    check(split == ["head.fc.weight", "head.fc.bias"]
          and got[0]["tp"][1]["head.fc.weight"].shape[0] * 2 == n_cls,
          "dp-tp: the CTC head is not split in half: %s" % split)
    check(got[0]["tp_replicated_digest"] == got[1]["tp_replicated_digest"]
          and got[0]["tp_losses"] == got[1]["tp_losses"],
          "dp-tp: the model ranks' replicated leaves or losses differ")

    def whole(i):
        return {k: torch.cat([r["tp_shards"][i][k] for r in got]) if k in split else v
                for k, v in got[0]["tp"][i].items()}

    tp = (got[0]["tp_losses"],) + tuple({k: v.double() for k, v in whole(i).items()}
                                        for i in range(3))
    l1, g1, sd1, _, _, lr = one
    skip = bn_fed_biases(g1)  # conv biases that feed a train-mode BN: 0 up to rounding
    for k in skip:
        scale = 1e-4 * float(g1[k[:-4] + "weight"].norm())
        check(float(tp[1][k].norm()) < scale, "dp-tp: %s has a gradient" % k)
    g1 = {k: g for k, g in g1.items() if k not in skip}
    floor = {k: ELEM_SCALE * float(g.abs().max()) for k, g in g1.items()}
    r = held_step(tp, (l1, g1, sd1), floor, lr)
    loss = abs(tp[0]["loss"] - l1["loss"]) / abs(l1["loss"])
    check(loss <= 1e-4, "dp-tp: loss %.7g against %.7g on 1 rank" % (tp[0]["loss"], l1["loss"]))
    check(r["grad"][0] <= GRAD_LIMIT and r["elem"][0] <= 1.0 and r["outside"] == 0,
          "dp-tp: gradient %s off by %.3g relative L2, %s at %.3g of its floor, %d parameters "
          "past their bound" % (r["grad"][1], r["grad"][0], r["elem"][1], r["elem"][0],
                                r["outside"]))
    say("dp-tp", "float32 CRNN step of rec_vgg_bilstm_ctc.yml (VGG v1, BiLSTM 256, CTC over %d "
        "classes, bs %d at 32x320, TF32 off) on 2 ranks with model_parallel 2 (gloo, one card: "
        "each rank holds %d of the head's columns, the logits gathered by a zero-padded "
        "all-reduce) against 1 rank: loss %.6f against %.6f (%.2e relative), gradients worst "
        "%.2e relative L2 (%s), elementwise %.3g of phase 12's floor (%g of a leaf's largest "
        "|g|; %s), %d parameters past their bound, the replicated leaves bit-identical on both "
        "ranks" % (n_cls, TP_BS, n_cls // 2, tp[0]["loss"], l1["loss"], loss, r["grad"][0],
                   r["grad"][1], r["elem"][0], ELEM_SCALE, r["elem"][1], r["outside"]))


def dp_train_start(tmp, train_label, eval_label, stack):
    """Phase 20 (b): torchrun started (in `stack`). Returns its arguments
    and paths."""
    epochs = DP_STEPS // (TRAIN_PAGES // (2 * DP_BS))
    out = os.path.join(tmp, "dp_out")
    argv = train_argv(out, train_label, eval_label, epochs) + [
        "Train.loader.batch_size_per_card=%d" % DP_BS, "Global.dist_backend=gloo",
        "Global.ranks_per_card=2"]
    path = os.path.join(tmp, "dp_train")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2"]
    procs = stack.enter_context(ranks("dp-train", ["--train-rank", path] + argv, cmd=torchrun))
    return dict(procs=procs, out=out, argv=argv, path=path, t0=time.perf_counter())


def dp_train_held(started, card):
    """Phase 20 (b)'s checks and report. Returns the K1 launches of its
    evaluate."""
    import numpy as np

    started["procs"].wait(timeout=900)
    took = time.perf_counter() - started["t0"]
    out, argv = started["out"], started["argv"]
    got = read_ranks(started["path"], 2)
    check([g["world"] for g in got] == [2, 2] and got[0]["backend"] == "gloo",
          "dp-train: not a gloo world of 2: %s" % [(g["world"], g["backend"]) for g in got])
    check(got[0]["digest"] == got[1]["digest"], "dp-train: the ranks' final parameters differ")
    rep = [g["report"] for g in got]
    losses = rep[0]["losses"]
    check(rep[0]["steps"] == DP_STEPS and losses == rep[1]["losses"],
          "dp-train: %d steps, or the ranks' losses differ" % rep[0]["steps"])
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < 0.7 * first, "dp-train: the loss fell from %.4f to %.4f only" % (first, last))
    k1 = got[0]["k1"]
    check(k1 > 0 and got[1]["k1"] == 0, "dp-train: K1 launches %d on rank 0, %d on rank 1 "
          "(rank 0 alone evaluates)" % (k1, got[1]["k1"]))
    log = open(os.path.join(out, "train.log")).read()
    check(log.count("train with torch") == 1 and "rank 0 of 2 (gloo)" in log,
          "dp-train: train.log is not rank 0's alone")
    for prefix in ("latest", "best_accuracy"):
        check(os.path.isfile(os.path.join(out, prefix, "state.pt")),
              "dp-train: rank 0 wrote no %s" % prefix)
    best = rep[0]["best"]
    metric = eval_run(argv + ["Global.checkpoints=%s" % os.path.join(out, "best_accuracy")])
    check(all(metric[k] == best[k] for k in ("hmean", "precision", "recall")),
          "dp-train: tools.eval.run on rank 0's best_accuracy gives hmean %.4f, the run %.4f"
          % (metric["hmean"], best["hmean"]))
    wall = max(r["wall_s"] for r in rep)
    say("dp-train", "torchrun --nproc_per_node 2, gloo, both ranks on one card (Global."
        "ranks_per_card 2): %d bf16 steps of bs %d a rank (global %d) at %dx%d; mean loss of "
        "the first 10 steps %.4f, of the last 10 %.4f; %s; %.3f steps/s and %.1f global "
        "samples/s over the train iterations (%.1f s of %.1f s with the start, which ran "
        "beside (a), (c) and (d), and the evaluate; all of it beside phase 19's card work in "
        "the run's main process; gloo reduces through the host: not NCCL, "
        "not the card's data-parallel rate) on %s"
        % (DP_STEPS, DP_BS, 2 * DP_BS, TRAIN_SIZE, TRAIN_SIZE, first, last, "; ".join(
            "rank %d: %.3f steps/s, %.1f samples/s, loader wait %.1f%%" % (
                g["rank"], r["steps"] / r["wall_s"], r["samples"] / r["wall_s"],
                100.0 * r["reader_s"] / r["wall_s"]) for g, r in zip(got, rep)),
           rep[0]["steps"] / wall, sum(r["samples"] for r in rep) / wall, wall, took, card))
    say("dp-train", "rank 0's evaluate after the last epoch: runmax.launches %d, each launch's "
        "output == the plain version on its inputs (%s), hmean %.4f; rank 1 launched none and "
        "took the broadcast metric; rank 0 alone wrote train.log, latest and best_accuracy; "
        "tools.eval.run in one process on best_accuracy: hmean %.4f"
        % (k1, got[0]["shapes"], best["hmean"], metric["hmean"]))
    return k1


def dp_nccl(tmp, train_label, eval_label, stack):
    """Phase 20 (c): the NCCL world-1 run and the plain process started (in
    `stack`; the plain run in a process of its own, as the driver runs it:
    this process's state, its allocator's addresses too, may move cuBLAS's
    choices). Returns the function that waits and checks."""
    pages = os.path.join(tmp, "nccl_pages.txt")  # one epoch of NCCL_STEPS steps
    with open(train_label) as f, open(pages, "w") as g:
        g.writelines(f.readlines()[:NCCL_STEPS * NCCL_BS])
    argv = {name: train_argv(os.path.join(tmp, "nccl_" + name), pages, eval_label, 1) + [
        "Train.loader.batch_size_per_card=%d" % NCCL_BS, "Train.loader.num_workers=1",
        "Global.eval_epoch_step=[100,1]"] for name in ("nccl", "plain")}
    path = os.path.join(tmp, "nccl")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    nccl = stack.enter_context(ranks("dp-nccl", ["--train-rank", path, "--deterministic"]
                                     + argv["nccl"], cmd=torchrun))
    plain = stack.enter_context(ranks("dp-plain", ["--train-rank", path + "_plain",
                                                   "--deterministic"] + argv["plain"],
                                      cmd=[sys.executable]))
    return lambda: dp_nccl_held(nccl, plain, path)


def dp_nccl_held(nccl, plain, path):
    nccl.wait()
    plain.wait()
    got, plain = read_ranks(path, 1)[0], read_ranks(path + "_plain", 1)[0]
    check(got["backend"] == "nccl" and got["world"] == 1 and plain["backend"] is None,
          "dp-nccl: %s / %s" % ((got["backend"], got["world"]), plain["backend"]))
    losses = got["report"]["losses"]
    check(len(losses) == NCCL_STEPS and losses == plain["report"]["losses"]
          and got["digest"] == plain["digest"],
          "dp-nccl: the NCCL world-1 run and the plain process differ: losses %s / %s"
          % (losses, plain["report"]["losses"]))
    say("dp-nccl", "torchrun --nproc_per_node 1 on NCCL (the gradients through its all-reduce) "
        "and the plain process, %d bf16 steps of bs %d, cuDNN deterministic, one loader "
        "thread: losses %s on both, final parameters bit for bit equal (sha256 %s...); "
        "tools.train.run %.1f s and %.1f s in the two"
        % (NCCL_STEPS, NCCL_BS, ", ".join("%.6f" % v for v in losses), got["digest"][:16],
           got["run_s"], plain["run_s"]))


def phase_dp_start(dev, card, tmp, train_label, eval_label, stack):
    """Phase 20, its start: training across ranks. Its parts start at once
    ((b)'s torchrun first, then (c)'s two processes, then (a)'s 1-rank
    step, the (a) + (d) pair of ranks and (d)'s 1-rank step), each a
    process of its own in `stack` (an ExitStack that stops them): each
    process takes seconds to reach the card, and only (b) times anything,
    its train iterations, which begin after the others' steps are mostly
    done. This process is free meanwhile: run_phases runs phase 19 beside
    them (and the niced CPU reference process runs beside both, stopped
    only in phase 19's timed sections). Returns what phase_dp_end reads."""
    from pytorchocr_tpu_torch.tools import program

    global DP_LIVE
    t0 = time.perf_counter()
    DP_LIVE = True
    config = program.preprocess(is_train=True, argv=train_argv(
        os.path.join(tmp, "dp_f32_out"), train_label, eval_label, 2))[0]
    b = dp_train_start(tmp, train_label, eval_label, stack)
    finish_c = dp_nccl(tmp, train_label, eval_label, stack)
    ad = dp_start_ranks(config, dev, tmp, train_label, stack)
    return dict(t0=t0, b=b, finish_c=finish_c, ad=ad, parts={
        "all started": time.perf_counter() - t0})


def phase_dp_end(started, card, stack):
    """Phase 20, its end: (c), then (a) and (d), then (b) checked; `stack`
    closed (its processes stopped). Returns K1's launches on the
    DP-train-eval path."""
    global DP_LIVE
    t0, parts = started["t0"], started["parts"]

    def mark(name):
        parts[name] = time.perf_counter() - t0

    mark("phase 19 done")
    with stack:
        started["finish_c"]()
        mark("c done")
        held = dp_ranks_held(started["ad"], card)
        mark("a, d done")
        k1 = dp_train_held(started["b"], card)
        mark("b done")
    DP_LIVE = False
    later(held)
    say("dp", "phase 20 took %.1f s with phase 19 beside it: %s (seconds from its start)" % (
        time.perf_counter() - t0, ", ".join("%s %.1f" % kv for kv in parts.items())))
    return k1


# phase 21: the serving side finished with the port. (a) int8 PTQ on the
# zoo's detectors (ZOO_INT8: tag, the phase 16 reference whose seeded model
# it takes), through Deter(quant=True) and OCRer(det_quant=True) with phase
# 5's CRNN; (b) the export of phase 11's DB-ResNet18 to a .pt2 file; (c) the
# result images of run_ocr and the Runner's split over replicas
ZOO_INT8 = (("MBv3-small", "MBv3-small DB"), ("MBv3-large-0.5", "MBv3-large-0.5 DB"),
            ("SFv2", "SFv2 DB"), ("RepVGG-A0", "RepVGG DB"), ("RepVGG-A0 deploy", "RepVGG DB"),
            ("DB++", "dbpp"))
# (a)'s bound on the int8 payloads of the card's float32 int8 run against
# the CPU's on the same scales. An element within rounding of a quantization
# boundary quantizes a quantum apart, and each later conv carries it on and
# widens it (measured on an H100: DB++'s stem 12 of 30.1 M elements, one
# quantum, as phase 8 holds it; its head conv1 27.0% by up to 52 quanta;
# PERF.md §6). The witness of that spread is the CPU's own int8 run with
# the float path moved by rounding alone (nudged_payloads): every
# calibrated absmax ZOO_INT8_WITNESS_ULPS * 2^-23 relative up (4 to 8
# float32 ulps: the card's fused epilogues round a few ulps apart from the
# CPU's; one ulp flips 1.1-2.6x fewer early elements than the card does,
# 4-8 within 0.8-1.3x, PERF.md §6), and a backbone with no
# int8 conv (RepVGG's deploy form) run in float64. Per payload, the card's
# share of elements apart is held to ZOO_INT8_WITNESS_X times the witness's
# (at least ZOO_INT8_MIN_SHARE), and its largest difference to
# ZOO_INT8_WITNESS_X times the witness's (at least one quantum). The
# control, every absmax moved by ZOO_INT8_CONTROL relative (a float path
# 1e-3 off), must break that bound on some payload.
ZOO_INT8_WITNESS_ULPS, ZOO_INT8_WITNESS_X, ZOO_INT8_MIN_SHARE = 4, 2.0, 1e-4
ZOO_INT8_CONTROL = 2.0 ** -10
# (b): the exported program's maps against the Runner's forward, max |diff|
# over max |map|: float32 (TF32 off), and bf16 (autocast in both; PERF.md)
EXPORT_F32_TOL, EXPORT_BF16_TOL = 1e-5, 2e-2


def ref_int8_det(det_cfg, det_pt, pages, fold=None):
    """The CPU's int8 run (the plain kernels) of Deter(quant=True).run_batch
    on `pages`, calibrated on their first half (as run_batch would) as on
    the card, that phase 21 (a) holds the card's float32 int8 run to: its
    boxes, det_reference, AbsMax state and int8 payloads. With `fold`
    (repvgg_fold's), the RepVGG deploy form."""
    import cv2

    from pytorchocr_tpu_torch.deploy.infer_det import Deter

    if fold is not None:
        det_pt, det_cfg = fold[0], fold[1]
    t0 = time.perf_counter()
    deter = Deter(det_cfg, det_pt, device="cpu", quant=True)
    deter.calibrate_on([cv2.imread(p) for p in pages[: max(1, len(pages) // 2)]])
    with int8_payloads(deter.runner.model) as payloads:  # run_batch's one int8 forward
        cpu = box_lists(deter.run_batch([cv2.imread(p) for p in pages]))
    out = dict(cpu=cpu, cpu_s=time.perf_counter() - t0, det=det_reference(deter, pages),
               absmax=_absmax_state(deter.runner.model), payloads=payloads, det_cfg=det_cfg,
               det_pt=det_pt)
    out["nudged"] = nudged_payloads(deter, pages, out["absmax"], payloads)
    return out


def payloads_apart(want, got):
    """{payload name: (elements apart, elements, apart by one quantum,
    largest difference in quanta)} of two int8_payloads readings."""
    out = {}
    for name in got:
        d = (got[name] - want[name]).abs()
        out[name] = (int((d > 0).sum()), d.numel(), int((d == 1).sum()), int(d.max()))
    return out


@contextlib.contextmanager
def float64_backbone(model):
    """Inside the block `model`'s backbone runs in float64 (its input cast
    up, its maps cast back to float32) if it holds no int8 conv; else as it
    is. Yields whether it does."""
    from pytorchocr_tpu_torch.ops.quant import QuantConv

    bb = model.backbone
    if any(isinstance(m, QuantConv) for m in bb.modules()):
        yield False
        return

    def down(mod, inp, out):
        return [o.float() for o in out] if isinstance(out, (list, tuple)) else out.float()

    bb.double()
    hooks = [bb.register_forward_pre_hook(lambda mod, inp: tuple(x.double() for x in inp)),
             bb.register_forward_hook(down)]
    try:
        yield True
    finally:
        for h in hooks:
            h.remove()
        bb.float()


def nudged_payloads(deter, pages, absmax, payloads):
    """Phase 21 (a)'s witness and control on the CPU: payloads_apart of
    `deter`'s int8 forward over `pages` against `payloads`, the forward on
    `absmax` itself, with every calibrated absmax ZOO_INT8_WITNESS_ULPS *
    2^-23 relative up (as many float32 ulps to twice that) and a float
    backbone in float64 ("witness";
    float64_backbone), and with every absmax ZOO_INT8_CONTROL relative up
    ("control")."""
    from pytorchocr_tpu_torch.utils.weights import load_absmax

    model, out = deter.runner.model, {}
    up = 1.0 + ZOO_INT8_WITNESS_ULPS * 2.0 ** -23
    load_absmax(model, {k: v * up for k, v in absmax.items()})
    with float64_backbone(model) as out["float64 backbone"]:
        out["witness"] = payloads_apart(payloads, _int8_payloads(deter, pages))
    load_absmax(model, {k: v * (1.0 + ZOO_INT8_CONTROL) for k, v in absmax.items()})
    out["control"] = payloads_apart(payloads, _int8_payloads(deter, pages))
    load_absmax(model, absmax)
    return out


class recorded_int8:
    """Inside the block the int8 conv's and the requantize kernel's counts
    (and the conv's by branch) are set to 0 on entry and read on exit, and
    every int8 conv call (int8_conv.int8_conv) and every requantize call
    (requant.quantize, dequant, add_act_quantize) is recorded with its
    output; `hold(tag)` then holds each output to the plain version exactly
    and returns the grouped convs' arguments and the calls by kind."""

    def __enter__(self):
        import torch

        from pytorchocr_tpu_torch.ops import int8_conv, requant

        self.convs, self.rq = [], []
        self.originals = {name: getattr(requant, name) for name in REQUANT_FNS}
        self.conv = int8_conv.int8_conv

        def conv(*args, out_dtype=torch.float32):
            y = self.conv(*args, out_dtype=out_dtype)
            self.convs.append((args, out_dtype, y.clone()))
            return y

        def recorder(name):
            def call(*args):
                out = self.originals[name](*args)
                self.rq.append((name, args, out.clone()))
                return out
            return call

        int8_conv.launches = requant.launches = 0
        int8_conv.branch_launches = dict.fromkeys(int8_conv.branch_launches, 0)
        torch.cuda.synchronize()
        int8_conv.int8_conv = conv
        for name in REQUANT_FNS:
            setattr(requant, name, recorder(name))
        return self

    def __exit__(self, *exc):
        import torch

        from pytorchocr_tpu_torch.ops import int8_conv, requant

        torch.cuda.synchronize()
        int8_conv.int8_conv = self.conv
        for name in REQUANT_FNS:
            setattr(requant, name, self.originals[name])
        self.conv_launches, self.rq_launches = int8_conv.launches, requant.launches
        self.branches = dict(int8_conv.branch_launches)

    def hold(self, tag):
        import torch

        from pytorchocr_tpu_torch.ops import int8_conv

        check(len(self.convs) == self.conv_launches and len(self.rq) == self.rq_launches,
              "%s: %d int8 conv and %d requantize calls recorded for %d and %d launches"
              % (tag, len(self.convs), len(self.rq), self.conv_launches, self.rq_launches))
        for args, od, y in self.convs:
            check(torch.equal(y, int8_conv.int8_conv_ref(*args, out_dtype=od)),
                  "%s: int8_conv (%s) differs from the plain version at %s"
                  % (tag, od, _conv_key(args)))
        for name, args, out in self.rq:
            check(torch.equal(out, _requant_ref(name)(*args)), "%s: requant.%s differs from the "
                  "plain version at %s" % (tag, name, _requant_key(name, args)))
        grouped = [args for args, _, _ in self.convs if args[7] != 1]
        kinds = ", ".join("%s %d" % (n, sum(c[0] == n for c in self.rq)) for n in REQUANT_FNS)
        self.convs = self.rq = None
        return grouped, kinds


def zoo_int8_path(dev, card, tag, det_cfg, det_pt, margin, moved, ocr, pages, ref):
    """Phase 21 (a) for one detector: its float32 int8 run on the card
    against the CPU's (`ref`, ref_int8_det's) on the first ZOO_CPU_PAGES
    pages in phase 8's form (the card's own calibration against the CPU's,
    then the CPU's scales: the int8 payloads, the boxes); then the bf16
    main path on all pages: OCRer(det_quant=True).run_many with phase 5's
    CRNN (`ocr`, its Deter(quant=True) replaced by this model's), whose one
    int8 forward (after its calibration) has every int8 conv, requantize
    and K1 launch held to the plain version; pages/s and the det forward
    against the float one. Returns the main path's launches and the
    grouped convs' arguments."""
    import statistics

    import cv2
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.utils.weights import load_absmax

    few = pages[:ZOO_CPU_PAGES]
    imgs = [cv2.imread(p) for p in pages]
    cpu = ref["cpu"]
    check(sum(len(p) for p in cpu) > 0, "%s-int8: no text boxes on the CPU" % tag)
    with float32_on_card():
        deter32 = Deter(det_cfg, det_pt, device=dev, dtype=torch.float32, quant=True)
        deter32.calibrate_on(imgs[: max(1, len(few) // 2)])  # its own, on the first half
        own, want = _absmax_state(deter32.runner.model), ref["absmax"]
        check(sorted(own) == sorted(want), "%s-int8: card and CPU calibrated different modules"
              % tag)
        rel = max(float((own[k] - want[k]).abs() / want[k].abs().clamp_min(1e-12)) for k in own)
        load_absmax(deter32.runner.model, want)  # the CPU's scales from here on
        with int8_payloads(deter32.runner.model) as got:
            f32 = box_lists(deter32.run_batch(imgs[: len(few)]))
        check(got and list(got) == list(ref["payloads"]), "%s-int8: int8 payloads %s on the "
              "card, %s on the CPU" % (tag, list(got), list(ref["payloads"])))
        apart = payloads_apart(ref["payloads"], got)
        witness, control = ref["nudged"]["witness"], ref["nudged"]["control"]

        def reading(r):
            return "%d of %d (%.4f%%, %d by one, at most %d)" % (r[0], r[1], 100.0 * r[0] / r[1],
                                                                 r[2], r[3])

        report, broken, past = [], [], []
        for name, r in apart.items():
            share_max = max(ZOO_INT8_WITNESS_X * witness[name][0] / r[1], ZOO_INT8_MIN_SHARE)
            quanta_max = max(ZOO_INT8_WITNESS_X * witness[name][3], 1)
            report.append("%s: card %s; witness %s; control %s; bound %.4f%%, %d quanta"
                          % (name, reading(r), reading(witness[name]), reading(control[name]),
                             100.0 * share_max, quanta_max))
            if r[0] / r[1] > share_max or r[3] > quanta_max:
                past.append(name)
            if control[name][0] / r[1] > share_max or control[name][3] > quanta_max:
                broken.append(name)
        say(tag + "-int8-f32", "int8 payloads against the CPU's on its scales (the witness: the "
            "CPU's run with every absmax %d * 2^-23 relative up%s; the control: %g relative "
            "up): %s"
            % (ZOO_INT8_WITNESS_ULPS, " and the float backbone in float64"
               if ref["nudged"]["float64 backbone"] else "", ZOO_INT8_CONTROL,
               "; ".join(report)))
        check(not past, "%s-int8: the card's int8 payloads %s lie past the bound the witness "
              "sets" % (tag, past))
        check(broken, "%s-int8: the control (absmax %g relative up) passes the bound on every "
              "payload" % (tag, ZOO_INT8_CONTROL))
        if "backbone.stem" in apart:  # the first int8 payload, as phase 8 holds it
            check(apart["backbone.stem"][3] <= 1, "%s-int8: the stem's int8 output differs from "
                  "the CPU's by %d quanta" % (tag, apart["backbone.stem"][3]))
        compare_boxes(ref["det"], deter32, few, cpu, f32, margin, tag=tag + "-int8-f32",
                      moved=moved)
    del deter32
    say(tag + "-int8-f32", "float32 int8 (TF32 off) on %s against the CPU's int8 run (plain "
        "kernels, %.1f s) on %d pages: %d absmax, the card's own calibration at most %.3g "
        "relative from the CPU's; with the CPU's scales, the control breaks the bound on %s"
        % (card, ref["cpu_s"], len(few), len(own), rel, ", ".join(broken)))

    ocr.deter = Deter(det_cfg, det_pt, device=dev, quant=True)  # bf16; run_many calibrates
    with recorded_kernels() as rec, recorded_int8() as q8:
        lines = sum(len(p) for p in ocr.run_many(pages))  # through ocr.deter.run_batch
    k1_shapes = rec.hold(tag + "-int8")
    grouped, kinds = q8.hold(tag + "-int8")
    launches = dict(int8_conv=q8.conv_launches, requant=q8.rq_launches, K1=rec.k1_launches,
                    **{"int8_conv " + b: n for b, n in q8.branches.items()})
    check(min(launches[k] for k in ("int8_conv", "requant", "K1")) > 0 and lines > 0,
          "%s-int8: the main path launched %s and found %d lines" % (tag, launches, lines))
    secs, _ = timed_runs(lambda: ocr.run_many(pages), 1)
    # the det forward, int8 against float (the same runner out of int8), both bf16, on one
    # batch: synced calls, alternating, the first round a warm-up
    runner = ocr.deter.runner
    batch = _det_batch(ocr.deter, pages)[0]
    walls = {True: [], False: []}
    for i in range(4):
        for q in (True, False) if i % 2 else (False, True):
            runner.quant = q
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner(batch)
            torch.cuda.synchronize()
            if i:
                walls[q].append((time.perf_counter() - t0) * 1e3)
    runner.quant = True
    say(tag + "-int8-bf16", "main path (OCRer(det_quant=True).run_many with phase 5's CRNN, its "
        "Deter(quant=True).run_batch calibrated on the first half of the %d pages): "
        "int8_conv.launches %d (wgmma %d, depthwise %d, direct %d), requant.launches %d, "
        "runmax.launches %d, "
        "each == the plain version on its inputs (requant: %s; K1: %s); %d lines; %.3f pages/s, "
        "%.1f lines/s (%d pages of %dx%d, one timed run); det forward median of 3 synced calls: "
        "int8 %.2f ms, float %.2f ms; on %s"
        % (PAGES, launches["int8_conv"], launches["int8_conv wgmma"],
           launches["int8_conv depthwise"], launches["int8_conv direct"], launches["requant"],
           launches["K1"], kinds, k1_shapes,
           lines, PAGES / secs, lines / secs, PAGES, H, W,
           statistics.median(walls[True]), statistics.median(walls[False]), card))
    return launches, grouped


def grouped_conv_report(tag, grouped, card):
    """Phase 21 (a): each distinct grouped (depthwise) int8 conv shape of a
    model's bf16 forward, on the branch the kernel routes it to (int8_dwconv
    for every one of the zoo's): device time (back to back in one CUDA
    graph, L2 cold), wrapper and plain time, the bound; the library
    yardstick, cuDNN's float32 grouped F.conv2d on the int8 values cast to
    float32, channels_last, timed as the kernel is; it is exact (products
    below 2^14, at most 25 taps, sums below 2^19: exact in float32 and in
    TF32's inputs), and its sums rounded to int32 are held equal to the
    plain version's; cuDNN's bf16 conv of the same shape, timed alike, for
    context. Returns the sums over the forward's grouped calls."""
    import torch
    import torch.nn.functional as F

    from pytorchocr_tpu_torch.ops import int8_conv

    shapes = {}
    for args in grouped:
        shapes.setdefault(_conv_key(args), []).append(args)
    keys = ("device_ms", "wrapper_ms", "plain_ms", "bound_ms", "by_ops", "by_bytes", "library_ms",
            "cudnn_ms")
    total = dict.fromkeys(keys, 0.0)
    rows, branches = [], {}
    for key, group in shapes.items():
        xq, wq, scale, bias, stride, padding, dilation, groups = group[0]
        c = len(group)
        cout, kh, kw, _ = wq.shape
        branch = int8_conv.branch(xq.shape[1], cout, kh, kw, *stride, *dilation, groups)
        branches[branch] = branches.get(branch, 0) + c
        y = int8_conv.int8_conv(*group[0], out_dtype=torch.bfloat16)
        dev_ms = stream_ms(lambda x_, y_: int8_conv.launch(
            x_, wq, scale, bias, y_, stride, padding, dilation, groups), [xq, y])
        wrap_ms = cuda_ms(lambda: int8_conv.int8_conv(*group[0], out_dtype=torch.bfloat16),
                          iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: int8_conv.int8_conv_ref(*group[0], out_dtype=torch.bfloat16),
                           iters=2, warmup=1)
        bound, by, _, _, by_ops, by_bytes = conv_bound(xq, wq, bias, y, groups)
        xf = xq.float().contiguous(memory_format=torch.channels_last)
        wf = wq.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
        sums = F.conv2d(xf, wf, None, stride, padding, dilation, groups)
        ones = torch.ones_like(scale)
        check(torch.equal(sums.round().int(), int8_conv.int8_conv_ref(
            xq, wq, ones, None, stride, padding, dilation, groups).int()),
            "%s-int8-dw: cuDNN's float32 grouped conv's sums differ from the plain version's at "
            "%s" % (tag, key))
        lib = stream_ms(lambda x_: F.conv2d(x_, wf, None, stride, padding, dilation, groups), [xf])
        wb, xb = wf.to(torch.bfloat16), xf.to(torch.bfloat16)
        cudnn = stream_ms(lambda x_: F.conv2d(x_, wb, None, stride, padding, dilation, groups),
                          [xb])
        for k, v in zip(keys, (dev_ms, wrap_ms, plain_ms, bound, by_ops, by_bytes, lib, cudnn)):
            total[k] += c * v
        rows.append("C%d %dx%d k%d/%d x%d (%s): device %.4f, wrapper %.4f, plain %.4f, bound %.4f "
                    "by %s (%s), library %.4f, cuDNN bf16 %.4f"
                    % (key[1], key[2], key[3], key[5], key[7][0], c, branch, dev_ms, wrap_ms,
                       plain_ms, bound, by, share(bound, dev_ms), lib, cudnn))
    total["bound_by"] = "operations" if total["by_ops"] >= total["by_bytes"] else "bytes"
    say(tag + "-int8-dw", "the %d grouped int8 convs of the bf16 forward (branches: %s), %d shapes "
        "(ms; device, library and cuDNN bf16: back to back in one CUDA graph over copies holding "
        "4x the L2; library: cuDNN's float32 grouped conv, its sums equal to the plain "
        "version's): %s; "
        "summed: device %.3f ms, wrapper %.3f, plain %.3f, bound %.3f by %s (%s), library %.3f, "
        "cuDNN bf16 %.3f on %s"
        % (len(grouped), ", ".join("%s %d" % kv for kv in branches.items()), len(shapes),
           "; ".join(rows), total["device_ms"], total["wrapper_ms"], total["plain_ms"],
           total["bound_ms"], total["bound_by"], share(total["bound_ms"], total["device_ms"]),
           total["library_ms"], total["cudnn_ms"], card))
    return dict(total, calls=len(grouped), shapes=len(shapes), branches=branches)


def export_check(dev, card, tmp, pages):
    """Phase 21 (b): phase 11's DB-ResNet18 exported at 1x736x1280x3
    (deploy/common.py's export_program and save_program, as
    deploy/export_model.py exports), float32 and bf16; each .pt2 loaded
    afresh (load_program) and run on the card, its maps against the
    Runner's forward of the same weights on the same normalized page; the
    file's size and one warm call's ms."""
    import cv2
    import torch

    from pytorchocr_tpu_torch.deploy.common import export_program, load_program, save_program
    from pytorchocr_tpu_torch.deploy.infer_det import Deter

    ckpt = os.path.join(tmp, "train_out", "best_accuracy")
    check(os.path.isdir(ckpt), "export: phase 11's checkpoint %s is missing" % ckpt)
    shape = (1, H, W, 3)
    page = cv2.cvtColor(cv2.imread(pages[0]), cv2.COLOR_BGR2RGB)[None]
    check(page.shape == shape, "export: page 0 is %s, not %s" % (page.shape, shape))
    runner = Deter(TRAIN_CFG, ckpt, device=dev, dtype=torch.float32).runner
    x = runner.normalize(torch.from_numpy(page).to(dev))
    parts = []
    for dtype, tol in ((torch.float32, EXPORT_F32_TOL), (torch.bfloat16, EXPORT_BF16_TOL)):
        name = str(dtype).split(".")[-1]
        path = os.path.join(tmp, "db_r18_%s.pt2" % name)
        runner.dtype = dtype
        with float32_on_card() if dtype == torch.float32 else contextlib.nullcontext():
            t0 = time.perf_counter()
            size = save_program(export_program(runner.model, shape, dev, dtype), path)
            export_s = time.perf_counter() - t0
            want = runner(page)["maps"].float()
            fn = load_program(path)
            with torch.no_grad():
                got = fn(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        check(got.dtype == dtype and got.shape == want.shape, "export %s: maps %s %s, the "
              "runner's %s" % (name, got.dtype, tuple(got.shape), tuple(want.shape)))
        rel = float((got.float() - want).abs().max() / want.abs().max())
        check(rel <= tol, "export %s: the loaded program's maps are %.3g of max |map| from the "
              "Runner's (tolerance %g)" % (name, rel, tol))
        parts.append("%s: %.1f MB, exported and saved in %.1f s; loaded and run: maps %.3g of "
                     "max |map| from the Runner's forward (tolerance %g), one warm call %.2f ms"
                     % (name, size / 1e6, export_s, rel, tol, ms))
    say("export", "DB-ResNet18 (phase 11's checkpoint) through torch.export at %s, float32 NHWC "
        "in, maps out: %s on %s" % ("x".join(map(str, shape)), "; ".join(parts), card))


def images_and_replicas(dev, card, tmp, pages, db):
    """Phase 21 (c): `python -m pytorchocr_tpu_torch.deploy.run_ocr` (its
    main, bf16) on one page with phase 5's checkpoints writes res_*.jpg, the
    page with its res_*.txt rows drawn (draw_ocr_res, with the font its
    search finds: PIL's fallback where the host has no CJK font); then a
    Runner over two
    replicas on this card, float32, against one replica: its split and
    gather bit for bit one replica's runs of the same shares, for 4 pages
    and for 3 (padded to 4)."""
    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy import run_ocr
    from pytorchocr_tpu_torch.deploy.common import Runner
    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.deploy.utils import _find_cjk_font, draw_ocr_res
    from pytorchocr_tpu_torch.modeling import build_model
    from pytorchocr_tpu_torch.utils.config import load_config

    out = os.path.join(tmp, "ocr_images")
    argv = sys.argv
    sys.argv = ["run_ocr", "--det_config", DET_CFG, "--det_model_path", db["det_pt"],
                "--rec_config", REC_CFG, "--rec_model_path", db["rec_pt"], "--img_path",
                pages[0], "--out_dir", out, "--device", str(dev)]
    try:
        run_ocr.main()
    finally:
        sys.argv = argv
    stem = os.path.splitext(os.path.basename(pages[0]))[0]
    jpg = cv2.imread(os.path.join(out, "res_%s.jpg" % stem))
    check(jpg is not None and jpg.shape == cv2.imread(pages[0]).shape,
          "run_ocr wrote no res_%s.jpg of the page's size" % stem)
    rows = []
    for line in open(os.path.join(out, "res_%s.txt" % stem), encoding="UTF-8"):
        parts = line.rstrip("\n").split(",")
        rows.append([np.array([int(v) for v in parts[:8]]).reshape(4, 2),
                     ",".join(parts[8:-1]), float(parts[-1])])
    check(len(rows) > 0, "run_ocr found no text line on page 0")
    again = os.path.join(tmp, "again.jpg")
    draw_ocr_res(rows, pages[0], again)
    check(np.array_equal(jpg, cv2.imread(again)), "run_ocr's res_%s.jpg is not its res_%s.txt "
          "rows drawn on the page" % (stem, stem))
    say("images", "run_ocr on page 0 (bf16) wrote res_%s.txt (%d lines) and res_%s.jpg "
        "(%dx%d), the txt's polygons and texts drawn on the page pixel for pixel (font: %s)"
        % (stem, len(rows), stem, jpg.shape[1], jpg.shape[0],
           _find_cjk_font() or "PIL's fallback"))

    with float32_on_card():
        deter = Deter(DET_CFG, db["det_pt"], device=dev, dtype=torch.float32)
        one = deter.runner
        two = Runner(build_model(load_config(DET_CFG)["Architecture"]), [dev, dev],
                     mean=one.mean.flatten().tolist(), std=one.std.flatten().tolist(),
                     dtype=torch.float32).load_state(db["det_pt"])
        check(len(two.replicas) == 2 and two.replicas[1] is not two.model,
              "the Runner did not build two replicas")
        batch = _det_batch(deter, pages)[0]
        notes = []
        for b in (batch, batch[:3]):
            n = len(b)
            got = two(b)["maps"]
            padded = np.concatenate([b, np.repeat(b[:1], (-n) % 2, axis=0)])
            half = len(padded) // 2
            shares = torch.cat([one(padded[:half])["maps"], one(padded[half:])["maps"]])[:n]
            check(torch.equal(got, shares), "the two-replica Runner's %d pages differ from one "
                  "replica's runs of the same shares" % n)
            whole = one(b)["maps"]
            notes.append("%d pages: bit for bit one replica's runs of the same shares; against "
                         "one replica on all %d at once, max |diff| %.3g" % (
                             n, n, float((got - whole).abs().max())))
    say("replicas", "Runner over two replicas on %s (cuda:0 twice: the split, pad and gather "
        "path on one card), float32, TF32 off: %s" % (card, "; ".join(notes)))


def phase_serving(dev, card, tmp, pages, db, refs):
    """Phase 21 (the module's phase 21 note above). Returns the int8 zoo's
    launches by path and kernel and its grouped convs' sums by model."""
    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer

    t_phase = time.perf_counter()
    parts = {}

    def part(name, t):
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
        return time.perf_counter()

    kernels_ready(["int8_conv", "requant"])
    side_idle("serving")
    launches, dw = {}, {}
    ocr = OCRer(DET_CFG, db["det_pt"], REC_CFG, db["rec_pt"], device=dev)  # its CRNN serves all
    t = time.perf_counter()
    for tag, src in ZOO_INT8:
        zoo = refs[src].result()
        ref = refs["int8 " + tag].result()
        t = part("waiting for the CPU", t)
        say(tag + "-int8", "%s, seeded as phase 16 seeds it (head text-like on %d pages: margin "
            "%s logits)" % (os.path.basename(ref["det_cfg"]), ZOO_CPU_PAGES, _fmt(zoo["margin"])))
        launches[tag], grouped = zoo_int8_path(
            dev, card, tag, ref["det_cfg"], ref["det_pt"], zoo["margin"], 2 * db["f32_diff"],
            ocr, pages, ref)
        if grouped:
            dw[tag] = grouped_conv_report(tag, grouped, card)
        t = part(tag, t)
    del ocr
    check(sum(v["int8_conv depthwise"] for v in launches.values()) > 0
          and sum(v["int8_conv wgmma"] for v in launches.values()) > 0,
          "int8 zoo: a branch of the int8 conv was never launched")
    export_check(dev, card, tmp, pages)
    t = part("export", t)
    images_and_replicas(dev, card, tmp, pages, db)
    part("images and replicas", t)
    say("serving", "phase 21 took %.1f s: %s" % (time.perf_counter() - t_phase, ", ".join(
        "%s %.1f s" % kv for kv in parts.items())))
    return dict(launches=launches, dw=dw)


# phase 22: the zoo's tail, at full width. Each config is a repo config with
# its Architecture.Backbone replaced whole (a `-o Architecture.Backbone.name=`
# override would leave the base backbone's keys behind)
CONVNEXT_T = {"name": "ConvNeXt", "model_name": "tiny"}
SWIN_T = {"name": "SwinTransformer", "embed_dim": 96, "depths": [2, 2, 6, 2],
          "num_heads": [3, 6, 12, 24], "window_size": 7}
REC_R34 = {"name": "ResNet", "layers": 34}
TAIL_CONFIGS = {  # name: (base config, backbone, what it changes beside)
    "convnext": (DET_CFG, CONVNEXT_T, None),
    "swin": (DET_CFG, SWIN_T, None),
    "rec34": (REC_CFG, REC_R34, None),
    # (b): drop path 0 (the train step hands the model no generator), AdamW
    "convnext_train": (TRAIN_CFG, dict(CONVNEXT_T, drop_path_rate=0.0), {
        "base_lr": 0.001, "optim": {"name": "AdamW", "betas": [0.9, 0.999], "weight_decay": 0.05},
        "lr_decay": {"name": "WarmupPolyLR", "warmup_epoch": 3, "power": 0.9}}),
    "rec34_train": (REC_TRAIN_CFG, REC_R34, None),
}
# (b): steps of each run (remat, plain) over the first TAIL_BATCHES batches of
# bs TRAIN_BS; the entry point's run: TAIL_EPOCHS epochs of phase 11's pages,
# the profiler over TAIL_PROFILE
TAIL_STEPS, TAIL_BATCHES, TAIL_EPOCHS, TAIL_PROFILE = 12, 4, 2, (2, 4)
# the two runs' losses step by step and running statistics after them:
# within float32 rounding over the run (|diff| <= TAIL_REMAT_TOL (|v| + 1e-2))
TAIL_REMAT_TOL = 1e-5
# (c): each optimizer's steps on one fixed batch of CRNN-ResNet34 lines
TAIL_OPTIMS = {
    "SGD": {"base_lr": 0.005, "optim": {"name": "SGD", "momentum": 0.9, "nesterov": True,
                                        "weight_decay": 1e-4}},
    "RMSprop": {"base_lr": 1e-4, "optim": {"name": "RMSprop", "alpha": 0.99, "eps": 1e-8}},
}
TAIL_OPT_STEPS, TAIL_OPT_BS = 10, 32
# a parameter after an update against optax's rule in float64 on the card's own
# gradients: |p - want| <= TAIL_ULPS x 2^-23 (|p before| + the update's terms'
# absolute sum), float32 rounding of the state and the update (optax_rule)
TAIL_ULPS = 8


def tail_configs(tmp):
    """TAIL_CONFIGS written to `tmp` (once: the CPU reference processes read
    them); {name: path}."""
    from pytorchocr_tpu_torch.utils.config import load_config, save_config

    paths = {}
    for name, (base, backbone, optimizer) in TAIL_CONFIGS.items():
        paths[name] = os.path.join(tmp, "tail_%s.yml" % name)
        if not os.path.exists(paths[name]):
            cfg = load_config(base)
            cfg["Architecture"]["Backbone"] = dict(backbone)
            if optimizer is not None:
                cfg["Optimizer"] = optimizer
            save_config(cfg, paths[name] + ".part")
            os.replace(paths[name] + ".part", paths[name])
    return paths


def job_tail(tmp, pages, kind, rec_pt=None):
    """Phase 22's seeded detector of `kind` ("convnext", with its seeded
    CRNN-ResNet34; "swin", behind phase 5's CRNN `rec_pt`) and its CPU
    reference on the first ZOO_CPU_PAGES pages."""
    import torch

    from pytorchocr_tpu_torch.utils.seeded import text_like_db_head_

    cfgs = tail_configs(tmp)
    few = pages[:ZOO_CPU_PAGES]
    seed = SEED + 80 + (kind == "swin")
    det_pt, margin = seeded_det(tmp, cfgs[kind], few, text_like_db_head_, seed)
    rec_cfg = REC_CFG
    if kind == "convnext":
        rec_cfg = cfgs["rec34"]
        rec_pt = seeded_rec(tmp, rec_cfg, pages, torch.Generator().manual_seed(seed + 10),
                            "rec34.pt")
    return dict(ref_ocr((cfgs[kind], det_pt, rec_cfg, rec_pt), few), det_pt=det_pt,
                rec_pt=rec_pt, rec_cfg=rec_cfg, margin=margin)


def tail_remat(dev, card, config):
    """(b) TAIL_STEPS bf16 steps of DB-ConvNeXt-tiny with AdamW over the
    first TAIL_BATCHES batches, once with Global.remat and once without,
    from one seeded init, cuDNN deterministic: steps/s (the first step, with
    its setup, untimed), peak memory, and the two runs' losses step by step
    and running statistics after them within TAIL_REMAT_TOL."""
    import torch

    from pytorchocr_tpu_torch.trainer import batch_to_device

    batches = [batch_to_device(b, dev) for b in first_batches(config, TAIL_BATCHES, TRAIN_BS)]
    runs = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for remat in (False, True):
            model, _, step = train_parts(config, dev, amp=True, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with paused("tail-remat" if remat else "tail-plain"):
                losses = [step(batches[0])["loss"]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(1, TAIL_STEPS):
                    losses.append(step(batches[i % len(batches)])["loss"])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            runs[remat] = dict(
                rate=(TAIL_STEPS - 1) / secs, peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                losses=torch.stack(losses).double().cpu(),
                stats={k: v.double().cpu() for k, v in model.state_dict().items()
                       if "running" in k})
            del model, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    plain, remat = runs[False], runs[True]
    loss_off = float(((remat["losses"] - plain["losses"]).abs()
                      / (plain["losses"].abs() + 1e-2)).max())
    stat_off = max(float(((remat["stats"][k] - v).abs() / (v.abs() + 1e-2)).max())
                   for k, v in plain["stats"].items())
    check(bool(torch.isfinite(plain["losses"]).all()), "tail-remat: a loss is not finite")
    check(loss_off <= TAIL_REMAT_TOL and stat_off <= TAIL_REMAT_TOL,
          "tail-remat: Global.remat's run differs from the plain one: losses by %.3g, running "
          "statistics by %.3g of |v| + 1e-2 (tolerance %g)" % (loss_off, stat_off, TAIL_REMAT_TOL))
    say("tail-remat", "DB-ConvNeXt-tiny (FPN 256, DBHead; drop path 0) with AdamW (wd 0.05), bs "
        "%d at %dx%d, bf16 autocast, %d steps over %d fixed batches from one seeded init, cuDNN "
        "deterministic: plain %.3f steps/s, peak %.2f GiB; Global.remat %.3f steps/s (%.3f of "
        "plain), peak %.2f GiB (%.3f of plain); losses step by step %.3g and running statistics "
        "%.3g of |v| + 1e-2 apart (tolerance %g); loss %.4f -> %.4f; on %s"
        % (TRAIN_BS, TRAIN_SIZE, TRAIN_SIZE, TAIL_STEPS, TAIL_BATCHES, plain["rate"],
           plain["peak"], remat["rate"], remat["rate"] / plain["rate"], remat["peak"],
           remat["peak"] / plain["peak"], loss_off, stat_off, TAIL_REMAT_TOL,
           float(plain["losses"][0]), float(plain["losses"][-1]), card))


def tail_train(dev, card, tmp, cfg_path, train_label, eval_label):
    """(b) DB-ConvNeXt-tiny with AdamW on phase 11's pages: tail_remat, the
    entry point with Global.remat and Global.use_profiler (no evaluate: an
    8-step model's maps are noise, whose components cost the host tail
    seconds a page; phase 11's evaluate holds that path), and one float32
    AdamW step held to a float64 CPU step (bs 2 at 320x320: the CPU's
    float64 ConvNeXt step kept short) on phase 12-13's floors: the card's
    LayerNorm-weight gradients reached 3.03 of the CPU float32 step's own
    error there (2.46e-5 of the leaf's largest |g|, on an H100 80GB HBM3 at
    700 W), so a leaf's floor is the larger of that error and ELEM_SCALE of
    its largest |g|, which the TF32 control breaks."""
    import numpy as np

    from pytorchocr_tpu_torch.tools import program

    out = os.path.join(tmp, "convnext_out")
    argv = train_argv(out, train_label, eval_label, TAIL_EPOCHS, cfg=cfg_path)
    config = program.preprocess(is_train=True, argv=argv)[0]
    f32_config = sized(config, 320)
    f32_check = compare_f32_step(f32_config, dev, first_batches(f32_config, 1, 2)[0], card,
                                 what="bs 2, 320x320", tag="convnext-f32", loss_pieces=True,
                                 zero_grad=db_student_zero_grad, card_floors=True)
    tail_remat(dev, card, config)

    start, end = TAIL_PROFILE
    report, run_s = train_run(argv + [
        "Global.eval_epoch_step=[%d,1]" % TAIL_EPOCHS, "Global.remat=True",
        "Global.use_profiler=True", "Global.profile_start_step=%d" % start,
        "Global.profile_end_step=%d" % end])
    steps = TAIL_EPOCHS * (TRAIN_PAGES // TRAIN_BS)
    check(report["steps"] == steps, "convnext-train: %d steps, not %d" % (report["steps"], steps))
    check(bool(np.isfinite(report["losses"]).all()), "convnext-train: a loss is not finite")
    trace = report["profile"]
    check(trace is not None and os.path.exists(trace),
          "convnext-train: Global.use_profiler wrote no trace")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, "convnext-train: the profiler's trace holds no card kernel")
    say("convnext-train", "tools.train.run with Global.remat and Global.use_profiler (window "
        "[%d, %d)): %d steps of bs %d at %dx%d in %.1f s, %.3f steps/s (loader wait %.1f%%); "
        "trace %s, %.1f MB, %d events (%d card kernels) over steps %d-%d; on %s"
        % (start, end, report["steps"], TRAIN_BS, TRAIN_SIZE, TRAIN_SIZE, run_s,
           report["steps"] / report["wall_s"], 100.0 * report["reader_s"] / report["wall_s"],
           os.path.basename(trace), os.path.getsize(trace) / 1e6, len(events), kernels, start,
           end - 1, card))
    later(f32_check)


def optax_rule(name, cfg, p0, grads, lr, state):
    """optax's update of `name` (the JAX package's SGD / RMSprop, its
    optimizer/__init__.py:44-58) in float64, from `p0` and `grads` (float64
    lists), with `state` (a dict, empty at the first step) updated in place:
    per parameter the parameter after it and the update's scale, the same
    sums over the absolute values of their terms (what float32 rounding is
    relative to where the terms cancel)."""
    import torch

    optim = cfg["optim"]
    m = optim.get("momentum", 0.0)
    out = []
    for i, (p, g) in enumerate(zip(p0, grads)):
        zero = torch.zeros_like(g)
        if name == "SGD":  # add_decayed_weights, then trace (nesterov), then -lr
            wd = optim.get("weight_decay", 0.0)
            g, g_abs = g + wd * p, g.abs() + wd * p.abs()
            if m:
                t = g + m * state.get(("t", i), zero)
                t_abs = g_abs + m * state.get(("|t|", i), zero)
                state[("t", i)], state[("|t|", i)] = t, t_abs
                if optim.get("nesterov"):
                    g, g_abs = g + m * t, g_abs + m * t_abs
                else:
                    g, g_abs = t, t_abs
            out.append((p - lr * g, lr * g_abs))
        else:  # scale_by_rms (eps in the root, zero initial scale), -lr, trace
            a = optim.get("alpha", 0.99)
            nu = (1 - a) * g * g + a * state.get(("nu", i), zero)
            state[("nu", i)] = nu
            u = -lr * g / torch.sqrt(nu + optim.get("eps", 1e-8))
            t = u + m * state.get(("t", i), zero)
            t_abs = u.abs() + m * state.get(("|t|", i), zero)
            state[("t", i)], state[("|t|", i)] = t, t_abs
            out.append((p + t, t_abs))
    return out


def tail_optimizers(dev, card, tmp, cfg_path, lines):
    """(c) SGD (nesterov, weight decay) and RMSprop on CRNN-ResNet34
    (rec_vgg_bilstm_ctc_synth.yml with Backbone {name: ResNet, layers: 34})
    for TAIL_OPT_STEPS bf16 steps on one fixed batch of phase 12's lines,
    each from the seeded init at a constant LR: every update held to optax's
    rule applied in float64 on the card to the card's own gradients, and the
    loss falls."""
    import copy

    import torch

    from pytorchocr_tpu_torch.trainer import batch_to_device

    train_label, eval_label = lines[:2]
    first = os.path.join(tmp, "rec34_first.txt")
    with open(first, "w") as f:
        f.write("".join(open(train_label).readlines()[:TAIL_OPT_BS]))
    config = lines_config(lines_argv(cfg_path, os.path.join(tmp, "rec34_out"), first,
                                     eval_label, 1))
    batch = first_batches(config, 1, TAIL_OPT_BS)[0]
    parts = []
    for name, opt_cfg in TAIL_OPTIMS.items():
        cfg = copy.deepcopy(config)
        cfg["Optimizer"] = copy.deepcopy(opt_cfg)
        model, opt, step = train_parts(cfg, dev, amp=True, schedule=(1, 1))
        params = [p for g in opt.param_groups for p in g["params"]]
        b = batch_to_device(batch, dev)
        state, losses, worst = {}, [], 0.0
        for _ in range(TAIL_OPT_STEPS):
            p0 = [p.detach().double() for p in params]
            lr = opt.current_lr()
            losses.append(float(step(b)["loss"]))
            want = optax_rule(name, opt_cfg, p0, [p.grad.detach().double() for p in params],
                              lr, state)
            for p, (w, scale), q in zip(params, want, p0):
                bound = TAIL_ULPS * 2.0 ** -23 * (q.abs() + scale) + 1e-30
                worst = max(worst, float(((p.detach().double() - w).abs() / bound).max()))
        check(worst <= 1.0, "tail-%s: an update is %.3g of its bound from optax's rule "
              "(float64, on the card's gradients)" % (name, worst))
        check(sum(losses[-3:]) / 3 < losses[0], "tail-%s: the loss did not fall: %s"
              % (name, ", ".join("%.4f" % v for v in losses)))
        parts.append("%s (%s; LR %g) loss %s, every update within %.3g of its bound"
                     % (name, ", ".join("%s %s" % kv for kv in opt_cfg["optim"].items()
                                        if kv[0] != "name"), opt_cfg["base_lr"],
                        " -> ".join("%.3f" % v for v in losses[::3]), worst))
        del model, opt, step
    say("tail-optim", "CRNN-ResNet34 (BiLSTM 256, CTC over the 36-character table and blank), "
        "%d bf16 steps on one batch of %d drawn lines at 1x32x320 from the seeded init: %s "
        "(the bound: %d x 2^-23 x (|p| + the update's terms' absolute sum) from optax's rule "
        "in float64 on the card's own gradients); on %s" % (TAIL_OPT_STEPS, TAIL_OPT_BS, "; ".join(parts), TAIL_ULPS,
                                   card))


def phase_zoo_tail(dev, card, tmp, pages, db, refs, labels, lines):
    """Phase 22, the zoo's tail: (b) tail_train and (c) tail_optimizers
    first (the float64 step of (b) runs in the CPU reference process
    meanwhile, and the first process makes (a)'s references), then (a)
    DB-ConvNeXt-tiny + CRNN-ResNet34 and DB-Swin-T + phase 5's CRNN served
    at full width (zoo_ocr_path: float32 against the CPU on ZOO_CPU_PAGES
    pages, the bf16 main path on all pages with every K1 launch held,
    pages/s and stages). Returns K1's launches by path."""
    t_phase = time.perf_counter()
    cfgs = tail_configs(tmp)
    tail_train(dev, card, tmp, cfgs["convnext_train"], *labels)
    t_c = time.perf_counter()
    tail_optimizers(dev, card, tmp, cfgs["rec34_train"], lines)
    t_a = time.perf_counter()
    k1 = {}
    ref = refs["tail convnext"].result()
    say("convnext", "seeded DB-ConvNeXt-tiny (det_r18_db.yml with Backbone %s: depths 3/3/9/3, "
        "widths 96-768, LayerNorm taps; FPN 256, DBHead k=50), head text-like on %d pages: "
        "margin %s logits; with a seeded CRNN-ResNet34 (rec_vgg_bilstm_ctc.yml with Backbone "
        "%s, BiLSTM 256, CTC over 6,624 classes)" % (CONVNEXT_T, ZOO_CPU_PAGES,
                                                     _fmt(ref["margin"]), REC_R34))
    k1["DB-ConvNeXt"] = zoo_ocr_path(dev, card, "convnext", cfgs["convnext"], ref["det_pt"],
                                     ref["margin"], ref["rec_cfg"], ref["rec_pt"], pages, ref)
    ref = refs["tail swin"].result()
    say("swin", "seeded DB-Swin-T (det_r18_db.yml with Backbone %s: 1,242 7x7 windows a page "
        "at stage 1 (184x320 padded to 189x322), shifted in every second block; FPN 256, "
        "DBHead k=50), head text-like on %d pages: margin %s logits; with phase 5's CRNN"
        % (SWIN_T, ZOO_CPU_PAGES, _fmt(ref["margin"])))
    k1["DB-Swin"] = zoo_ocr_path(dev, card, "swin", cfgs["swin"], ref["det_pt"], ref["margin"],
                                 REC_CFG, db["rec_pt"], pages, ref)
    say("zoo-tail", "phase 22 took %.1f s: (b) %.1f s, (c) %.1f s, (a) %.1f s"
        % (time.perf_counter() - t_phase, t_c - t_phase, t_a - t_c, time.perf_counter() - t_a))
    return k1


def forbidden_modules():
    """Modules of JAX, flax or the JAX package that this process loaded: the
    port and this script import none of them."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "pytorchocr_tpu"))


STREAMED = ("back-to-back launches in one CUDA graph over rotating copies of the inputs and "
            "outputs that hold 4x the L2, CUDA events over the graph / launches (stream_ms)")


# each phase's time budget (s), printed beside its time: a phase past it says
# so on its line and does not fail the run (the host's speed moves every
# phase; PERF.md §6); they sum to at most 990 s
PHASE_BUDGET_S = {"1-2": 25, "3": 12, "4": 2, "5": 20, "6": 30, "7": 40, "8": 30, "9": 5,
                  "9 (requant)": 3, "10": 15, "11": 55, "12": 40, "13": 35, "14": 90, "15": 85,
                  "16": 45, "17": 100, "18": 70, "19": 115, "20": 10, "20 (end)": 10, "21": 80,
                  "22": 55, "checks": 15}
ORDER = tuple(p for p in PHASE_BUDGET_S if p != "checks")
# what a phase reads from earlier ones (--only adds them)
NEEDS = {"6": ("5",), "8": ("5",), "9": ("8",), "9 (requant)": ("8",), "10": ("5",),
         "14": ("11",), "15": ("11",), "16": ("5",), "17": ("11", "12"), "19": ("11", "12"),
         "20": ("11",), "21": ("5", "11"), "22": ("5", "11", "12")}
# the CPU reference jobs a phase reads (submit_references)
REFS = {"5": ("slice",), "6": ("slice", "pse"), "7": ("pan",), "8": ("slice", "int8"),
        "10": ("slice", "cls"), "12": ("lines rec",), "13": ("lines cls",),
        "16": ("slice", "dbpp", "starnet") + tuple(tag for tag, _, _ in ZOO_DET),
        "21": ("slice",) + tuple(src for _, src in ZOO_INT8)
        + tuple("int8 " + tag for tag, _ in ZOO_INT8),
        "22": ("slice", "tail convnext", "tail swin")}


def chosen_phases(arg):
    """The phases of `--only` ("18", "1-4,19", ...): each listed one, "9"
    with its requantize part, and what they read from earlier phases."""
    numbers = set()
    for part in arg.split(","):
        lo, _, hi = part.strip().partition("-")
        if not lo.isdigit() or (hi and not hi.isdigit()):
            raise SystemExit("chip_smoke FAILED: --only takes phase numbers and ranges, e.g. "
                             "1-4,19")
        numbers |= set(range(int(lo), int(hi or lo) + 1))
    chosen = {p for p in ORDER if any(int(n) in numbers for n in p.split(" ")[0].split("-"))}
    while True:
        more = {n for p in chosen for n in NEEDS.get(p, ())} - chosen
        if not more:
            return [p for p in ORDER if p in chosen]
        chosen |= more


def main():
    if sys.argv[1:2] in (["--cpu-worker"], ["--side-worker"]):  # as the module chip_smoke
        sys.path.insert(0, REPO)
        import chip_smoke

        chip_smoke.IN_SIDE = sys.argv[1] == "--side-worker"
        chip_smoke.cpu_worker_main(sys.argv[2], int(sys.argv[3]))
        return
    if sys.argv[1:2] in (["--rank-job"], ["--train-rank"]):  # a rank of phase 20
        sys.path.insert(0, REPO)
        import chip_smoke

        if sys.argv[1] == "--rank-job":
            chip_smoke.rank_job_main(sys.argv[2], sys.argv[3])
        else:
            deterministic = sys.argv[3:4] == ["--deterministic"]
            chip_smoke.train_rank_main(sys.argv[2], sys.argv[3 + deterministic:], deterministic)
        return
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke FAILED: torch is not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    try:
        import pytorchocr_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit("chip_smoke FAILED: run it from a checkout of the repo (%s)" % e)

    only = chosen_phases(sys.argv[sys.argv.index("--only") + 1]) if "--only" in sys.argv else None
    dev = torch.device("cuda:0")
    card = card_line()
    say("device", "torch.cuda: %s; nvidia-smi: %s; torch %s, CUDA %s"
        % (torch.cuda.get_device_name(0), card, torch.__version__, torch.version.cuda))
    global WORKER, STEP_WORKER, SIDE
    with tempfile.TemporaryDirectory() as tmp:
        # the card's host work keeps the cores that the two niced processes leave
        WORKER = CpuWorker(os.path.join(tmp, "cpu_worker"), "the CPU reference process")
        STEP_WORKER = CpuWorker(os.path.join(tmp, "step_worker"),
                                "the CPU reference process of the steps")
        SIDE = CpuWorker(os.path.join(tmp, "side_worker"), "the side process", side=True)
        try:
            out = run_phases(dev, card, tmp, only or ORDER)
        finally:
            for worker in (WORKER, STEP_WORKER, SIDE):
                worker.close()
            say("cpu-worker", "the CPU reference processes (references; steps): stopped %.1f s "
                "and %.1f s for the timed sections, waited for %.1f s and %.1f s in all; the run "
                "waited %.1f s at its end for the side process's convergence checks"
                % (WORKER.stopped_s, STEP_WORKER.stopped_s, WORKER.waited_s,
                   STEP_WORKER.waited_s, SIDE.waited_s))
            WORKER = STEP_WORKER = SIDE = None
    bad = forbidden_modules()
    check(not bad, "the port imported %s" % bad)
    if only:
        say("done", "phases %s only: no result printed" % ", ".join(only))
        return
    report_kernels(card, **out)


def run_phases(dev, card, tmp, phases):
    """Run `phases` (names of ORDER), each timed beside its budget, the CPU
    reference jobs they read submitted first: 1-4, the trainings (11-15,
    17-19), then the serving phases (5-10, 16), whose CPU references the
    reference process makes while the trainings' card-bound loops leave it
    the host. Returns what the kernels line reads."""
    from pytorchocr_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.start(list(_kernels.SIGNATURES))  # one nvcc per source, all started together
    pages = make_pages(tmp)
    refs = submit_references(tmp, pages, {r for p in phases for r in REFS.get(p, ())})
    got = {}

    def phase(name, fn, *args):
        if name not in phases:
            return None
        t = time.perf_counter()
        got[name] = fn(*args)
        took, budget = time.perf_counter() - t, PHASE_BUDGET_S[name]
        if OVERLAPPED:
            say("beside", "phase %s's timed sections ran beside other work (their times carry "
                "that): %s" % (name, "; ".join("%s beside %s" % (sec, " and ".join(sorted(who)))
                                             for sec, who in sorted(OVERLAPPED.items()))))
            OVERLAPPED.clear()
        say("time", "phase %s took %.1f s, budget %d s%s (all phases so far %.1f s)"
            % (name, took, budget, "" if took <= budget else ": PAST ITS BUDGET (a slow host "
               "is no fault of the port; not a failure)", time.perf_counter() - t0))
        return got[name]

    int32_rate = int32_ops_per_s()
    with paused():  # their plain versions run on the CPU: the process would slow them
        phase("1-2", phase_kernels, dev, card, int32_rate)
        phase("3", phase_propagate, dev, card, int32_rate)
        phase("4", phase_front_half, dev)
    # the trainings first: their card-bound loops leave the host's cores to the
    # CPU reference process, which meanwhile makes the serving phases' references
    labels = (phase("11", phase_train, dev, card, tmp) or (0, None, None))[1:]
    lines = phase("12", phase_lines_train, dev, card, tmp, "rec", refs.get("lines rec"))
    phase("13", phase_lines_train, dev, card, tmp, "cls", refs.get("lines cls"))
    phase("14", phase_det_train, dev, card, tmp, "pse", *labels)
    phase("15", phase_det_train, dev, card, tmp, "pan", *labels)
    phase("17", phase_zoo_train, dev, card, tmp, *labels, lines)
    phase("18", phase_table, dev, card, tmp)
    # phase 20's processes run beside phase 19, which this process runs meanwhile
    with contextlib.ExitStack() as dp_stack:
        dp = phase("20", phase_dp_start, dev, card, tmp, *labels, dp_stack)
        phase("19", phase_distill, dev, card, tmp, *labels, lines)
        if dp is not None:
            phase("20 (end)", phase_dp_end, dp, card, dp_stack.pop_all())
    db = (phase("5", phase_slice, dev, card, tmp, pages, refs.get("slice")) or (0, None))[1]
    phase("6", phase_pse, dev, card, tmp, pages, db and db["rec_pt"], refs.get("pse"))
    phase("7", phase_pan, dev, card, tmp, pages, refs.get("pan"))
    q8 = phase("8", phase_int8_slice, dev, card, pages, db, refs.get("int8"))
    got["8 launches"], ocr_q8 = q8 or (None, None)
    got.pop("8", None)  # keeps the int8 OCRer only as long as phase 9 needs it
    phase("9", phase_int8_conv, dev, card, ocr_q8, pages)
    phase("9 (requant)", phase_requant, dev, card, ocr_q8, pages)
    del q8, ocr_q8
    phase("10", phase_cls, dev, card, tmp, pages, db, refs.get("cls"))
    phase("16", phase_zoo_serve, dev, card, tmp, pages, db, refs)
    phase("21", phase_serving, dev, card, tmp, pages, db, refs)
    phase("22", phase_zoo_tail, dev, card, tmp, pages, db, refs, labels, lines)
    kernels_ready(list(_kernels.SIGNATURES))  # every kernel built, whichever phases ran
    phases = list(phases) + ["checks"]
    phase("checks", run_deferred)  # the float32-step checks held back (later)
    total = time.perf_counter() - t0
    say("time", "all phases %.1f s against their budgets' %d s" % (
        total, sum(PHASE_BUDGET_S[p] for p in phases)))
    if set(phases) != set(ORDER) | {"checks"}:
        return None
    k1_paths = {"DB": got["5"][0], "PSE": got["6"][0], "PAN": got["7"],
                "train-eval": got["11"][0], "PSE-train-eval": got["14"][0],
                "PAN-train-eval": got["15"][0], **got["16"], "DB++-train-eval": got["17"],
                **got["19"], "DP-train-eval": got["20 (end)"], **got["22"]}
    k2_paths = {"PSE": got["6"][1], "PSE-train-eval": got["14"][1]}
    return dict(k1_paths=k1_paths, k2_paths=k2_paths, k1=got["1-2"], k2=got["3"], q8=got["9"],
                rq=got["9 (requant)"], q8_launches=got["8 launches"], zoo=got["21"], total=total)


def report_kernels(card, k1_paths, k2_paths, k1, k2, q8, rq, q8_launches, zoo, total):
    """The kernels line, the card line and the contract's last line."""
    import torch

    from pytorchocr_tpu_torch.ops import int8_conv

    q8_conv, q8_k1, q8_rq = q8_launches
    zoo_paths = {"int8 " + tag: n for tag, n in zoo["launches"].items()}
    k1_paths = dict(k1_paths, **{"int8 DB": q8_k1},
                    **{path: n["K1"] for path, n in zoo_paths.items()})
    conv_paths = dict({"int8 DB": q8_conv}, **{p: n["int8_conv"] for p, n in zoo_paths.items()})
    rq_paths = dict({"int8 DB": q8_rq}, **{p: n["requant"] for p, n in zoo_paths.items()})
    branches = {b: sum(n["int8_conv " + b] for n in zoo_paths.values())
                for b in int8_conv.BRANCHES}
    branches["wgmma"] += q8_conv  # the int8 DB-ResNet18 has no grouped conv
    gemm_paths = dict({"int8 DB": q8_conv}, **{p: n["int8_conv wgmma"]
                                               for p, n in zoo_paths.items()})
    dw_paths = {p: n["int8_conv depthwise"] for p, n in zoo_paths.items()}
    say("done", "main-path launches: K1 %d (%s), K2 %d (%s), int8_conv %d (%s; wgmma %d, "
        "depthwise %d, direct %d) and requant %d (%s); all phases %.1f s"
        % (sum(k1_paths.values()), ", ".join("%s %d" % kv for kv in k1_paths.items()),
           sum(k2_paths.values()), ", ".join("%s %d" % kv for kv in k2_paths.items()),
           sum(conv_paths.values()), ", ".join("%s %d" % kv for kv in conv_paths.items()),
           branches["wgmma"], branches["depthwise"], branches["direct"], sum(rq_paths.values()),
           ", ".join("%s %d" % kv for kv in rq_paths.items()), total))

    kernels = []
    for name, source, replaces, launches, row, by_path in (
        ("segmented_runmax", "runmax.cu", 195, sum(k1_paths.values()), k1, k1_paths),
        ("propagate_rounds", "propagate.cu", 41, sum(k2_paths.values()), k2, k2_paths),
    ):
        kernels.append(dict(
            name=name, route="cuda", source="pytorchocr_tpu_torch/csrc/" + source,
            replaces="pytorchocr_tpu/ops/pallas_propagate.py:%d" % replaces,
            launches=launches, launches_by_path=by_path, max_abs_err=row["max_abs_err"],
            ms=row["device_ms"],
            device_ms=row["device_ms"], wrapper_ms=row["wrapper_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            library_note=NO_LIBRARY[name], timing="torch.profiler's mean card duration of a "
            "launch, back to back with the same inputs (L2 warm)",
        ))
    kernels.append(dict(
        name="int8_conv", route="cuda", source="pytorchocr_tpu_torch/csrc/int8_conv.cu",
        replaces="pytorchocr_tpu/ops/quant.py:252", launches=sum(gemm_paths.values()),
        launches_by_path=gemm_paths, launches_by_branch=branches,
        max_abs_err=q8["max_abs_err"], ms=q8["device_ms"], device_ms=q8["device_ms"],
        wrapper_ms=q8["wrapper_ms"], plain_ms=q8["plain_ms"], bound_ms=q8["bound_ms"],
        bound_by=q8["bound_by"], library_ms=q8["library_ms"],
        f32_device_ms=q8["f32"]["device_ms"], f32_bound_ms=q8["f32"]["bound_ms"],
        per="one %d-page %dx%d DB-ResNet18 int8 forward, bf16 output (the main path's): the sum "
            "over its %d int8 convs" % (PAGES, H, W, q8["calls"]),
        timing=STREAMED, portrait_stem_ms=q8["portrait_stem_ms"],
        library_note="torch._int_mm (the same int32 product) on the %d 1x1 stride-1 convs of "
                     "the %d; no PyTorch call computes the others (an int8 convolution on CUDA)"
                     % (q8["library_calls"], q8["calls"]),
        branch="the wgmma implicit GEMM (groups 1); launches: its branch's",
    ))
    dw = zoo["dw"]
    dw_sum = {k: sum(d[k] for d in dw.values()) for k in ("device_ms", "wrapper_ms", "plain_ms",
                                                          "bound_ms", "by_ops", "by_bytes",
                                                          "library_ms", "cudnn_ms")}
    kernels.append(dict(
        name="int8_dwconv", route="cuda", source="pytorchocr_tpu_torch/csrc/int8_conv.cu",
        replaces="pytorchocr_tpu/ops/quant.py:252", launches=sum(dw_paths.values()),
        launches_by_path=dw_paths,
        max_abs_err=0.0,  # zoo_int8_path's hold() fails the run on any launch that differs
        ms=dw_sum["device_ms"], device_ms=dw_sum["device_ms"], wrapper_ms=dw_sum["wrapper_ms"],
        plain_ms=dw_sum["plain_ms"], bound_ms=dw_sum["bound_ms"],
        bound_by="operations" if dw_sum["by_ops"] >= dw_sum["by_bytes"] else "bytes",
        library_ms=dw_sum["library_ms"], cudnn_bf16_ms=dw_sum["cudnn_ms"],
        by_model={tag: {k: d[k] for k in ("calls", "shapes", "device_ms", "wrapper_ms",
                                          "plain_ms", "bound_ms", "library_ms", "cudnn_ms")}
                  for tag, d in dw.items()},
        per="one %d-page %dx%d bf16 int8 forward of each of %s: the sum over their %d grouped "
            "convs" % (PAGES, H, W, ", ".join(dw), sum(d["calls"] for d in dw.values())),
        timing=STREAMED, branch="the depthwise branch of int8_conv (groups > 1, one input "
        "channel a group)",
        library_note="cuDNN's float32 grouped F.conv2d on the int8 values cast to float32, "
                     "channels_last, back to back in one CUDA graph as the kernel (exact; its "
                     "sums held equal to the plain version's); cudnn_bf16_ms: its bf16 conv, "
                     "timed alike, context",
    ))
    kernels.append(dict(
        name="requant", route="cuda", source="pytorchocr_tpu_torch/csrc/requant.cu",
        replaces="pytorchocr_tpu/ops/quant.py:119", launches=sum(rq_paths.values()),
        launches_by_path=rq_paths,
        max_abs_err=rq["max_abs_err"], ms=rq["device_ms"], device_ms=rq["device_ms"],
        wrapper_ms=rq["wrapper_ms"], plain_ms=rq["plain_ms"], bound_ms=rq["bound_ms"],
        bound_by="bytes", library_ms=rq["library_ms"],
        per="one %d-page %dx%d DB-ResNet18 int8 bf16 forward: the sum over its %d quantize, "
            "dequant and residual requantize calls" % (PAGES, H, W, rq["calls"]),
        timing=STREAMED,
        library_note="torch.mul(q, scale, out=<bf16>) (bit-equal) on the %d dequant calls of the "
                     "%d, where the kernel takes %.4f ms; no single PyTorch call quantizes or "
                     "requantizes an add" % (rq["library_calls"], rq["calls"],
                                             rq["library_kernel_ms"]),
    ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
