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
     uninterrupted one, cuDNN deterministic); then 200 steps of bs 16 in
     bf16 through tools.train.run, the entry point of `python -m
     pytorchocr_tpu_torch.tools.train`, whose loss must fall below half its
     start (means of the first and last 20 steps), with steps/s, samples/s,
     the loader-wait share, and the bucketed evaluate after the last epoch,
     the main-path run of K1 on the training-eval path (counted); the eval
     CLI on the saved checkpoint; card busy over 4 steps by torch.profiler;
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
     and that model served from a checkpoint directory by Recer; 100 steps
     through tools.train.run with steps/s, samples/s, the loader-wait, copy
     and per-step-metric shares; tools.eval.run on best_accuracy equal to the
     train run's metric; Recer (deploy.infer_rec) on best_accuracy reading
     the eval lines as the eval post process does; card busy by
     torch.profiler over 4 iterations of the loop;
 13. direction-classifier training, cls_mbv3small_synth.yml as published
     (MobileNetV3 small x0.35, bs 128 at 3x48x192, RecAug without TIA and
     RandAugment) on drawn lines of 5-25 characters, half turned by 180
     degrees: the float32 step against float64, 800 steps through
     tools.train.run whose eval accuracy must reach 0.8, tools.eval.run
     equal to it, Clser (deploy.infer_cls) on best_accuracy giving the
     eval's labels, the same rates and profiler. Phases 12 and 13 add no
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
     page; card busy over 4 steps;
 15. PAN++ training, det_r18_pan_synth.yml as published (ResNet-18,
     FPEM_FFM v2 128 x2, PANHead 128 -> 6, PANLoss v2 with the embedding
     loss, bs 16 at 640x640, MakePanGt, float32 images on the wire), the
     checks of phase 14 at 640x640 with 40 steps and 0.6, K1 on the
     PAN-train-eval path; both time their loss, and PAN its embedding loss.
Each main-path run sets the kernels' counts to 0 just before it and reads
them just after. At the end it checks that no module of jax, flax or the
JAX package (pytorchocr_tpu) was loaded. The line before the last is
{"kernels": [...]} (device_ms, wrapper_ms, plain_ms, bound_ms, bound_by,
library_ms, launches, and `timing`, how device_ms was taken), the last one
the contract {"ok": true, "device":
{...}}. Without a card, or outside a checkout, it exits non-zero and prints
no result.
"""

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


def phase_kernels(dev, card, int32_rate):
    import numpy as np
    import torch

    from pytorchocr_tpu_torch import _kernels
    from pytorchocr_tpu_torch.ops import runmax

    t0 = time.perf_counter()
    names = list(_kernels.SIGNATURES)
    _kernels.build(names)  # one nvcc per source, all started together
    for name in names:
        _kernels.load(name)
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
    igmma = igmma_count(_kernels.build(["int8_conv"])["int8_conv"])
    if igmma is not None:
        check(igmma > 0, "the int8 conv library holds no IGMMA instruction: no wgmma path built")
        say("build", "int8_conv: %d IGMMA (wgmma s8) instructions in its SASS (cuobjdump)" % igmma)
    say("build", "all kernels ready in %.2f s" % (time.perf_counter() - t0))

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
    head decisive (decisive_ctc_head_). Returns the .pt paths and the DB
    head's threshold margin in logits."""
    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.deploy.infer_rec import Recer
    from pytorchocr_tpu_torch.utils.seeded import (
        decisive_ctc_head_, seeded_init_, text_like_db_head_,
    )

    gen = torch.Generator().manual_seed(SEED)
    deter = Deter(det_cfg, None, device="cpu")
    model = seeded_init_(deter.runner.model, gen)
    margin = text_like_db_head_(model, *det_inputs(deter, pages))
    det_pt = os.path.join(dirname, "det.pt")
    torch.save(model.state_dict(), det_pt)
    recer = Recer(rec_cfg, None, device="cpu")
    model = seeded_init_(recer.runner.model, gen)
    page_img = cv2.imread(pages[0])
    strips = [recer._prep(page_img[y : y + 48, : W // 2]) for y in range(30, H - 48, 90)]
    decisive_ctc_head_(model, torch.from_numpy(np.stack(strips)).permute(0, 3, 1, 2))
    rec_pt = os.path.join(dirname, "rec.pt")
    torch.save(model.state_dict(), rec_pt)
    return det_pt, rec_pt, margin


def seeded_det(dirname, det_cfg, pages, text_like, seed):
    """A full-width det model of `det_cfg` with weights from a
    torch.Generator seeded with `seed`, its head made text-like on `pages`
    by `text_like` (utils.seeded). Returns the .pt path and the head's
    margins in logits, one per thresholded map."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.utils.seeded import seeded_init_

    gen = torch.Generator().manual_seed(seed)
    deter = Deter(det_cfg, None, device="cpu")
    model = seeded_init_(deter.runner.model, gen)
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


def phase_slice(dev, card, tmp, pages):
    """The DB slice. Returns the main-path run's K1 launches and the seeded
    CRNN's .pt, which the PSE slice reads too."""
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import cc_label, runmax

    det_cfg, rec_cfg = DET_CFG, REC_CFG
    reps = 5
    det_pt, rec_pt, margin = seeded_checkpoints(tmp, det_cfg, rec_cfg, pages)

    t0 = time.perf_counter()
    ocr_cpu = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device="cpu")
    cpu = flat(ocr_cpu.run_many(pages))
    cpu_s = time.perf_counter() - t0
    n_lines = sum(len(p) for p in cpu)
    check(n_lines > 0, "the seeded slice found no text boxes on the CPU")

    with float32_on_card():
        ocr32 = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev, dtype=torch.float32)
        launches0 = runmax.launches
        f32 = flat(ocr32.run_many(pages))
        check(runmax.launches > launches0, "the float32 slice launched no run-max kernel")
        pairs, f32_diff = compare_boxes(ocr_cpu.deter, ocr32.deter, pages, box_lists(cpu),
                                        box_lists(f32), margin)
        compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs)
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("slice-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off; %d pages of %dx%d, "
            "mean of %d runs) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
        say("slice-f32", "stages per %d-page call: %s on %s"
            % (PAGES, stage_breakdown(ocr32.deter, pages, "db", ocr32.recer), card))
    del ocr32, ocr_cpu

    ocr = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev)  # bf16 default
    runmax.launches = 0
    cc_label.alternations = 0
    torch.cuda.synchronize()
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
    say("slice-bf16", "%.3f pages/s, %.1f lines/s (%d pages of %dx%d, mean of %d runs) on %s"
        % (PAGES / secs, lines16 / secs, PAGES, H, W, reps, card))
    say("slice-bf16", "stages per %d-page call: %s on %s" % (PAGES, breakdown, card))
    say("slice-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    return launches, dict(det_pt=det_pt, rec_pt=rec_pt, margin=margin, cpu=cpu, bf16=bf16,
                          pages_per_s=PAGES / secs, f32_diff=f32_diff)


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


def phase_pse(dev, card, tmp, pages, rec_pt):
    """The PSE slice: det_r50_pse.yml + the DB slice's CRNN through
    OCRer.run_many. Returns the main-path run's (K1, K2) launches."""
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import propagate, runmax
    from pytorchocr_tpu_torch.utils.seeded import text_like_pse_head_

    det_cfg, rec_cfg, reps = PSE_CFG, REC_CFG, 3
    det_pt, margins = seeded_det(tmp, det_cfg, pages, text_like_pse_head_, SEED + 4)
    say("pse", "seeded PSE head (ResNet-50, FPN 256, PSEHead 256 -> 7): margins %s logits"
        % _fmt(margins))

    t0 = time.perf_counter()
    ocr_cpu = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device="cpu")
    cpu = flat(ocr_cpu.run_many(pages))
    cpu_s = time.perf_counter() - t0
    check(sum(len(p) for p in cpu) > 0, "the seeded PSE slice found no text boxes on the CPU")

    with float32_on_card():
        ocr32 = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev, dtype=torch.float32)
        before = runmax.launches, propagate.launches
        f32 = flat(ocr32.run_many(pages))
        check(runmax.launches > before[0] and propagate.launches > before[1],
              "the float32 PSE slice did not launch both kernels")
        pairs, _ = compare_boxes(ocr_cpu.deter, ocr32.deter, pages, box_lists(cpu),
                                 box_lists(f32), margins, tag="pse-f32", channels=range(7),
                                 components=True)
        compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs, tag="pse-f32")
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("pse-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off; %d pages of %dx%d, "
            "mean of %d runs) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
        say("pse-f32", "stages per %d-page call: %s on %s"
            % (PAGES, stage_breakdown(ocr32.deter, pages, "pse", ocr32.recer), card))
        say("pse-f32", "%s on %s" % (pse_expansion_report(ocr32.deter, pages), card))
    del ocr32, ocr_cpu

    ocr = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev)  # bf16 default
    runmax.launches = propagate.launches = 0
    torch.cuda.synchronize()
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
    say("pse-bf16", "%.3f pages/s, %.1f lines/s (%d pages of %dx%d, mean of %d runs) on %s"
        % (PAGES / secs, lines16 / secs, PAGES, H, W, reps, card))
    say("pse-bf16", "stages per %d-page call: %s on %s" % (PAGES, breakdown, card))
    say("pse-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    say("pse-bf16", "%s on %s" % (pse_expansion_report(ocr.deter, pages), card))
    return launches


def phase_pan(dev, card, tmp, pages):
    """The PAN det path: det_r18_pan.yml through Deter.run_batch. Returns the
    main-path run's K1 launches."""
    import cv2
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.ops import runmax
    from pytorchocr_tpu_torch.utils.seeded import text_like_pan_head_

    det_cfg, reps = PAN_CFG, 5
    det_pt, margins = seeded_det(tmp, det_cfg, pages, text_like_pan_head_, SEED + 5)
    say("pan", "seeded PAN head (ResNet-18, FPEM_FFM v2 128 x2, PANHead 128 -> 6): text and "
        "kernel margins %s logits" % _fmt(margins))
    imgs = [cv2.imread(p) for p in pages]
    deter_cpu = Deter(det_cfg, det_pt, device="cpu")
    cpu = box_lists(deter_cpu.run_batch(imgs))
    check(sum(len(p) for p in cpu) > 0, "the seeded PAN det found no text boxes on the CPU")

    with float32_on_card():
        deter32 = Deter(det_cfg, det_pt, device=dev, dtype=torch.float32)
        before = runmax.launches
        f32 = box_lists(deter32.run_batch(imgs))
        check(runmax.launches > before, "the float32 PAN det launched no run-max kernel")
        compare_boxes(deter_cpu, deter32, pages, cpu, f32, margins, tag="pan-f32",
                      channels=(0, 1), components=True)
        secs32, boxes32 = timed_runs(lambda: deter32.run_batch(imgs), reps)
        say("pan-f32", "%.3f pages/s, %.1f boxes/s (float32, TF32 off; %d pages of %dx%d, "
            "mean of %d runs) on %s" % (PAGES / secs32, boxes32 / secs32, PAGES, H, W, reps, card))
    del deter32, deter_cpu

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
    say("pan-bf16", "%.3f pages/s, %.1f boxes/s (%d pages of %dx%d, mean of %d runs) on %s"
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
               "backbone.layer3_block1", "backbone.layer4_block1", "neck")


def _int8_payloads(deter, pages):
    """The int8 payloads of INT8_STAGES (the stem, each stage's last block,
    the FPN's fused map) over `pages`, as int32 on the CPU."""
    import torch

    seen, hooks = {}, []
    mods = dict(deter.runner.model.named_modules())

    def keep(name):
        def hook(mod, inp, out):  # returns None: the module's output stays as it is
            seen[name] = out.q.to(torch.int32).cpu()
        return hook

    for name in INT8_STAGES:
        hooks.append(mods[name].register_forward_hook(keep(name)))
    try:
        deter.runner(_det_batch(deter, pages)[0])
    finally:
        for h in hooks:
            h.remove()
    return seen


def hmean(runs, refs):
    """hmean of two runs' boxes matched one to one by rectangle IoU >= 0.5
    (match_iou)."""
    matched, _ = match_iou(runs, refs)
    total = sum(len(p) for p in runs) + sum(len(p) for p in refs)
    return 2.0 * matched / total if total else 1.0


def phase_int8_slice(dev, card, pages, db):
    """The int8 DB slice on the DB slice's checkpoints `db` (phase_slice's).
    Returns the main-path run's (int8 conv, K1, requant) launches and the
    bf16 int8 OCRer."""
    import torch

    from pytorchocr_tpu_torch.deploy.infer_det import Deter
    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import int8_conv, requant, runmax
    from pytorchocr_tpu_torch.utils.weights import load_absmax

    det_cfg, rec_cfg, reps = DET_CFG, REC_CFG, 5
    args = (det_cfg, db["det_pt"], rec_cfg, db["rec_pt"])
    t0 = time.perf_counter()
    ocr_cpu = OCRer(*args, det_quant=True, device="cpu")
    cpu = flat(ocr_cpu.run_many(pages))  # calibrates on the first half of the pages
    cpu_s = time.perf_counter() - t0
    check(ocr_cpu.deter.runner.quant, "the int8 slice did not calibrate on the CPU")
    check(sum(len(p) for p in cpu) > 0, "the int8 slice found no text boxes on the CPU")
    cpu_state = _absmax_state(ocr_cpu.deter.runner.model)

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
        q_cpu, q_gpu = _int8_payloads(ocr_cpu.deter, pages), _int8_payloads(ocr32.deter, pages)
        report = []
        for name in INT8_STAGES:
            d = (q_cpu[name] - q_gpu[name]).abs()
            report.append("%s %d of %d (%.4f%%, %d by one, at most %d)" % (
                name, int((d > 0).sum()), d.numel(), 100.0 * float((d > 0).float().mean()),
                int((d == 1).sum()), int(d.max())))
        say("int8-f32", "with the CPU's calibration, int8 elements that differ from the CPU's: %s"
            % "; ".join(report))
        check(int((q_cpu["backbone.stem"] - q_gpu["backbone.stem"]).abs().max()) <= 1,
              "the stem's int8 output differs from the CPU's by more than a quantum")
        pairs, _ = compare_boxes(ocr_cpu.deter, ocr32.deter, pages, box_lists(cpu),
                                 box_lists(f32), db["margin"], tag="int8-f32",
                                 moved=2 * db["f32_diff"])
        compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs, tag="int8-f32")
        say("int8-f32", "card against CPU, both int8: hmean %.4f (rectangle IoU >= 0.5)"
            % hmean(f32, cpu))
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("int8-f32", "%.3f pages/s, %.1f lines/s (int8 det, float32 compute; %d pages of %dx%d, "
            "mean of %d runs) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
    del ocr32, ocr_cpu

    ocr = OCRer(*args, det_quant=True, device=dev)  # bf16 default; run_many calibrates
    int8_conv.launches = runmax.launches = requant.launches = 0
    torch.cuda.synchronize()
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
    say("int8-bf16", "%.3f pages/s, %.1f lines/s (int8 det; %d pages of %dx%d, mean of %d runs) "
        "against %.3f pages/s float bf16 (phase 5) on %s"
        % (PAGES / secs, lines / secs, PAGES, H, W, reps, db["pages_per_s"], card))
    say("int8-bf16", "stages per %d-page call: %s on %s"
        % (PAGES, stage_breakdown(ocr.deter, pages, "db", ocr.recer), card))
    say("int8-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    forward_report(ocr.deter.runner, deter_float.runner, batch, card)
    return launches, ocr


def forward_report(runner_q, runner_f, batch, card, rounds=10):
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
              (2, 24, 9, 64, 10, 3, 1, 1, 1, 1)]


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
        "and %d edge shapes (Cin 3 and 24, dilation 2, Cout 40, depthwise, groups 2, 1x1 Cin 16, "
        "byte loads at Cout 128, an input patch of Cin 24); max_abs_err %g"
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


def phase_cls(dev, card, tmp, pages, db):
    """The direction classifier on the DB slice (phase_slice's `db`): a
    seeded cls_mbv3small.yml, its fc made decisive on the CPU crops."""
    import cv2
    import numpy as np
    import torch

    from pytorchocr_tpu_torch.deploy.infer_cls import Clser
    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer, crop_lines
    from pytorchocr_tpu_torch.utils.seeded import decisive_cls_head_, seeded_init_

    parts = []
    for path, page in zip(pages, db["cpu"]):
        parts.extend(crop_lines(cv2.imread(path), [np.array(b).reshape(-1, 2) for b, _, _ in page]))
    clser = Clser(CLS_CFG, None, device="cpu")
    model = seeded_init_(clser.runner.model, torch.Generator().manual_seed(SEED + 7))
    x = torch.from_numpy(np.stack([clser._prep(c) for c in parts])).permute(0, 3, 1, 2)
    margin = decisive_cls_head_(model, x)
    cls_pt = os.path.join(tmp, "cls.pt")
    torch.save(model.state_dict(), cls_pt)
    args = (DET_CFG, db["det_pt"], REC_CFG, db["rec_pt"], CLS_CFG, cls_pt)
    ocr_cpu = OCRer(*args, device="cpu")
    cpu = flat(ocr_cpu.run_many(pages))
    p_cpu = ocr_cpu.clser.runner(np.stack([clser._prep(c) for c in parts])).float()
    reps = 5
    with float32_on_card():
        ocr32 = OCRer(*args, device=dev, dtype=torch.float32)
        f32 = flat(ocr32.run_many(pages))
        p_gpu = ocr32.clser.runner(np.stack([clser._prep(c) for c in parts])).float().cpu()
        diff = float((p_gpu - p_cpu).abs().max())
        near = ((p_cpu[:, 1] - 0.5).abs() <= 2 * diff).tolist()
        same = (p_gpu.argmax(1) == p_cpu.argmax(1)).tolist()
        check(all(s or n for s, n in zip(same, near)),
              "a cls label differs on the card at a crop far from p = 0.5")
        n180 = int((p_cpu.argmax(1) == 1).sum())
        say("cls-f32", "seeded cls (MobileNetV3 small x0.35 + ClsHead, fc decisive, nearest crop "
            "%.3g logits from a tie): %d crops, %d labelled 180; probs max |cuda - cpu| %.3g, labels "
            "equal on %d, %d within 2x that of 0.5" % (margin, len(parts), n180, diff, sum(same),
                                                       sum(near)))
        pairs, _ = compare_boxes(ocr_cpu.deter, ocr32.deter, pages, box_lists(cpu),
                                 box_lists(f32), db["margin"], tag="cls-f32")
        compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs, tag="cls-f32",
                      excused={i for i, n in enumerate(near) if n})
        secs32, lines32 = timed_runs(lambda: ocr32.run_many(pages), reps)
        say("cls-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off, with cls; %d pages of "
            "%dx%d, mean of %d runs) on %s" % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps,
                                                card))
    del ocr32, ocr_cpu
    ocr = OCRer(*args, device=dev)  # bf16 default
    ocr.run_many(pages)
    secs, lines = timed_runs(lambda: ocr.run_many(pages), reps)
    say("cls-bf16", "%.3f pages/s, %.1f lines/s (with cls; %d pages of %dx%d, mean of %d runs) "
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


def compare_boxes(deter_cpu, deter32, pages, cpu, f32, margin, tag="slice-f32", channels=(0,),
                  components=False, moved=None):
    """Boxes of a float32 det path on the card against the CPU run (`cpu`,
    `f32`: one list of flat boxes per page). The two runs' maps agree to
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
    batch, shapes = _det_batch(deter_cpu, pages)
    maps_gpu = deter32.runner(batch)["maps"].float()
    m_gpu = maps_gpu.cpu()[..., channels]
    m_cpu = deter_cpu.runner(batch)["maps"].float()[..., channels]
    diff = float((m_gpu - m_cpu).abs().max())
    thresh = deter_cpu.det_post_process_class.thresh
    flips = (m_gpu > thresh) != (m_cpu > thresh)
    near = (m_cpu - thresh).abs() <= 2 * diff
    check(bool((~flips | near).all()), "a pixel far from the threshold binarizes differently")
    flipped = flips.any(-1)
    post_gpu = deter32.det_post_process_class({"maps": maps_gpu}, shapes)
    post_cpu = deter_cpu.det_post_process_class({"maps": maps_gpu.cpu()}, shapes)
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


def compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs, tag="slice-f32", excused=()):
    """Texts of the float32 slice on the card against the CPU run. On the
    CPU's line crops (turned as the CPU's classifier turns them, where the
    slice has one), the argmax must agree at every step whose CPU top-2
    margin exceeds twice the largest CPU/card probability difference; then
    every equal box of compare_boxes must read the same on both, unless its
    line holds a step within that of a tie or is in `excused` (CPU lines
    whose cls label may differ)."""
    import cv2
    import numpy as np

    from pytorchocr_tpu_torch.deploy.run_ocr import crop_lines

    parts = []
    for path, page in zip(pages, cpu):
        parts.extend(crop_lines(cv2.imread(path), [np.array(b).reshape(-1, 2) for b, _, _ in page]))
    parts = ocr_cpu.turn_upright(parts)
    batch = np.stack([ocr32.recer._prep(im) for im in parts])
    p_gpu = ocr32.recer.runner(batch).float().cpu()
    p_cpu = ocr_cpu.recer.runner(batch).float()
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


def device_time(fn, call_s, sums=()):
    """Card time of one call of `fn` from a torch.profiler trace: the time of
    the kernels and copies on the card summed (work that overlaps counts
    twice), as a share of `call_s`, the same call's unprofiled wall time,
    the five kernels that take the most, the total of the kernels whose name
    holds each string of `sums`, and the port's own kernels with the records
    the trace holds of them (the tracer can drop some). Host-side op events,
    which carry their kernels' time too, and the user annotations that the
    profiler lays on the card's timeline (`Optimizer.step#...`, the span of
    the optimizer's launches) are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
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
TRAIN_PAGES, EVAL_PAGES, TRAIN_SIZE, TRAIN_BS, TRAIN_STEPS = 64, 8, 640, 16, 200


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


def train_parts(config, device, amp, schedule=None, wrap_loss=None):
    """A model with the trainer's seeded init, its optimizer (the LR
    schedule over `schedule`, (epochs, steps an epoch); by default phase
    11's) and train step; `wrap_loss` wraps the step's loss."""
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
                           input_transform=build_input_transform(spec), amp=amp)
    return model, opt, step


class Branches:
    """Which piece of each piecewise-linear function every element took in
    one run's model forward (relu's two; relu6's and hardtanh's three, so
    hard_swish's and hard_sigmoid's at -3 and 3; max_pool2d's argmax) and,
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
                if name in Branches.POOLS:
                    return state._pool(role, func, args, kwargs, replay)
                if loss and name in Branches.CLAMPS + ("abs",):
                    return state._kink(role, name, func, args, kwargs, replay)
                if loss and name in Branches.COMPARISONS:
                    return state._compare(role, func, args, kwargs, replay)
                if name.rstrip("_") in Branches.KINKS or (
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
                       loss_pieces=False):
    """The same train step on the CPU in float64 (model, input, labels and
    loss; the DB head's sigmoids stay float32, as the module computes them):
    the reference the card's float32 step is held to. The CPU's own float32
    step lands several times further from it than the card's (phase 11
    reports both), so the CPU's float32 is no reference. `select` replaces
    the loss's `select` (PSE/PAN: the masks it thresholds out of the
    predictions); `branches` (a recorded Branches) makes its forward, and
    with `loss_pieces` its loss, take the card's pieces."""
    import torch

    from pytorchocr_tpu_torch.losses import build_loss
    from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform, float_preds

    cpu = torch.device("cpu")
    model, opt, _ = train_parts(config, cpu, amp=False, schedule=schedule)
    model.double().train()
    if branches is not None:
        branches.wrap(model, replay=True)
    b = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
              for x in batch_to_device(batch, cpu))
    transform = build_input_transform(
        config["Global"].get("_device_normalize_spec", {}).get("Train"))
    x = b[0] if transform is None else transform(b[0])
    preds = model(x.double().permute(0, 3, 1, 2), data=b)
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
              loss_pieces=False):
    """One float32 train step through the trainer's step on `dev` from the
    seeded weights, TF32 on or off: (losses, gradients, state_dict after the
    update, parameters before it), on the CPU in float64. `branches` records
    the pieces of the piecewise-linear functions that its forward (and with
    `loss_pieces` its loss) takes (Branches), or with `replay` makes it take
    the recorded ones."""
    import torch

    from pytorchocr_tpu_torch.trainer import batch_to_device

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        wrap_loss = (lambda loss: branches.wrap_loss(loss, replay)) if loss_pieces else None
        model, _, step = train_parts(config, dev, amp=False, schedule=schedule,
                                     wrap_loss=wrap_loss)
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
# phases 12-13: cuDNN's float32 weight-gradient algorithms round more than
# the CPU's float32 (VGG's conv weights up to 324x the CPU float32 step's
# worst error in the leaf, with TF32 off), so a leaf's floor is also this
# share of its largest |g|: between the worst TF32-off reading of the error
# over a leaf's largest |g| and the least TF32-on one (CRNN 1.49e-2 and
# 4.42e-2 over five runs, classifier 5.48e-3 and 6.48e-2 over four, on an
# NVIDIA H100 80GB HBM3, 700 W)
ELEM_SCALE = 2.5e-2
# phases 14-15: a leaf's elementwise floor is this many times the CPU float32
# step's worst error in it. The deeper nets at bs 2 carry float32 rounding of
# 0.14-0.2 of a leaf's largest |g| in their layer3-4 weights, on the CPU as on
# the card, and the card's worst came to 1.43 (PSE) and 1.22 (PAN) times the
# CPU's; TF32 on, 24.1 and 6.5 times (on an NVIDIA H100 80GB HBM3, 700 W)
DEEP_FLOOR_X = 3.0


def db_zero_grad_leaves(g_ref):
    """DB's biases whose gradient is 0 up to rounding: the deconv1 biases,
    which feed a train-mode BN."""
    return {k for k in g_ref if k.endswith("deconv1.bias")}


def bn_fed_biases(g_ref):
    """Biases whose float64 gradient is under 1e-4 of their weight's: a
    conv's bias that feeds a train-mode BN, whose gradient is 0 up to
    rounding (the VGG and MobileNetV3 convs)."""
    return {k for k in g_ref if k.endswith(".bias") and k[:-4] + "weight" in g_ref
            and float(g_ref[k].norm()) < 1e-4 * float(g_ref[k[:-4] + "weight"].norm())}


def held_step(step, ref, floor, lr, skip=frozenset(), focus=None, rounding=False):
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
    gradient figures. With `rounding` the 2 lr bound also allows 1e-6 |p|,
    as the 1e-2 lr one does: a float32 parameter stepped by lr one way on
    the card and the other way in float64 lands 2 lr apart plus the float32
    rounding of p +- lr. `first` names the first parameter past its bound:
    its leaf, |diff| / lr, the two gradients and p before the update."""
    l_card, g_card, card_sd, p0 = step
    l_ref, g_ref, ref_sd = ref
    loss = max((abs(l_card[k] - l_ref[k]) / abs(l_ref[k]), k) for k in l_ref)
    worst, elem, focused = (0.0, ""), (0.0, ""), (0.0, "")
    leaves = []  # (elementwise error over the floor, name, over max |g| of the leaf)
    for k, g in g_ref.items():
        if k not in skip:
            rel = (float((g_card[k] - g).norm() / g.norm()), k)
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
        past = (near0 & (diff > 2 * lr + (1e-6 * p0[k].abs() if rounding else 0.0))) | (
            moved & ~near0)
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
                leaves=sorted(leaves, reverse=True))


def compare_f32_step(config, dev, batch, card, what="bs 2, %dx%d" % (TRAIN_SIZE, TRAIN_SIZE),
                     tag="train-f32", schedule=None, zero_grad=db_zero_grad_leaves,
                     focus=None, card_floors=False, explained=None, deep=False, select=None,
                     loss_pieces=False):
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
    reported beside it. With `deep` (phases 14-15) a leaf's relative-L2
    limit is the larger of GRAD_LIMIT and the CPU float32 step's own
    relative L2 in that leaf (ResNet-50's BN gradients at bs 2 carry more
    float32 rounding than that limit, on the CPU as on the card), and its
    floor DEEP_FLOOR_X times its CPU float32 error, and held_step gets
    `rounding`. `select` goes to the float64 step (f64_reference_step).
    The float64 step and the CPU float32 step (the floors) take the pieces
    of the piecewise-linear functions that the card's TF32-off forward took
    (Branches), and with `loss_pieces` those of its loss and its
    comparisons (phase 11: DB's OHEM cut, its L1's sign, its BCE's clamp);
    the elements where they would have taken another piece are counted and
    reported."""
    import torch

    name = tag.split("-")[0]
    branches = Branches()
    step = card_step(config, dev, batch, tf32=False, schedule=schedule, branches=branches,
                     loss_pieces=loss_pieces)
    m_ref, opt, l_ref, g_ref = f64_reference_step(config, batch, schedule, select, branches,
                                                  loss_pieces)
    ref = l_ref, g_ref, m_ref.state_dict()
    f64_flips, branches.flips = branches.report(), {}
    skip = zero_grad(g_ref)
    l_cpu, g_cpu32 = card_step(config, torch.device("cpu"), batch, tf32=False,
                               schedule=schedule, branches=branches, replay=True,
                               loss_pieces=loss_pieces)[:2]
    l_cpu = l_cpu["loss"]
    floor = {k: float((g - g_ref[k]).abs().max()) for k, g in g_cpu32.items()}
    rel_cpu = {k: float((g - g_ref[k]).norm() / g_ref[k].norm())
               for k, g in g_cpu32.items() if k not in skip}
    g_cpu = max(rel_cpu.values())
    limit = {k: max(GRAD_LIMIT, rel_cpu[k]) if deep else GRAD_LIMIT for k in rel_cpu}
    del g_cpu32
    lr = float(opt.lr_schedule(0))
    if card_floors:
        floor = {k: max(f, ELEM_SCALE * float(g_ref[k].abs().max())) for k, f in floor.items()}
    if deep:
        floor = {k: DEEP_FLOOR_X * f for k, f in floor.items()}
    got = held_step(step, ref, floor, lr, skip, focus, rounding=deep)
    control_step = card_step(config, dev, batch, tf32=True, schedule=schedule)
    control = held_step(control_step, ref, floor, lr, skip, focus, rounding=deep)
    l_card, g_card = step[:2]
    floor_name = ("floor (the larger of its CPU float32 worst error and %g of its largest |g|)"
                  % ELEM_SCALE if card_floors else "%g x CPU float32 worst error" % DEEP_FLOOR_X
                  if deep else "CPU float32 worst error")
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
        return max((float((g[k] - g_ref[k]).norm() / g_ref[k].norm()) / limit[k], k)
                   for k in limit)

    over, over_control = over_limit(step), over_limit(control_step)
    check(over[0] <= 1.0, "%s f32 step: gradient %s off by %.3g of its relative-L2 limit %.3g"
          % (name, over[1], over[0], limit[over[1]]))
    check(got["elem"][0] <= 1.0, "%s f32 step: gradient %s off by %.3g of its leaf's %s"
          % ((name,) + got["elem"][::-1] + (floor_name,)))
    check(got["outside"] == 0, "%s f32 step: %d parameters moved past their bound after the "
          "update; the first: %s" % (name, got["outside"], got["first"]))
    check(got["bn"] <= 1e-3, "%s f32 step: BN running statistics off by %.3g" % (name, got["bn"]))
    either = card_floors or deep
    check(over_control[0] > 1.0 or (either and control["elem"][0] > 1.0),
          "%s f32 step: the TF32 control's worst gradient is %.3g of its limit%s"
          % (name, over_control[0], " and elementwise within its floor (%.3g of it)"
             % control["elem"][0] if either else ""))
    say(tag, "one float32 step (%s, TF32 off) through the trainer's step on %s "
        "against the same step in float64 on the CPU: loss %.6f against %.6f (rtol 1e-4, each "
        "term too), gradients worst %.2e relative L2 (%s; limit %s) and elementwise at most "
        "%.3g of the leaf's %s (%s; limit 1), parameters within 1e-2 lr but %d of %d elements "
        "whose float64 gradient is within rounding of 0 (under that floor or 1e-6; within 2 lr "
        "= %.2e; the floors could be %.3g times smaller), BN running statistics worst %.2e of "
        "|v| + 1e-2; %d biases that feed a train-mode BN at gradient 0 on both"
        % (what, card, l_card["loss"], l_ref["loss"], got["grad"][0], got["grad"][1],
           "%.0e" % GRAD_LIMIT if not deep else "the larger of %.0e and the CPU float32 "
           "step's own in the leaf; the worst leaf at %.3g of its limit, %s" % (
               GRAD_LIMIT, over[0], over[1]),
           got["elem"][0], floor_name, got["elem"][1], got["excused"], got["total"],
           2 * lr, got["margin"], got["bn"], len(skip)))
    say(tag, "the control, the same step with TF32 on: loss %.6f (worst term %.2e "
        "relative), gradients worst %.2e relative L2 (%s) and elementwise %.3g of the "
        "floor, %d parameters past their bound, BN statistics worst %.2e; the CPU's own "
        "float32 step (a report): loss %.6f, gradients worst %.2e relative L2"
        % (control["value"], control["loss"][0], control["grad"][0], control["grad"][1],
           control["elem"][0], control["outside"], control["bn"], l_cpu, g_cpu))
    got["pieces"] = "float64 %s; CPU float32 %s" % (f64_flips, branches.report())
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


def loader_breakdown(config, label, n=16):
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

    from pytorchocr_tpu_torch.tools import eval as eval_cli
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools import train as train_cli
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
    compare_f32_step(config, dev, batches[0], card, loss_pieces=True)
    checkpoint_round_trip(config, dev, batches, tmp)

    # the entry point, as `python -m pytorchocr_tpu_torch.tools.train` runs it;
    # every K1 call of its evaluate is recorded and held to the plain version after
    with recorded_kernels() as rec:
        t0 = time.perf_counter()
        report = train_cli.run(argv)
        run_s = time.perf_counter() - t0
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
    eval_cli.run(eval_argv)
    metric = eval_cli.run(eval_argv)  # warm: cuDNN has seen the shapes
    say("train-eval", "tools.eval.run on the latest checkpoint, second call: hmean %.4f (the "
        "train run's %.4f), %.2f pages/s on %s" % (metric["hmean"], best["hmean"], metric["fps"],
                                                    card))

    say("train", "profiler, 4 train steps with their loader waits: %s on %s"
        % (profile_loop(config, dev, metric=False, sums=("reduce_kernel", "batch_norm")), card))
    say("train", "phase 11 took %.1f s" % (time.perf_counter() - t_phase))
    return k1, train_label, eval_label


REC_TRAIN_CFG = os.path.join(REPO, "configs", "rec", "rec_vgg_bilstm_ctc_synth.yml")
CLS_TRAIN_CFG = os.path.join(REPO, "configs", "cls", "cls_mbv3small_synth.yml")
# phases 12 and 13: drawn lines (train, eval), batch, steps of tools.train.run
LINES_TRAIN, LINES_EVAL, LINES_BS = 2560, 512, 128
LINES_STEPS = {"rec": 100, "cls": 800}
F32_BS = 8  # the float32-against-float64 step and the checkpoint round trip
# phase 12's convergence check, written down in PERF.md before the first run
# that checked it: one fixed batch of 128 drawn lines, no augmentation, bf16,
# Adam at a constant LR of 3e-3 as tests/test_overfit.py trains the JAX
# CRNN; greedy decoding must give back >= 120 of the 128 strings within
# 3,000 steps (read every 50)
OVERFIT_N, OVERFIT_HITS, OVERFIT_CAP, OVERFIT_EVERY = 128, 120, 3000, 50
OVERFIT_OPTIMIZER = {"base_lr": 3e-3, "optim": {"name": "Adam"}}
# phase 13's check, written down in PERF.md before the first run that
# checked it: the eval accuracy after LINES_STEPS["cls"] steps of the config as
# published. Fewer steps did not do (400: eval acc 0.5, one class for all):
# MobileNetV3's BN statistics (flax momentum 0.99, as in the JAX package)
# still hold 0.99^400 = 1.8% of their initial variance after 400 steps. At 500
# steps six runs read 0.7852-0.9453 (the loader's 8 threads draw other batches
# in every run) and one failed, with the loss still falling (0.36 to 0.25 over
# the last 200 steps); the run now takes 800 (40 epochs), the check unchanged
CLS_MIN_ACC = 0.8
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


def profile_loop(config, dev, metric=True, sums=(), steps=4):
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


def rec_overfit(config, dev, card, tmp):
    """Phase 12's convergence check at full width (module docstring), and
    the overfit model served from a training checkpoint directory."""
    import copy

    import torch

    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step
    from pytorchocr_tpu_torch.utils.config import save_config
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import save_model

    label = make_lines(os.path.join(tmp, "rec_overfit"), OVERFIT_N, SEED + 23)
    cfg = copy.deepcopy(config)
    cfg["Eval"]["dataset"]["label_file_list"] = [label]
    cfg["Eval"]["loader"]["batch_size_per_card"] = OVERFIT_N
    cfg["Optimizer"] = copy.deepcopy(OVERFIT_OPTIMIZER)
    batch_np = next(iter(build_dataloader(cfg, "Eval", get_logger(name="root"))[0]))
    batch = batch_to_device(batch_np, dev)
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    want = [t for t, _ in post.decode(batch_np[1])]
    model, opt, step = train_parts(cfg, dev, amp=True, schedule=(OVERFIT_CAP, 1))
    eval_step = make_eval_step(model, amp=True)
    curve, hits, done = [], 0, 0
    t0 = time.perf_counter()
    while done < OVERFIT_CAP and hits < OVERFIT_HITS:
        for _ in range(OVERFIT_EVERY):
            losses = step(batch)
        done += OVERFIT_EVERY
        got = [t for t, _ in post(eval_step(batch[0]))]
        hits = sum(g == w for g, w in zip(got, want))
        curve.append((done, float(losses["loss"]), hits))
    secs = time.perf_counter() - t0
    check(hits >= OVERFIT_HITS, "rec-overfit: %d of %d lines read back after %d steps (at least "
          "%d within %d)" % (hits, OVERFIT_N, done, OVERFIT_HITS, OVERFIT_CAP))
    say("rec-overfit", "one fixed batch of %d drawn lines (1-25 characters, no augmentation), "
        "bf16, Adam at LR %g: %d of %d strings read back after %d steps (threshold %d within "
        "%d), %.1f s (%.2f steps/s with a read every %d); loss and lines read every %d steps: "
        "%s on %s"
        % (OVERFIT_N, OVERFIT_OPTIMIZER["base_lr"], hits, OVERFIT_N, done, OVERFIT_HITS,
           OVERFIT_CAP, secs,
           done / secs, OVERFIT_EVERY, OVERFIT_EVERY,
           ", ".join("%d: %.3f %d" % c for c in curve[:: max(1, len(curve) // 12)]), card))
    out = os.path.join(tmp, "rec_overfit_out")
    save_model(model, opt, {"start_epoch": 1, "global_step": done, "best_model": {}}, out,
               prefix="best_accuracy")
    cfg_path = os.path.join(out, "config.yml")
    save_config(cfg, cfg_path)
    served = served_equals_eval("rec-overfit-serve", "rec", cfg_path,
                                os.path.join(out, "best_accuracy"), label, dev, card, OVERFIT_N,
                                torch.bfloat16)
    say("rec-overfit-serve", "the served texts give back %d of the %d strings"
        % (sum(g == w for g, w in zip(served, want)), OVERFIT_N))


def phase_lines_train(dev, card, tmp, kind):
    """Phase 12 (kind "rec": CRNN) or 13 (kind "cls": the direction
    classifier): the config as published on drawn lines."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.tools import eval as eval_cli
    from pytorchocr_tpu_torch.tools import train as train_cli
    from pytorchocr_tpu_torch.utils.config import load_config
    from pytorchocr_tpu_torch.utils.logging import get_logger

    t_phase = time.perf_counter()
    logger = get_logger(name="root")
    for h in logger.handlers:
        h.setLevel(logging.WARNING)
    rec = kind == "rec"
    cfg_file, shape = (REC_TRAIN_CFG, "1x32x320") if rec else (CLS_TRAIN_CFG, "3x48x192")
    lengths = (1, 25) if rec else (5, 25)  # cls: long enough that a turn shows
    train_label = make_lines(os.path.join(tmp, kind + "_train"), LINES_TRAIN, SEED + 31 + rec,
                             lengths, turn_half=not rec)
    eval_label = make_lines(os.path.join(tmp, kind + "_eval"), LINES_EVAL, SEED + 41 + rec,
                            lengths, turn_half=not rec)
    small = os.path.join(tmp, kind + "_train", "first.txt")
    with open(small, "w") as f:
        f.write("".join(open(train_label).readlines()[: 2 * F32_BS]))
    steps = LINES_STEPS[kind]
    epochs = steps // (LINES_TRAIN // LINES_BS)
    schedule = (epochs, LINES_TRAIN // LINES_BS)
    out = os.path.join(tmp, kind + "_out")
    argv = lines_argv(cfg_file, out, train_label, eval_label, epochs)
    config = lines_config(argv)
    ops_ms, _ = loader_breakdown(config, train_label, n=64)
    say(kind + "-loader", "host ms per line, one thread: %s (%s, %d drawn lines)"
        % (ops_ms, "RecAug with TIA" if rec else "RecAug without TIA, RandAugment (PIL)",
           LINES_TRAIN))
    batches = first_batches(config, 2, F32_BS, small)
    compare_f32_step(config, dev, batches[0], card, what="bs %d, %s" % (F32_BS, shape),
                     tag=kind + "-f32", schedule=schedule, zero_grad=bn_fed_biases,
                     focus="rnn." if rec else None, card_floors=True)
    if rec:
        ctc_on_card(dev)
        checkpoint_round_trip(config, dev, batches, tmp, tag="rec-ckpt", schedule=schedule)
        rec_overfit(config, dev, card, tmp)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = train_cli.run(argv)
    run_s = time.perf_counter() - t0
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
    if not rec:
        check(best["acc"] >= CLS_MIN_ACC, "cls-train: eval acc %.4f after %d steps, under %.2f"
              % (best["acc"], steps, CLS_MIN_ACC))

    ckpt = os.path.join(out, "best_accuracy")
    metric = eval_cli.run(argv + ["Global.checkpoints=%s" % ckpt])
    keys = ("acc", "norm_edit_dis") if rec else ("acc",)
    check(all(metric[k] == best[k] for k in keys), "%s-eval: tools.eval.run gives %s, the train "
          "run logged %s" % (kind, [metric[k] for k in keys], [best[k] for k in keys]))
    say(kind + "-eval", "tools.eval.run on best_accuracy: %s, equal to the train run's; %.1f "
        "lines/s (forward and sync, bs %d) on %s"
        % (", ".join("%s %.4f" % (k, metric[k]) for k in keys), metric["fps"],
           config["Eval"]["loader"]["batch_size_per_card"], card))
    served_equals_eval(kind + "-serve", kind, os.path.join(out, "config.yml"), ckpt, eval_label,
                       dev, card, config["Eval"]["loader"]["batch_size_per_card"], torch.float32)
    say(kind + "-train", "profiler, 4 iterations of the loop (loader wait, copy, step, "
        "per-step metric): %s on %s" % (profile_loop(config, dev), card))
    say(kind + "-train", "phase %d took %.1f s" % (12 if rec else 13,
                                                  time.perf_counter() - t_phase))


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
    """A copy of a PSE/PAN training config whose crops (and the GT makers'
    upscale target) are `side` square."""
    import copy

    config = copy.deepcopy(config)
    for op in config["Train"]["dataset"]["transforms"]:
        name = next(iter(op))
        if name == "RandomCropImgMask":
            op[name]["size"] = [side, side]
        elif name in ("MakePseGt", "MakePanGt"):
            op[name]["size"] = side
    return config


def step_flips(config, dev, batch, schedule):
    """The seeded model's train-mode forward in float32 on the card (TF32
    off) and in float64 on the CPU. Returns the pixels that the two put on
    different sides of the loss's thresholds (its `selections`: OHEM's cut,
    the kernel-sample mask, the IoU logs' binarisations), per selection; the
    IoU logs on the card's binarised maps (computed on the CPU from them and
    the batch's labels); a `select` that hands the loss the card's two
    masks, for the float64 reference step; and the float64 loss terms with
    the float64 run's own masks."""
    import torch

    from pytorchocr_tpu_torch.losses import basic, build_loss
    from pytorchocr_tpu_torch.losses.det_pse_loss import flipped_pixels
    from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform

    loss = build_loss(config["Loss"])
    transform = build_input_transform(
        config["Global"].get("_device_normalize_spec", {}).get("Train"))
    sel = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        model = train_parts(config, device, amp=False, schedule=schedule)[0].to(dtype).train()
        b = tuple(x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
                  for x in batch_to_device(batch, device))
        x = b[0] if transform is None else transform(b[0])
        with torch.no_grad(), float32_on_card():
            maps = model(x.to(dtype).permute(0, 3, 1, 2), data=b)["maps"].to(dtype)
        sel.append({k: v.cpu() for k, v in loss.selections({"maps": maps}, b).items()})
        del model
    with torch.no_grad():
        own = {k: float(v) for k, v in loss({"maps": maps}, b).items()}
    card = sel[0]
    gt_texts, masks = b[1], b[-1]
    gt_kernel = b[2][:, -1] if b[2].dim() == 4 else b[2]
    explained = {
        "iou_text": float(basic.iou_binary(card["text>0"].int(), gt_texts, masks)),
        "iou_kernel": float(basic.iou_binary(card["kernel>0"].int(), gt_kernel,
                                             masks * gt_texts)),
    }

    def select(texts, gt_texts, training_masks):
        return card["ohem"].to(texts.dtype), card["kernel_mask"].to(texts.dtype)

    return flipped_pixels(*sel), explained, select, own


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


def served_det_equals_eval(tag, config, cfg_path, ckpt, dev, card, channels):
    """Deter (deploy.infer_det) on the training checkpoint directory `ckpt`,
    float32 on the card, page by page over the config's eval pages, against
    the eval forward and post process of the same checkpoint (its own
    normalisation: /255 where the Runner multiplies by float32(1/255)): the
    same boxes on every page, but a box that holds, or lies in a text
    component that holds, a map pixel on the other side of the post
    process's threshold (on the maps of `channels`) in one of the two runs
    (compare_boxes's rule)."""
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
    with float32_on_card():
        deter = Deter(cfg_path, ckpt, device=dev, dtype=torch.float32)
        model = build_train_model(config, dev)
        load_model(config, model)
        eval_step = make_eval_step(model, build_input_transform(
            config["Global"].get("_device_normalize_spec", {}).get("Eval")))
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
    say(tag, "Deter (deploy.infer_det) on %s, float32 (TF32 off), page by page: %d boxes equal "
        "to the eval forward and post process's on the same checkpoint, %d without an equal, "
        "each holding or beside a map pixel that the two normalisations put on the other side "
        "of the threshold (%d such pixels over %d pages); %.2f pages/s served (host resize "
        "included) on %s" % (os.path.basename(ckpt), equal, excused, flipped, len(paths),
                             len(paths) / serve_s, card))


def phase_det_train(dev, card, tmp, kind, train_label, eval_label):
    """Phase 14 (kind "pse": det_r50_pse_synth.yml) or 15 ("pan":
    det_r18_pan_synth.yml), each as published, on phase 11's drawn pages.
    Returns the training eval's (K1, K2) launches."""
    import logging

    import numpy as np
    import torch

    from pytorchocr_tpu_torch.tools import eval as eval_cli
    from pytorchocr_tpu_torch.tools import program
    from pytorchocr_tpu_torch.tools import train as train_cli
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
    flips, explained, select, own = step_flips(small, dev, batches[0], schedule)
    what = ("bs 2, %dx%d%s; pixels on the other side of a loss threshold than in float64: %s, "
            "so the float64 step sums over the card's OHEM selection and kernel-sample mask" % (
                spec["f32_size"], spec["f32_size"],
                " (cut from 640 to keep the CPU's float64 step short)"
                if spec["f32_size"] != TRAIN_SIZE else "", flips))
    compare_f32_step(small, dev, batches[0], card, what=what, tag=kind + "-f32",
                     schedule=schedule, zero_grad=bn_fed_biases, explained=explained,
                     deep=True, select=select)
    say(kind + "-f32", "the float64 forward's loss terms with its own masks (a report): %s"
        % ", ".join("%s %.7f" % kv for kv in sorted(own.items())))
    checkpoint_round_trip(small, dev, batches, tmp, tag=kind + "-ckpt", schedule=schedule)

    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_kernels() as rec:
        t0 = time.perf_counter()
        report = train_cli.run(argv)
        run_s = time.perf_counter() - t0
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

    metric = eval_cli.run(argv + ["Global.checkpoints=%s" % os.path.join(out, "latest")])
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
    whole, emb = loss_ms(config, dev, first_batches(config, 1, spec["bs"], few)[0])
    say(kind + "-train", "the loss, forward and backward, on a train batch of %d at %dx%d: "
        "%.2f ms%s (CUDA events) on %s"
        % (spec["bs"], TRAIN_SIZE, TRAIN_SIZE, whole,
           "; the embedding loss alone %.2f ms" % emb if emb is not None else "", card))
    say(kind + "-train", "profiler, 4 train steps with their loader waits: %s on %s"
        % (profile_loop(config, dev, metric=False, sums=("batch_norm", "reduce_kernel")), card))
    say(kind + "-train", "phase %d took %.1f s" % (spec["phase"], time.perf_counter() - t_phase))
    return launches


def forbidden_modules():
    """Modules of JAX, flax or the JAX package that this process loaded: the
    port and this script import none of them."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "pytorchocr_tpu"))


STREAMED = ("back-to-back launches in one CUDA graph over rotating copies of the inputs and "
            "outputs that hold 4x the L2, CUDA events over the graph / launches (stream_ms)")


def main():
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

    dev = torch.device("cuda:0")
    card = card_line()
    say("device", "torch.cuda: %s; nvidia-smi: %s; torch %s, CUDA %s"
        % (torch.cuda.get_device_name(0), card, torch.__version__, torch.version.cuda))
    t0 = time.perf_counter()
    int32_rate = int32_ops_per_s()
    k1 = phase_kernels(dev, card, int32_rate)
    k2 = phase_propagate(dev, card, int32_rate)
    phase_front_half(dev)
    with tempfile.TemporaryDirectory() as tmp:
        pages = make_pages(tmp)
        db_k1, db = phase_slice(dev, card, tmp, pages)
        pse_k1, pse_k2 = phase_pse(dev, card, tmp, pages, db["rec_pt"])
        pan_k1 = phase_pan(dev, card, tmp, pages)
        (q8_conv, q8_k1, q8_rq), ocr_q8 = phase_int8_slice(dev, card, pages, db)
        q8 = phase_int8_conv(dev, card, ocr_q8, pages)
        rq = phase_requant(dev, card, ocr_q8, pages)
        del ocr_q8
        phase_cls(dev, card, tmp, pages, db)
        train_k1, train_label, eval_label = phase_train(dev, card, tmp)
        phase_lines_train(dev, card, tmp, "rec")
        phase_lines_train(dev, card, tmp, "cls")
        pse_train = phase_det_train(dev, card, tmp, "pse", train_label, eval_label)
        pan_train = phase_det_train(dev, card, tmp, "pan", train_label, eval_label)
    bad = forbidden_modules()
    check(not bad, "the port imported %s" % bad)
    k1_paths = {"DB": db_k1, "PSE": pse_k1, "PAN": pan_k1, "int8 DB": q8_k1,
                "train-eval": train_k1, "PSE-train-eval": pse_train[0],
                "PAN-train-eval": pan_train[0]}
    k2_paths = {"PSE": pse_k2, "PSE-train-eval": pse_train[1]}
    say("done", "main-path launches: K1 %d (%s), K2 %d (%s), int8_conv %d and requant %d "
        "(int8 DB); all phases %.1f s"
        % (sum(k1_paths.values()), ", ".join("%s %d" % kv for kv in k1_paths.items()),
           sum(k2_paths.values()), ", ".join("%s %d" % kv for kv in k2_paths.items()),
           q8_conv, q8_rq, time.perf_counter() - t0))

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
        replaces="pytorchocr_tpu/ops/quant.py:252", launches=q8_conv,
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
    ))
    kernels.append(dict(
        name="requant", route="cuda", source="pytorchocr_tpu_torch/csrc/requant.cu",
        replaces="pytorchocr_tpu/ops/quant.py:119", launches=q8_rq,
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
