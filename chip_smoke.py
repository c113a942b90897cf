#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pytorchocr_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, one line each, any failure ends the run with a non-zero exit:
  1. device report and the build of the hand-written kernels (nvcc, sm_90a,
     one nvcc per source, all started together);
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
     the text and kernel maps, then the bf16 run, counted and timed.
Each main-path run sets the kernels' counts to 0 just before it and reads
them just after. At the end it checks that no module of jax, flax or the
JAX package (pytorchocr_tpu) was loaded. The line before the last is
{"kernels": [...]} (device_ms, wrapper_ms, plain_ms, bound_ms, bound_by,
library_ms: null with its reason, launches), the last one the contract
{"ok": true, "device": {...}}. Without a card, or outside a checkout, it
exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PAGES = 4
H, W = 736, 1280
DET_CFG = os.path.join(REPO, "configs", "det", "det_r18_db.yml")
REC_CFG = os.path.join(REPO, "configs", "rec", "rec_vgg_bilstm_ctc.yml")
PSE_CFG = os.path.join(REPO, "configs", "det", "det_r50_pse.yml")
PAN_CFG = os.path.join(REPO, "configs", "det", "det_r18_pan.yml")


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
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split()[-1]
                t = totals.setdefault(name, [0.0, 0])
                t[0] += e.self_device_time_total
                t[1] += e.count
        if totals and min(n for _, n in totals.values()) >= 50:
            break
    check(bool(totals) and min(n for _, n in totals.values()) >= 10,
          "the profiler traces hold under 10 records of a kernel: kernel time not measured")
    means = [(name, us / 1e3 / n, n) for name, (us, n) in totals.items()]
    return sum(m[1] for m in means), ", ".join("%s %.4f x%d" % m for m in means)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


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
        else:
            say("build", "%s.cu loaded from an earlier build" % name)
    say("build", "all kernels ready in %.2f s" % (time.perf_counter() - t0))

    rng = np.random.RandomState(SEED)
    cases = {
        "736x1280 random": (rng.rand(H, W) > 0.5),
        "736x1280 text-like": text_like_binary(rng, H, W, 300),
        "184x320 text-like": text_like_binary(rng, 184, 320, 20),
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
    x = torch.from_numpy(det_imgs).float()
    x = ((x / 255.0 - deter.runner.mean) / deter.runner.std).permute(0, 3, 1, 2)
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
        pairs = compare_boxes(ocr_cpu.deter, ocr32.deter, pages, box_lists(cpu),
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
    return launches, rec_pt


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
        pairs = compare_boxes(ocr_cpu.deter, ocr32.deter, pages, box_lists(cpu), box_lists(f32),
                              margins, tag="pse-f32", channels=range(7), components=True)
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


def _det_batch(deter, pages):
    import cv2
    import numpy as np

    pre = [deter._preprocess(cv2.imread(p)) for p in pages]
    return (np.concatenate([p[0] for p in pre]), np.concatenate([p[1] for p in pre]))


def compare_boxes(deter_cpu, deter32, pages, cpu, f32, margin, tag="slice-f32", channels=(0,),
                  components=False):
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
    are counted apart. `margin` is the seeded head's distance of the
    nearest pixel to the threshold, in logits (one per map for PSE/PAN).
    Returns the equal boxes as (page, cpu line, card line) triples, lines
    counted over all pages."""
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

    pairs, excused, by_component, flip_counts = [], 0, 0, []
    base_cpu = base_gpu = 0
    height, width = m_cpu.shape[1:3]
    for i, (page_gpu, page_cpu) in enumerate(zip(f32, cpu)):
        ys, xs = np.nonzero(flipped[i].numpy())
        cell = np.array([shapes[i][1] / width, shapes[i][0] / height])  # page pixels per map pixel
        flip_lo = np.stack([xs, ys], axis=1) * cell
        flip_hi = flip_lo + cell if components else flip_lo
        flip_counts.append(len(flip_lo))
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
            nonlocal excused, by_component
            if _holds_flip(box, flip_lo, flip_hi):
                excused += 1
            elif _holds_flip(box, comp_lo, comp_hi):
                by_component += 1
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
        "(%d card boxes); %d boxes without an equal hold a pixel binarized differently%s"
        % (len(pairs), base_cpu, base_gpu, excused,
           "; %d more lie in a text component that holds one" % by_component
           if components else ""))
    return pairs


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


def compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs, tag="slice-f32"):
    """Texts of the float32 slice on the card against the CPU run. On the
    CPU's line crops, the argmax must agree at every step whose CPU top-2
    margin exceeds twice the largest CPU/card probability difference; then
    every equal box of compare_boxes must read the same on both, unless its
    line holds a step within that of a tie."""
    import cv2
    import numpy as np

    from pytorchocr_tpu_torch.deploy.run_ocr import crop_lines

    parts = []
    for path, page in zip(pages, cpu):
        parts.extend(crop_lines(cv2.imread(path), [np.array(b).reshape(-1, 2) for b, _, _ in page]))
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
        check(got == want or tied[k_cpu],
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


def device_time(fn, call_s):
    """Card time of one call of `fn` from a torch.profiler trace: the time of
    the kernels and copies on the card summed (work that overlaps counts
    twice), as a share of `call_s`, the same call's unprofiled wall time,
    the five kernels that take the most, and the port's own kernels with
    the records the trace holds of them (the tracer can drop some). Host-side
    op events, which carry their kernels' time too, are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return "the trace holds no device time: not measured"
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    ours = [e for e in events if "runmax_" in e.key or "propagate_tile" in e.key]
    return "card busy %.1f ms of a %.1f ms call (%.1f%%); most: %s; the port's kernels: %s" % (
        busy_ms, call_s * 1e3, 100.0 * busy_ms / (call_s * 1e3),
        "; ".join("%s %.2f ms" % (e.key[:60], e.self_device_time_total / 1e3) for e in top),
        "; ".join("%s %.3f ms over %d records" % (
            e.key.replace("(anonymous namespace)::", "").split("(")[0].split()[-1],
            e.self_device_time_total / 1e3, e.count) for e in ours) or "none traced",
    )


def stage_breakdown(deter, pages, kind, recer=None):
    """Host-clock stage times of one det (and, with `recer`, rec) pass over
    `pages`, each ending in a sync; the postprocess's device front half
    (`kind` db: db_front_half per page; pse, pan: the class's front_half,
    which holds the CC labelling and the expansion) is timed once more alone
    before the whole postprocess."""
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
        timed("rec", lambda: recer.run_batch(parts))
    return ", ".join("%s %.1f ms" % (k, v * 1e3) for k, v in times.items())


def forbidden_modules():
    """Modules of JAX, flax or the JAX package that this process loaded: the
    port and this script import none of them."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "pytorchocr_tpu"))


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
        db_k1, rec_pt = phase_slice(dev, card, tmp, pages)
        pse_k1, pse_k2 = phase_pse(dev, card, tmp, pages, rec_pt)
        pan_k1 = phase_pan(dev, card, tmp, pages)
    bad = forbidden_modules()
    check(not bad, "the port imported %s" % bad)
    say("done", "main-path launches: K1 %d (DB %d, PSE %d, PAN %d), K2 %d (PSE); all phases "
        "%.1f s" % (db_k1 + pse_k1 + pan_k1, db_k1, pse_k1, pan_k1, pse_k2,
                    time.perf_counter() - t0))

    kernels = []
    for name, source, replaces, launches, row in (
        ("segmented_runmax", "runmax.cu", 195, db_k1 + pse_k1 + pan_k1, k1),
        ("propagate_rounds", "propagate.cu", 41, pse_k2, k2),
    ):
        kernels.append(dict(
            name=name, route="cuda", source="pytorchocr_tpu_torch/csrc/" + source,
            replaces="pytorchocr_tpu/ops/pallas_propagate.py:%d" % replaces,
            launches=launches, max_abs_err=row["max_abs_err"], ms=row["device_ms"],
            device_ms=row["device_ms"], wrapper_ms=row["wrapper_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            library_note=NO_LIBRARY[name],
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
