#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pytorchocr_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, one line each, any failure ends the run with a non-zero exit:
  1. device report and the build of the hand-written kernels (nvcc, sm_90a);
  2. the run-max kernel (K1) against its plain PyTorch version, exactly, on
     both axes at 736x1280 (random and text-like), 4096x256 and 64x20000,
     with both times at 736x1280;
  3. the DB front half on the card against the CPU run of the port's plain
     path on a 736x1280 map of rectangles, L and U shapes;
  4. the slice: OCRer.run_many at full width (DB-ResNet18 + FPN 256, CRNN VGG
     v1 x1.0 + BiLSTM 256 + CTC over 6,624 classes) with seeded weights on 4
     synthetic 736x1280 pages: float32 on the card (TF32 off) must equal the
     CPU run, boxes and texts on every page; only a box that holds a pixel
     within rounding of the threshold, or a line with a CTC step within
     rounding of a tie, may differ (compare_boxes, compare_texts). It is
     timed. Then the bf16 default is the main-path run whose kernel launches
     are counted; it is timed and reported against float32 by box IoU.
The line before the last is {"kernels": [...]}, the last one the contract
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


def phase_kernels(dev, card):
    import numpy as np
    import torch

    from pytorchocr_tpu_torch import _kernels
    from pytorchocr_tpu_torch.ops import runmax

    t0 = time.perf_counter()
    _kernels.load("runmax")
    if "runmax" in _kernels.build_log:
        secs, log = _kernels.build_log["runmax"]
        regs = " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "registers" in ln)
        say("build", "runmax.cu built by nvcc (sm_90a) in %.2f s; ptxas: %s" % (secs, regs))
    else:
        say("build", "runmax.cu loaded from an earlier build in %.2f s" % (time.perf_counter() - t0))

    rng = np.random.RandomState(SEED)
    cases = {
        "736x1280 random": (rng.rand(H, W) > 0.5),
        "736x1280 text-like": text_like_binary(rng, H, W, 300),
        "4096x256 tall": (rng.rand(4096, 256) > 0.4),
        "64x20000 long": (rng.rand(64, 20000) > 0.4),
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

    # times at 736x1280 on a labelled text-like map: one alternation's inputs
    mask = torch.from_numpy(cases["736x1280 text-like"]).to(dev)
    idx = torch.arange(1, H * W + 1, dtype=torch.int32, device=dev).view(H, W)
    lbl = torch.where(mask, idx, 0)
    times = {}
    for axis in (1, 0):
        times[axis] = (
            cuda_ms(lambda: runmax.segmented_runmax(lbl, mask, axis)),
            cuda_ms(lambda: runmax.segmented_runmax_ref(lbl, mask, axis)),
        )
    say("K1", "segmented_runmax == plain on both axes at %s; max_abs_err %d"
        % (", ".join(shapes), max_err))
    for axis in (1, 0):
        say("K1", "736x1280 axis %d: kernel %.4f ms, plain %.4f ms on %s"
            % ((axis,) + times[axis] + (card,)))
    ms = (times[0][0] + times[1][0]) / 2
    plain = (times[0][1] + times[1][1]) / 2
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain}


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
    det_imgs = np.concatenate([deter._preprocess(cv2.imread(p))[0] for p in pages])
    x = torch.from_numpy(det_imgs).float()
    x = ((x / 255.0 - deter.runner.mean) / deter.runner.std).permute(0, 3, 1, 2)
    dark = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) < 128 for im in det_imgs])
    margin = text_like_db_head_(model, x, dark)
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


def flat(result):
    return [[(b.reshape(-1).tolist(), t, p) for b, t, p in page] for page in result]


def timed_runs(ocr, pages, reps=5):
    """Mean seconds of `reps` run_many calls on `pages` (after the first,
    untimed call) and the lines found per call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        lines = sum(len(p) for p in ocr.run_many(pages))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, lines


def phase_slice(dev, card):
    import torch

    from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
    from pytorchocr_tpu_torch.ops import cc_label, runmax

    det_cfg, rec_cfg = DET_CFG, REC_CFG
    reps = 5
    with tempfile.TemporaryDirectory() as tmp:
        pages = make_pages(tmp)
        det_pt, rec_pt, margin = seeded_checkpoints(tmp, det_cfg, rec_cfg, pages)

        t0 = time.perf_counter()
        ocr_cpu = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device="cpu")
        cpu = flat(ocr_cpu.run_many(pages))
        cpu_s = time.perf_counter() - t0
        n_lines = sum(len(p) for p in cpu)
        check(n_lines > 0, "the seeded slice found no text boxes on the CPU")

        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ocr32 = OCRer(det_cfg, det_pt, rec_cfg, rec_pt, device=dev, dtype=torch.float32)
        launches0 = runmax.launches
        f32 = flat(ocr32.run_many(pages))
        check(runmax.launches > launches0, "the float32 slice launched no run-max kernel")
        pairs = compare_boxes(ocr_cpu, ocr32, pages, cpu, f32, margin)
        compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs)
        secs32, lines32 = timed_runs(ocr32, pages, reps)
        say("slice-f32", "%.3f pages/s, %.1f lines/s (float32, TF32 off; %d pages of %dx%d, "
            "mean of %d runs) on %s; the cpu's first call %.1f s"
            % (PAGES / secs32, lines32 / secs32, PAGES, H, W, reps, card, cpu_s))
        say("slice-f32", "stages per %d-page call: %s on %s"
            % (PAGES, stage_breakdown(ocr32, pages), card))
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
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
        secs, _ = timed_runs(ocr, pages, reps)
        breakdown = stage_breakdown(ocr, pages)
        busy = device_time(ocr, pages, secs)
    say("slice-bf16", "main path: runmax.launches %d, alternations %d (%.1f per page); "
        "first call %.3f s on %s" % (launches, alts, alts / PAGES, first_s, card))
    say("slice-bf16", "bf16 against the float32 run on the card (a report, not a check): "
        "%d lines; %d match an f32 box at IoU >= 0.5, %d of them with the f32 text"
        % (lines16, matched, same_text))
    say("slice-bf16", "%.3f pages/s, %.1f lines/s (%d pages of %dx%d, mean of %d runs) on %s"
        % (PAGES / secs, lines16 / secs, PAGES, H, W, reps, card))
    say("slice-bf16", "stages per %d-page call: %s on %s" % (PAGES, breakdown, card))
    say("slice-bf16", "profiler, one %d-page call: %s on %s" % (PAGES, busy, card))
    return launches


def _det_batch(deter, pages):
    import cv2
    import numpy as np

    pre = [deter._preprocess(cv2.imread(p)) for p in pages]
    return (np.concatenate([p[0] for p in pre]), np.concatenate([p[1] for p in pre]))


def compare_boxes(ocr_cpu, ocr32, pages, cpu, f32, margin):
    """Boxes of the float32 slice on the card against the CPU run. The prob
    maps of the two agree to rounding, so a pixel whose probability lies
    within that rounding of the threshold may binarize differently and
    change the boxes of its component. Checked: every pixel that binarizes
    differently lies within twice the largest map difference of the
    threshold; on identical maps the card's postprocess (the run-max
    kernel) gives the CPU's boxes exactly; and on every page each box is
    equal to one of the other run's, except a box whose bounding rectangle
    holds such a pixel. `margin` is the seeded DB head's distance of the
    nearest pixel to the threshold, in logits. Returns the equal boxes as
    (page, cpu line, card line) triples, lines counted over all pages."""
    import numpy as np
    import torch

    batch, shapes = _det_batch(ocr_cpu.deter, pages)
    maps_gpu = ocr32.deter.runner(batch)["maps"].float()
    m_gpu = maps_gpu.cpu()[..., 0]
    m_cpu = ocr_cpu.deter.runner(batch)["maps"].float()[..., 0]
    diff = float((m_gpu - m_cpu).abs().max())
    thresh = ocr_cpu.deter.det_post_process_class.thresh
    flipped = (m_gpu > thresh) != (m_cpu > thresh)
    near = (m_cpu - thresh).abs() <= 2 * diff
    check(bool((~flipped | near).all()), "a pixel far from the threshold binarizes differently")
    post_gpu = ocr32.deter.det_post_process_class({"maps": maps_gpu}, shapes)
    post_cpu = ocr_cpu.deter.det_post_process_class({"maps": maps_gpu.cpu()}, shapes)
    for i, (a, b) in enumerate(zip(post_gpu, post_cpu)):
        check(torch.equal(torch.from_numpy(a["points"]), torch.from_numpy(b["points"])),
              "page %d: on the same map, cuda postprocess boxes != cpu" % i)

    pairs, excused, flips = [], 0, []
    base_cpu = base_gpu = 0
    height, width = m_cpu.shape[1:]
    for i, (page_gpu, page_cpu) in enumerate(zip(f32, cpu)):
        ys, xs = np.nonzero(flipped[i].numpy())
        src_h, src_w = shapes[i][0], shapes[i][1]
        flip_xy = np.stack([xs * src_w / width, ys * src_h / height], axis=1)  # page pixels
        flips.append(len(flip_xy))
        unused = {}
        for j, row in enumerate(page_gpu):
            unused.setdefault(tuple(row[0]), []).append(j)
        for j, row in enumerate(page_cpu):
            left = unused.get(tuple(row[0]))
            if left:
                pairs.append((i, base_cpu + j, base_gpu + left.pop(0)))
            else:
                check(_holds_flip(row[0], flip_xy), "page %d: cpu box %s has no equal on the "
                      "card and no pixel binarized differently" % (i, row[0]))
                excused += 1
        for key, left in unused.items():
            for _ in left:
                check(_holds_flip(list(key), flip_xy), "page %d: card box %s has no equal on "
                      "the cpu and no pixel binarized differently" % (i, list(key)))
                excused += 1
        base_cpu += len(page_cpu)
        base_gpu += len(page_gpu)
    gap = float((m_cpu - thresh).abs().min())
    say("slice-f32", "DB maps max |cuda - cpu| %.3g; nearest cpu pixel %.3g from the threshold "
        "(seeded head margin %.3g logits); pixels binarized differently per page %s, all within "
        "2x that of the threshold; on the same maps the cuda postprocess boxes == cpu on all %d "
        "pages" % (diff, gap, margin, flips, len(pages)))
    say("slice-f32", "cuda float32 (TF32 off) vs cpu float32: %d of %d cpu boxes equal on the card "
        "(%d card boxes); %d boxes without an equal, each holding a pixel binarized differently"
        % (len(pairs), base_cpu, base_gpu, excused))
    return pairs


def _holds_flip(points, flip_xy):
    """Whether the bounding rectangle of a box (flat x, y list), one pixel
    wider on each side, holds one of the points `flip_xy` (K, 2)."""
    import numpy as np

    pts = np.asarray(points, np.float64).reshape(-1, 2)
    lo, hi = pts.min(0) - 1, pts.max(0) + 1
    return bool(((flip_xy >= lo) & (flip_xy <= hi)).all(1).any())


def compare_texts(ocr_cpu, ocr32, pages, cpu, f32, pairs):
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
    say("slice-f32", "CTC probs max |cuda - cpu| %.3g; argmax equal at all %d decisive steps; "
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


def device_time(ocr, pages, call_s):
    """Card time of one run_many from a torch.profiler trace: the time of
    the kernels and copies on the card summed (work that overlaps counts
    twice), as a share of `call_s`, the same call's unprofiled wall time,
    and the five kernels that take the most. Host-side op events, which
    carry their kernels' time too, are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ocr.run_many(pages)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return "the trace holds no device time: not measured"
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    return "card busy %.1f ms of a %.1f ms call (%.1f%%); most: %s" % (
        busy_ms, call_s * 1e3, 100.0 * busy_ms / (call_s * 1e3),
        "; ".join("%s %.2f ms" % (e.key[:60], e.self_device_time_total / 1e3) for e in top),
    )


def stage_breakdown(ocr, pages):
    """Host-clock stage times of one run_many, each ending in a sync; the
    DB front half alone (the device part of db_post) is timed once more
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

    deter = ocr.deter
    imgs = timed("decode", lambda: [cv2.imread(p) for p in pages])
    pre = timed("det_pre", lambda: [deter._preprocess(im) for im in imgs])
    batch, _ = padded_pow2_batch([p[0] for p in pre], combine=np.concatenate)
    shapes, _ = padded_pow2_batch([p[1] for p in pre], combine=np.concatenate)
    maps = timed("det_forward", lambda: deter.runner(batch))
    post_cls = deter.det_post_process_class
    probs = maps["maps"][..., 0].float()
    timed("db_front_half", lambda: [
        db_front_half(probs[i], post_cls.thresh, post_cls.max_candidates)
        for i in range(len(pages))
    ])
    post = timed("db_post (front half + host tail)", lambda: post_cls(maps, shapes))
    boxes = [post[i]["points"] for i in range(len(pages))]  # crop cost is order-free
    parts = timed("crops", lambda: [c for im, b in zip(imgs, boxes) for c in crop_lines(im, b)])
    timed("rec", lambda: ocr.recer.run_batch(parts))
    return ", ".join("%s %.1f ms" % (k, v * 1e3) for k, v in times.items())


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
    k1 = phase_kernels(dev, card)
    phase_front_half(dev)
    launches = phase_slice(dev, card)
    bad = [m for m in ("jax", "flax") if m in sys.modules]
    check(not bad, "the port imported %s" % bad)

    kernel = {
        "name": "segmented_runmax",
        "route": "cuda",
        "source": "pytorchocr_tpu_torch/csrc/runmax.cu",
        "replaces": "pytorchocr_tpu/ops/pallas_propagate.py:195",
        "launches": launches,
    }
    kernel.update(k1)
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
