"""Device-only times of other builds of the CUDA kernels beside the current
ones, on one card, in turns (the others, current, current, the others in
reverse).

  git archive <commit> pytorchocr_tpu_torch/csrc | tar -x -C OLD
  python -m pytorchocr_tpu_torch.compare_kernels OLD/pytorchocr_tpu_torch/csrc [DIR ...]

Run from the root of a checkout: it times with chip_smoke.kernel_ms, on
chip_smoke's 736x1280 and 184x320 text-like inputs (K1), its 736x1280
nested case (K2), the 29 int8 convs of a 4-page 736x1280 DB-ResNet18
forward (DB_INT8_CONVS, random int8 data), the stem of the same pages
turned portrait (PORTRAIT_INT8_CONVS) and the 45 depthwise int8 convs of
the MobileNetV3-small, MobileNetV3-large-0.5 and ShuffleNetV2 detectors'
4-page forwards (ZOO_DW_INT8_CONVS, bf16 output: int8_dwconv, and
int8_conv_direct in a build before it), and holds every build's outputs
against the plain PyTorch versions first. Times are chip_smoke.kernel_ms's
(torch.profiler's card durations of single launches, the L2 warm): a fair
old-against-new ratio; chip_smoke.stream_ms gives the bound's shares. Each DIR is named by its last
component and timed on whichever of runmax.cu, propagate.cu and
int8_conv.cu it holds; a DIR named probe* holds a build that skips work on
purpose (fewer rounds, say), which is timed and not checked. A runmax.cu
without the `scratch_ints` argument has the first port's C interface:
runmax_launch(vals, mask, out, prev, changed, H, W, axis, stream); an
int8_conv.cu without `out_bf16` the first one's, float32 output only:
int8_conv_launch(x, w, scale, bias, y, N, H, W, Cin, Cout, kh, kw, Ho, Wo,
sh, sw, ph, pw, dh, dw, groups, stream). For the int8 convs it prints each
shape's times and bound and each build's sum over each forward.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

_P, _I = ctypes.c_void_p, ctypes.c_int
FIRST_RUNMAX = [_P, _P, _P, _P, _P, _I, _I, _I, _P]  # the first port's runmax_launch
FIRST_INT8_CONV = [_P] * 5 + [_I] * 16 + [_P]  # float32 output only

# (Cin, H, W, Cout, k, stride, padding, calls) of the int8 convs of one
# 4-page 736x1280 DB-ResNet18 + FPN 256 + DBHead forward (chip_smoke phase 9)
DB_INT8_CONVS = [
    (3, 736, 1280, 64, 7, 2, 3, 1),  # stem
    (64, 184, 320, 64, 3, 1, 1, 4), (64, 184, 320, 128, 3, 2, 1, 1),  # layers 1-2
    (128, 92, 160, 128, 3, 1, 1, 3), (64, 184, 320, 128, 1, 2, 0, 1),
    (128, 92, 160, 256, 3, 2, 1, 1), (256, 46, 80, 256, 3, 1, 1, 3),  # layer 3
    (128, 92, 160, 256, 1, 2, 0, 1), (256, 46, 80, 512, 3, 2, 1, 1),  # layer 4
    (512, 23, 40, 512, 3, 1, 1, 3), (256, 46, 80, 512, 1, 2, 0, 1),
    (512, 23, 40, 256, 1, 1, 0, 1), (256, 46, 80, 256, 1, 1, 0, 1),  # FPN laterals
    (128, 92, 160, 256, 1, 1, 0, 1), (64, 184, 320, 256, 1, 1, 0, 1),
    (256, 23, 40, 64, 3, 1, 1, 1), (256, 46, 80, 64, 3, 1, 1, 1),  # FPN out convs
    (256, 92, 160, 64, 3, 1, 1, 1), (256, 184, 320, 64, 3, 1, 1, 2),  # out2, head conv1
]
# the stem of the same 4 pages turned portrait (1056x736, DB's resize keeps
# the short side at 736): 368-pixel output rows, no multiple of the tile;
# timed beside the forward, not in its sum
PORTRAIT_INT8_CONVS = [(3, 1056, 736, 64, 7, 2, 3, 1)]
# (Cin, H, W, Cout, k, stride, padding, calls) of the depthwise int8 convs
# (groups = Cin) of one 4-page 736x1280 forward of each int8 zoo detector
# that has them (chip_smoke phase 21; the int8_dwconv branch): 11, 15 and
# 19 calls
ZOO_DW_INT8_CONVS = {
    "MBv3-small": [
        (16, 368, 640, 16, 3, 2, 1, 1), (72, 184, 320, 72, 3, 2, 1, 1),
        (88, 92, 160, 88, 3, 1, 1, 1), (96, 92, 160, 96, 5, 2, 2, 1),
        (240, 46, 80, 240, 5, 1, 2, 2), (120, 46, 80, 120, 5, 1, 2, 1),
        (144, 46, 80, 144, 5, 1, 2, 1), (288, 46, 80, 288, 5, 2, 2, 1),
        (576, 23, 40, 576, 5, 1, 2, 2)],
    "MBv3-large-0.5": [
        (8, 368, 640, 8, 3, 1, 1, 1), (32, 368, 640, 32, 3, 2, 1, 1),
        (40, 184, 320, 40, 3, 1, 1, 1), (40, 184, 320, 40, 5, 2, 2, 1),
        (64, 92, 160, 64, 5, 1, 2, 2), (120, 92, 160, 120, 3, 2, 1, 1),
        (104, 46, 80, 104, 3, 1, 1, 1), (96, 46, 80, 96, 3, 1, 1, 2),
        (240, 46, 80, 240, 3, 1, 1, 1), (336, 46, 80, 336, 3, 1, 1, 1),
        (336, 46, 80, 336, 5, 2, 2, 1), (480, 23, 40, 480, 5, 1, 2, 2)],
    "SFv2": [
        (24, 184, 320, 24, 3, 2, 1, 1), (58, 184, 320, 58, 3, 2, 1, 1),
        (58, 92, 160, 58, 3, 1, 1, 3), (116, 92, 160, 116, 3, 2, 1, 2),
        (116, 46, 80, 116, 3, 1, 1, 7), (232, 46, 80, 232, 3, 2, 1, 2),
        (232, 23, 40, 232, 3, 1, 1, 3)],
}


def _load(dirs, tmp):
    """{name: {"runmax": (fn, first_interface), "propagate": fn,
    "int8_conv": (fn, first_interface)}} for the current sources and `dirs`,
    one nvcc per source, all started together."""
    from . import _kernels

    procs = []  # (name, kernel, source, library, nvcc process)
    for i, d in enumerate([_kernels.SRC_DIR] + dirs):
        name = "current" if i == 0 else os.path.basename(os.path.normpath(d))
        for kernel in ("runmax", "propagate", "int8_conv"):
            src = os.path.join(d, kernel + ".cu")
            if os.path.exists(src):
                lib = os.path.join(tmp, "lib%s_%d.so" % (kernel, i))
                procs.append((name, kernel, src, lib, subprocess.Popen(
                    [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    builds = {}
    for name, kernel, src, lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit("nvcc failed on %s:\n%s" % (src, err))
        with open(src) as f:
            text = f.read()
        fn = getattr(ctypes.CDLL(lib), kernel + "_launch")
        fn.restype = _I
        got = builds.setdefault(name, {})
        if kernel == "runmax":
            first = "scratch_ints" not in text
            fn.argtypes = FIRST_RUNMAX if first else _kernels.SIGNATURES["runmax"]["runmax_launch"]
            got[kernel] = (fn, first)
        elif kernel == "propagate":
            fn.argtypes = _kernels.SIGNATURES["propagate"]["propagate_launch"]
            got[kernel] = fn
        else:
            first = "out_bf16" not in text
            fn.argtypes = FIRST_INT8_CONV if first else _kernels.SIGNATURES["int8_conv"][
                "int8_conv_launch"]
            got[kernel] = (fn, first)
    return builds


def _cases(smoke, dev, stream):
    """(label, kernel, launch(build), out, want) of the timed cases."""
    import numpy as np
    import torch

    from .ops import propagate, runmax

    cases = []
    rng = np.random.RandomState(smoke.SEED)
    for h, w, n in ((smoke.H, smoke.W, 300), (184, 320, 20)):
        mask = torch.from_numpy(smoke.text_like_binary(rng, h, w, n)).to(dev)
        lbl = torch.where(mask, torch.arange(1, h * w + 1, dtype=torch.int32,
                                             device=dev).view(h, w), 0)
        out = torch.empty_like(lbl)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        for axis in (1, 0):
            prev = lbl.data_ptr() if axis == 0 else None
            fl = flag.data_ptr() if axis == 0 else None

            def go(build, lbl=lbl, mask=mask, out=out, axis=axis, prev=prev, fl=fl):
                fn, first = build["runmax"]
                rest = () if first else (None, 0)
                return fn(lbl.data_ptr(), mask.data_ptr(), out.data_ptr(), prev, fl, *rest,
                          lbl.shape[0], lbl.shape[1], axis, stream)

            want = runmax.segmented_runmax_ref(lbl.cpu(), mask.cpu(), axis)
            cases.append(("K1 %dx%d axis %d%s" % (h, w, axis, " with flag" if axis == 0 else ""),
                          "runmax", go, out, want))
    prng = np.random.RandomState(smoke.SEED + 3)
    for fill_only in (True, False):
        labels, mask = smoke.propagate_case(prng, smoke.H, smoke.W, fill_only, True)
        dl, dm = torch.from_numpy(labels).to(dev), torch.from_numpy(mask).to(dev)
        out = torch.empty_like(dl)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)

        def go(build, dl=dl, dm=dm, out=out, flag=flag, fill_only=fill_only):
            return build["propagate"](dl.data_ptr(), dm.data_ptr(), out.data_ptr(),
                                      flag.data_ptr(), dl.shape[0], dl.shape[1],
                                      int(fill_only), stream)

        want, _ = propagate.propagate_rounds_ref(dl.cpu(), dm.cpu(), fill_only)
        cases.append(("K2 %dx%d nested %s rule" % (smoke.H, smoke.W, "fill" if fill_only else "CC"),
                      "propagate", go, out, want))
    return cases + _int8_cases(smoke, dev, stream)


def _int8_cases(smoke, dev, stream):
    """The DB forward's int8 convs, each in float32 and in bf16 output (a
    first-interface build takes float32 only), and the zoo's depthwise
    convs in bf16; the case label carries the shape's call count and its
    bound, the case the forward it sums into (None: not summed)."""
    import numpy as np
    import torch

    from .ops import int8_conv

    convs = [(c, "DB-ResNet18", (torch.float32, torch.bfloat16), False) for c in DB_INT8_CONVS]
    convs += [(c, None, (torch.float32, torch.bfloat16), False) for c in PORTRAIT_INT8_CONVS]
    convs += [(c, model, (torch.bfloat16,), True) for model, shapes in ZOO_DW_INT8_CONVS.items()
              for c in shapes]
    cases = []
    rng = np.random.RandomState(smoke.SEED + 9)
    for (cin, h, w, cout, k, st, pad, calls), forward, dtypes, depthwise in convs:
        n, groups = smoke.PAGES, cin if depthwise else 1
        xq = torch.from_numpy(rng.randint(-127, 128, (n, cin, h, w)).astype(np.int8)).to(dev)
        xq = xq.contiguous(memory_format=torch.channels_last)
        wq = torch.from_numpy(rng.randint(-127, 128, (cout, k, k, cin // groups)).astype(np.int8))
        wq = wq.to(dev)
        scale = torch.from_numpy((rng.rand(cout) * 1e-3).astype(np.float32)).to(dev)
        ho, wo = int8_conv.out_size(h, w, k, k, st, pad, 1)
        for dtype in dtypes:
            y = torch.empty((n, ho, wo, cout), dtype=dtype, device=dev).permute(0, 3, 1, 2)
            bound = smoke.conv_bound(xq, wq, None, y, groups)
            want = int8_conv.int8_conv_ref(xq, wq, scale, None, st, pad, 1, groups, dtype).cpu()

            def go(build, xq=xq, wq=wq, scale=scale, y=y, st=st, pad=pad, k=k, ho=ho, wo=wo,
                   groups=groups, bf16=dtype == torch.bfloat16):
                fn, first = build["int8_conv"]
                if first and bf16:
                    return None  # the first interface writes float32 only
                rest = () if first else (int(bf16),)
                return fn(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), None, y.data_ptr(),
                          xq.shape[0], xq.shape[2], xq.shape[3], xq.shape[1], wq.shape[0], k, k,
                          ho, wo, st, st, pad, pad, 1, 1, groups, *rest, stream)

            label = "int8 conv %d %dx%d -> %d %dx%d/%d%s %s (%s; bound %.4f ms by %s)" % (
                cin, h, w, cout, k, k, st, " depthwise" if depthwise else "",
                "f32" if dtype == torch.float32 else "bf16",
                "%s x%d" % (forward, calls) if forward else "portrait, not in the forward",
                bound[0], bound[1])
            cases.append((label, "int8_conv", go, y, want, calls, bound[0], forward,
                          "f32" if dtype == torch.float32 else "bf16"))
    return cases


def main(dirs):
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda:0")
    card = smoke.card_line()
    stream = torch.cuda.current_stream(dev).cuda_stream
    forward = {}  # (build, forward, dtype) -> [device ms, bound ms] summed over its convs
    with tempfile.TemporaryDirectory() as tmp:
        builds = _load(dirs, tmp)
        for label, kernel, go, out, want, *weight in _cases(smoke, dev, stream):
            names = [n for n in builds if n != "current" and kernel in builds[n]
                     and go(builds[n]) is not None]
            if not names and not weight:  # the int8 convs are timed on the current build alone too
                continue
            for name in names + ["current"]:
                smoke.check(go(builds[name]) == 0, "%s, %s: launch failed" % (label, name))
                torch.cuda.synchronize()
                # a probe that skips work is timed, not checked
                if not name.startswith("probe"):
                    smoke.check(torch.equal(out.cpu(), want), "%s, %s: differs from the plain "
                                "version" % (label, name))
            times = {n: [] for n in names + ["current"]}
            for name in names + ["current", "current"] + names[::-1]:
                times[name].append(smoke.kernel_ms(lambda: go(builds[name]))[0])
            smoke.say("compare", "%s, device ms: %s on %s" % (label, "; ".join(
                "%s %s" % (n, " / ".join("%.4f" % t for t in ts)) for n, ts in times.items()),
                card))
            if weight and weight[2]:  # an int8 conv of a forward: (calls, bound ms, its name, dtype)
                calls, bound, name, dtype = weight
                for n, ts in times.items():
                    acc = forward.setdefault((n, name, dtype), [0.0, 0.0])
                    acc[0] += calls * sum(ts) / len(ts)
                    acc[1] += calls * bound
        for (n, name, dtype), (ms, bound) in forward.items():
            smoke.say("compare", "int8 conv, one %d-page %s forward%s, %s output, build %s: device "
                      "%.3f ms (mean of its turns), bound %.3f ms, %.0f%% of the bound on %s"
                      % (smoke.PAGES, name, "" if name == "DB-ResNet18" else " (its depthwise "
                         "convs)", dtype, n, ms, bound, 100.0 * bound / ms, card))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
