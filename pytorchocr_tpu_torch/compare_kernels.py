"""Device-only times of other builds of the CUDA kernels beside the current
ones, on one card, in turns (the others, current, current, the others in
reverse).

  git archive <commit> pytorchocr_tpu_torch/csrc | tar -x -C OLD
  python -m pytorchocr_tpu_torch.compare_kernels OLD/pytorchocr_tpu_torch/csrc [DIR ...]

Run from the root of a checkout: it times with chip_smoke.kernel_ms, on
chip_smoke's 736x1280 and 184x320 text-like inputs (K1) and its 736x1280
nested case (K2), and holds every build's outputs against the plain
PyTorch versions first. Each DIR is named by its last component and timed
on whichever of runmax.cu and propagate.cu it holds; a DIR named probe*
holds a build that skips work on purpose (fewer rounds, say), which is
timed and not checked. A runmax.cu without the `scratch_ints` argument has
the first port's C interface: runmax_launch(vals, mask, out, prev,
changed, H, W, axis, stream).
"""

import ctypes
import os
import subprocess
import sys
import tempfile

_P, _I = ctypes.c_void_p, ctypes.c_int
FIRST_RUNMAX = [_P, _P, _P, _P, _P, _I, _I, _I, _P]  # the first port's runmax_launch


def _build(src, lib):
    from . import _kernels

    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("nvcc failed on %s:\n%s" % (src, proc.stderr))
    return ctypes.CDLL(lib)


def _load(dirs, tmp):
    """{name: {"runmax": (fn, first_interface), "propagate": fn}} for the
    current sources and `dirs`."""
    from . import _kernels

    builds = {}
    for i, d in enumerate([_kernels.SRC_DIR] + dirs):
        name = "current" if i == 0 else os.path.basename(os.path.normpath(d))
        got = builds.setdefault(name, {})
        src = os.path.join(d, "runmax.cu")
        if os.path.exists(src):
            with open(src) as f:
                first = "scratch_ints" not in f.read()
            fn = _build(src, os.path.join(tmp, "librunmax_%d.so" % i)).runmax_launch
            fn.argtypes = FIRST_RUNMAX if first else _kernels.SIGNATURES["runmax"][1]
            fn.restype = _I
            got["runmax"] = (fn, first)
        src = os.path.join(d, "propagate.cu")
        if os.path.exists(src):
            fn = _build(src, os.path.join(tmp, "libpropagate_%d.so" % i)).propagate_launch
            fn.argtypes = _kernels.SIGNATURES["propagate"][1]
            fn.restype = _I
            got["propagate"] = fn
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
    return cases


def main(dirs):
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda:0")
    card = smoke.card_line()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        builds = _load(dirs, tmp)
        for label, kernel, go, out, want in _cases(smoke, dev, stream):
            names = [n for n in builds if n != "current" and kernel in builds[n]]
            if not names:
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


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
