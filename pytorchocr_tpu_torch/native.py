"""ctypes bindings of the native geometry library — the port's copy of
pytorchocr_tpu/native/__init__.py (the entry points the port calls:
`make_border_map` for MakeBorderMap, `iou_matrix` for the det metric).

The source, `csrc/geometry_kernels.cpp`, is host C++: it is compiled with g++
at first use into `_build/` (listed in .gitignore), the library's name
carrying a hash of the source, the flags it was built with and the host's
target (what -march=native resolves to), so a `_build/` made on another
host is never loaded here; then it is loaded with ctypes. Where
no g++ is found the callers take their numpy paths (`native_available()`).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "geometry_kernels.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()  # the loader's worker threads reach the first use together


def _flags_and_target():
    """The build flags, and g++'s resolution of -march=native on this host
    (every target option it sets); without -march=native where the
    toolchain rejects it (native/__init__.py:25)."""
    try:
        probe = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], check=True,
                               capture_output=True, text=True)
        return list(_FLAGS), probe.stdout
    except subprocess.CalledProcessError:
        return [f for f in _FLAGS if f != "-march=native"], ""


def _build():
    flags, target = _flags_and_target()
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode() + target.encode())
    lib = os.path.join(_BUILD_DIR, "libocrgeom_%s.so" % digest.hexdigest()[:16])
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    subprocess.run(["g++", *flags, _SRC, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _open()
    return _lib


def _open():
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError):
        return False
    f, i = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.iou_matrix.argtypes = [f, i, i, f, i, i, f]
    lib.iou_matrix.restype = None
    lib.make_border_map.argtypes = [f, i, i, ctypes.POINTER(ctypes.c_uint8), ctypes.c_double,
                                    i, i, f, f]
    lib.make_border_map.restype = None
    return lib


def native_available():
    return bool(_load())


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _lib_or_raise():
    lib = _load()
    if not lib:
        raise RuntimeError("native geometry unavailable (no g++)")
    return lib


def iou_matrix(gt_polys, det_polys):
    """gt_polys (G, P, 2), det_polys (D, Q, 2) float -> (G, D) IoU matrix;
    -1 flags a pair of two non-convex polygons for the caller to recompute
    with the numpy path. From native/__init__.py:117."""
    lib = _lib_or_raise()
    g = np.ascontiguousarray(gt_polys, dtype=np.float32)
    d = np.ascontiguousarray(det_polys, dtype=np.float32)
    out = np.empty((len(g), len(d)), np.float32)
    lib.iou_matrix(_fptr(g), len(g), g.shape[1], _fptr(d), len(d), d.shape[1], _fptr(out))
    return out


def make_border_map(polys, ignore_tags, shrink_ratio, canvas, mask):
    """Whole-sample MakeBorderMap inner loop: fmax the normalized inverse
    distance field of every non-ignored polygon into `canvas` (values in
    [0, 1]) and set `mask` over the dilated band. polys (N, P, 2);
    canvas/mask float32 (H, W), updated in place. From native/__init__.py:148."""
    lib = _lib_or_raise()
    p = np.ascontiguousarray(polys, dtype=np.float32)
    ig = np.ascontiguousarray(ignore_tags, dtype=np.uint8)
    if not (canvas.dtype == np.float32 and canvas.flags.c_contiguous
            and mask.dtype == np.float32 and mask.flags.c_contiguous):
        raise ValueError("canvas and mask must be C-contiguous float32")
    h, w = canvas.shape
    lib.make_border_map(
        _fptr(p), len(p), p.shape[1] if len(p) else 0,
        ig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        float(shrink_ratio), h, w, _fptr(canvas), _fptr(mask),
    )
