"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface (one or more entry points). At first use it is compiled
with nvcc for Hopper (`sm_90a`) into a shared library under `_build/` (listed
in .gitignore) and loaded with ctypes. The library's file name carries a hash
of the source and the flags, so an edited source rebuilds. Nothing is built at
import time: the package imports on machines without a card or a compiler.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded = {}
build_log = {}  # name -> (seconds, nvcc's stderr with the -Xptxas -v report)
_started = {}  # name -> (nvcc process, its waiting thread, its result, source, temporary file)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: library name -> {symbol: argtypes}; the first symbol is the default
SIGNATURES = {
    "runmax": {"runmax_launch": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P]},
    "propagate": {"propagate_launch": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "int8_conv": {"int8_conv_launch": [_P] * 5 + [_I] * 17 + [_P],
                  "int8_conv_route": [_I] * 9},
    "requant": {
        "requant_quantize": [_P, _I, _P, _P, _L, _P],
        "requant_dequant": [_P, _P, _P, _I, _L, _P],
        "requant_add": [_P, _I, _P, _P, _I, _P, _P, _P, _L, _I, _P],
    },
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "pytorchocr_tpu_torch are built from source at first use"
        )
    return path


def _lib_path(name):
    src = os.path.join(SRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, digest[:16]))


def start(names):
    """Start nvcc on the libraries of `names` that are neither built nor
    building, one process per source, and return at once; `build` (and
    `load`) wait for them. Returns {name: library path}."""
    libs = {}
    for name in names:
        src, lib = _lib_path(name)
        libs[name] = lib
        if os.path.exists(lib) or name in _started:
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        done = {}

        def reap(proc=proc, done=done, t0=time.perf_counter()):
            done["err"] = proc.communicate()[1]
            done["secs"] = time.perf_counter() - t0  # nvcc's own time, whenever it is read

        waiter = threading.Thread(target=reap, daemon=True)
        waiter.start()
        _started[name] = (proc, waiter, done, src, tmp)
    return libs


def build(names):
    """Build the libraries of `names` that are not built yet, one nvcc per
    source, all started together (or earlier, by `start`), and wait for
    them. Returns {name: library path}."""
    libs = start(names)
    failed = []
    for name in names:
        if name not in _started:
            continue
        proc, waiter, done, src, tmp = _started.pop(name)
        waiter.join()
        if proc.returncode != 0:
            failed.append("nvcc failed on %s:\n%s" % (src, done["err"]))
            continue
        os.replace(tmp, libs[name])  # atomic: concurrent builders never see a partial file
        build_log[name] = (done["secs"], done["err"])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name, symbol=None):
    """Return the ctypes function `symbol` (default: the library's first) of
    kernel library `name`, building the library first if needed."""
    symbol = symbol or next(iter(SIGNATURES[name]))
    if (name, symbol) not in _loaded:
        fn = getattr(ctypes.CDLL(build([name])[name]), symbol)
        fn.argtypes = SIGNATURES[name][symbol]
        fn.restype = ctypes.c_int
        _loaded[name, symbol] = fn
    return _loaded[name, symbol]


def call(fn, device, *args):
    """Call the C entry point `fn` with `device` current. The device context
    is entered only when another card is current: it costs host time on
    every launch."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)
