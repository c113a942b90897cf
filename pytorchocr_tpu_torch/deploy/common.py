"""Shared deploy runtime — port of deploy/common.py.

`Runner` is the counterpart of `JitRunner`: it takes the same raw HWC image
batches (uint8 or float, numpy), folds the normalisation into the device
forward (times float32(1/255), -mean, /std: `normalize`), and returns the
model's outputs as device tensors in the JAX layouts. It holds an explicit
device and a compute dtype: bf16 autocast on CUDA by default (as the JAX
deploy builds its models in bf16), float32 on the CPU. `calibrate` runs the
int8 PTQ calibration (ops/quant.py) over raw batches; after it the runner's
forwards run in int8 mode.

Several cards (JAX common.py:37-55, 95-104, 132-145): given a list of
devices, or "cuda" with more than one visible card, the runner keeps one
replica of the model a device, pads each batch to a multiple of their count
by repeating its first image, runs an equal share on each replica and
gathers the outputs back in order on the first device. The JAX runner
shards the batch over a mesh of every local chip and takes OCR_TPU_DEPLOY_DP
to switch that off; here `CUDA_VISIBLE_DEVICES` pins a card a process, and
no environment switch is carried (ROADMAP.md A.15).

Export (JAX common.py:158-176): `export_program` traces the eval forward of
float32 NHWC images to the maps in the compute dtype with `torch.export`;
`save_program` / `load_program` write and read it as a .pt2 file
(deploy/export_model.py).
"""

import contextlib
import copy
import os

import numpy as np
import torch

from ..modeling import build_model
from ..ops import quant
from ..utils.save_load import model_state


def resolve_device(device):
    """torch.device for `device`; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but torch.cuda.is_available() is False" % device)
    return device


def padded_pow2_batch(arrays, combine=np.stack):
    """Pad a list of per-sample arrays to the next power-of-two count by
    repeating the first element, then combine along axis 0. Returns
    (batch, n_real); callers slice results back to n_real."""
    n = len(arrays)
    bs = 1 << (n - 1).bit_length()
    return combine(list(arrays) + [arrays[0]] * (bs - n), axis=0), n


def resolve_devices(device):
    """The runner's devices: a list or tuple as given, every visible card
    for a bare "cuda" when there are several, else the one device."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _gathered(outs, device, n):
    """The replicas' outputs (same trees) joined along the batch on
    `device`, cut to the first `n` rows."""
    first = outs[0]
    if torch.is_tensor(first):
        return torch.cat([t.to(device) for t in outs])[:n]
    if isinstance(first, dict):
        return {k: _gathered([o[k] for o in outs], device, n) for k in first}
    return type(first)(_gathered([o[i] for o in outs], device, n) for i in range(len(first)))


class Runner:
    """Eval-mode forward with the input normalisation on the device; int8
    PTQ after `calibrate`; one replica a device where there are several
    (module docstring)."""

    def __init__(self, model, device="cuda", mean=None, std=None, dtype=None):
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self.quant = False
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.model = self._placed(model, self.device)
        self.replicas = [self.model] + [self._placed(copy.deepcopy(model), d)
                                        for d in self.devices[1:]]
        self.mean = self.std = None
        # 1/255 as a float32 multiplier, as the JAX JitRunner's eager
        # `_normalize` computes x * scale (deploy/common.py:104-108); training
        # divides by 255 instead, as JAX training does (trainer.py:81)
        self.scale = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=self.device)
        if mean is not None:
            self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device).view(1, 1, 1, -1)
            self.std = torch.tensor(std, dtype=torch.float32, device=self.device).view(1, 1, 1, -1)

    @staticmethod
    def _placed(model, device):
        model = model.to(device).eval()
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    def _sync_replicas(self):
        """The first replica's weights and calibrated scales into the others."""
        if len(self.replicas) == 1:
            return
        state = self.model.state_dict()
        scales = {n: m for n, m in self.model.named_modules() if isinstance(m, quant.AbsMax)}
        for replica in self.replicas[1:]:
            replica.load_state_dict(state, strict=True)
            for n, m in replica.named_modules():
                if n in scales and scales[n].calibrated:
                    m.set(scales[n].value)

    def load_state(self, path):
        """Load a .pt state_dict (tools/convert_flax_to_torch.py writes one)
        or the model of a training checkpoint directory (tools.train writes
        `latest/`, `best_accuracy/`: their `state.pt` holds {"model",
        "optimizer", "step"}), as the JAX deploy loads the directory that its
        training wrote (deploy/common.py:23-29). Every key must match."""
        self.model.load_state_dict(model_state(path, self.device), strict=True)
        self._sync_replicas()
        return self

    def normalize(self, x):
        """A raw NHWC image tensor on the runner's device -> the float32
        input the model sees: (x * float32(1/255) - mean) / std, bit for bit
        the JAX JitRunner's eager `_normalize`."""
        x = x.to(torch.float32)
        if self.mean is not None:  # a replica on another card takes the constants there
            d = x.device
            x = (x * self.scale.to(d) - self.mean.to(d)) / self.std.to(d)
        return x

    def _forward(self, images, replica=0):
        model, device = self.replicas[replica], self.devices[replica]
        x = self.normalize(torch.from_numpy(np.ascontiguousarray(images)).to(device))
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last strides
        with torch.autocast(device.type, dtype=self.dtype, enabled=self.dtype != torch.float32):
            return model(x)

    def _split_forward(self, images):
        """Pad to a multiple of the replicas, an equal share each (all
        launched before any is gathered), the outputs joined in order."""
        k, n = len(self.replicas), len(images)
        pad = (-n) % k
        if pad:
            images = np.concatenate([images, np.repeat(images[:1], pad, axis=0)])
        share = len(images) // k
        outs = [self._forward(images[i * share:(i + 1) * share], i) for i in range(k)]
        return _gathered(outs, self.device, n)

    def calibrate(self, batches):
        """int8 PTQ calibration: record every activation absmax over the raw
        image batches `batches` (running max), in the runner's compute
        dtype, on the first replica (the whole batches, as one device
        would); the other replicas take its scales. Later calls run int8."""
        quant.calibrate(self.model, batches, forward=self._forward)
        self._sync_replicas()
        self.quant = True

    @torch.inference_mode()
    def __call__(self, images):
        forward = self._forward if len(self.replicas) == 1 else self._split_forward
        if not self.quant:
            return forward(images)
        with contextlib.ExitStack() as stack:
            for replica in self.replicas:
                stack.enter_context(quant.quantized(replica, "int8"))
            return forward(images)


class _ExportedForward(torch.nn.Module):
    """float32 NHWC images -> the model's maps (or its output tensor) in the
    compute dtype, as the JAX export's forward (deploy/export_model.py:
    `model.apply` of a bf16 model on `images.astype(float32)`); no
    normalisation, as there."""

    def __init__(self, model, dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = self.model(x)
        out = out["maps"] if isinstance(out, dict) else out
        return out.to(self.dtype)


def export_program(model, shape, device, dtype):
    """The eval forward of `model` (on `device`) for float32 NHWC images of
    `shape`, traced by torch.export: the counterpart of `export_serialized`
    (JAX common.py:166). Returns the ExportedProgram."""
    forward = _ExportedForward(model, dtype).to(device).eval()
    example = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(forward, (example,), strict=False)


def save_program(program, path):
    """Write an exported program as a .pt2 file; returns its size in bytes."""
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_program(path):
    """A callable of the .pt2 file's program (`load_serialized`, JAX
    common.py:174): images -> maps, on the device it was exported on."""
    return torch.export.load(path).module()


def build_runner(config, model_path, device, **kwargs):
    """Architecture config + a .pt path or a training checkpoint directory ->
    a loaded Runner."""
    runner = Runner(build_model(config["Architecture"]), device, **kwargs)
    if model_path is not None:
        runner.load_state(model_path)
    return runner
