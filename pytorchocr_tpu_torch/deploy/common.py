"""Shared deploy runtime — port of deploy/common.py.

`Runner` is the counterpart of `JitRunner`: it takes the same raw HWC image
batches (uint8 or float, numpy), folds the normalisation into the device
forward (times float32(1/255), -mean, /std: `normalize`), and returns the
model's outputs as device tensors in the JAX layouts. It holds an explicit
device and a compute dtype: bf16 autocast on CUDA by default (as the JAX
deploy builds its models in bf16), float32 on the CPU. `calibrate` runs the
int8 PTQ calibration (ops/quant.py) over raw batches; after it the runner's
forwards run in int8 mode. Not ported: multi-card data parallel (A.14), AOT
export (A.14).
"""

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


class Runner:
    """Eval-mode forward with the input normalisation on the device; int8
    PTQ after `calibrate`."""

    def __init__(self, model, device="cuda", mean=None, std=None, dtype=None):
        self.device = resolve_device(device)
        self.quant = False
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.mean = self.std = None
        # 1/255 as a float32 multiplier, as the JAX JitRunner's eager
        # `_normalize` computes x * scale (deploy/common.py:104-108); training
        # divides by 255 instead, as JAX training does (trainer.py:81)
        self.scale = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=self.device)
        if mean is not None:
            self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device).view(1, 1, 1, -1)
            self.std = torch.tensor(std, dtype=torch.float32, device=self.device).view(1, 1, 1, -1)

    def load_state(self, path):
        """Load a .pt state_dict (tools/convert_flax_to_torch.py writes one)
        or the model of a training checkpoint directory (tools.train writes
        `latest/`, `best_accuracy/`: their `state.pt` holds {"model",
        "optimizer", "step"}), as the JAX deploy loads the directory that its
        training wrote (deploy/common.py:23-29). Every key must match."""
        self.model.load_state_dict(model_state(path, self.device), strict=True)
        return self

    def normalize(self, x):
        """A raw NHWC image tensor on the runner's device -> the float32
        input the model sees: (x * float32(1/255) - mean) / std, bit for bit
        the JAX JitRunner's eager `_normalize`."""
        x = x.to(torch.float32)
        if self.mean is not None:
            x = (x * self.scale - self.mean) / self.std
        return x

    def _forward(self, images):
        x = self.normalize(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last strides
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            return self.model(x)

    def calibrate(self, batches):
        """int8 PTQ calibration: record every activation absmax over the raw
        image batches `batches` (running max), in the runner's compute
        dtype; later calls run int8."""
        quant.calibrate(self.model, batches, forward=self._forward)
        self.quant = True

    @torch.inference_mode()
    def __call__(self, images):
        if not self.quant:
            return self._forward(images)
        with quant.quantized(self.model, "int8"):
            return self._forward(images)


def build_runner(config, model_path, device, **kwargs):
    """Architecture config + a .pt path or a training checkpoint directory ->
    a loaded Runner."""
    runner = Runner(build_model(config["Architecture"]), device, **kwargs)
    if model_path is not None:
        runner.load_state(model_path)
    return runner
