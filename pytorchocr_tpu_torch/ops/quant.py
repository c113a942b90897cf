"""Post-training int8 quantization (PTQ) for inference — port of
pytorchocr_tpu/ops/quant.py.

  * weights: per-output-channel symmetric int8 from the float32 weights
    (`QuantConv`, packed once per weight version);
  * activations: per-tensor symmetric int8, scales from a calibration pass
    (running absmax, held in `AbsMax` modules: non-persistent buffers, so
    `state_dict()` and float checkpoints are unchanged);
  * conv compute: int8 x int8 -> exact int32, dequantized in float32 and
    written in the compute dtype (`ops/int8_conv.py`: the hand-written
    kernel on the card, its plain version on the CPU);
  * the quantize, dequant and residual requantize passes: one elementwise
    pass each (`ops/requant.py`: the hand-written kernel on the card, its
    plain version on the CPU), as XLA fuses them in the JAX package.

The mode (None, "calibrate" or "int8") lives on the model: `quantized(model,
m)` sets it on every module that takes part (those with a `qmode`
attribute) for the duration of a `with` block. The JAX package keeps it in a
module-level variable read at trace time.

Only the JAX package's default-on regions are ported, as constants: the
backbone (`q8_backbone`), the FPN's fused map (`q8_fpn_fuse`) and the DB
head (`q8_head`) carry int8 activations; the FPN top-down adds
(`q8_fpn_topdown`, off in the JAX package) stay float. The `OCR_TPU_*`
environment switches and `QuantConvTranspose` are not carried
(ROADMAP.md A.15).
"""

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import int8_conv as _int8_conv
from . import requant

__all__ = [
    "QTensor", "AbsMax", "QuantConv", "quantized", "quantizing", "calibrate", "unsupported",
    "compute_dtype", "dequant", "qtensor_from", "qadd_act", "repeat_nearest", "qmaxpool",
]

MODES = (None, "calibrate", "int8")


def quantizing(module):
    """The module's quantization mode, or None in float mode and in training
    (PTQ is inference only, as in the JAX package)."""
    return None if module.training else module.qmode


@contextlib.contextmanager
def quantized(model, m="int8"):
    """Run `model`'s forwards inside the block in quantization mode `m`."""
    if m not in MODES:
        raise ValueError("quantization mode must be one of %s, got %r" % (MODES, m))
    mods = [mod for mod in model.modules() if hasattr(mod, "qmode")]
    prev = [mod.qmode for mod in mods]
    for mod in mods:
        mod.qmode = m
    try:
        yield model
    finally:
        for mod, p in zip(mods, prev):
            mod.qmode = p


def unsupported(model):
    """Why int8 PTQ of the detection `model` is not ported, or None. Each
    stage of the model (transform, backbone, neck, head) whose JAX int8
    regions the port carries says so with a true `int8_ported`: every
    detection backbone (ResNet, MobileNetV3, ShuffleNetV2, RepVGG in both
    forms), the FPN and FPEM_FFM (with or without the ASF attention) and the
    DB/PSE/PAN heads, so every config of configs/det passes. A module
    without a backbone (one block, a head) is not judged."""
    if not hasattr(model, "backbone"):
        return None
    for name, stage in model.named_children():
        if not getattr(stage, "int8_ported", False):
            return "int8 PTQ of the %s (%s) is not ported" % (name, type(stage).__name__)
    return None


@torch.inference_mode()
def calibrate(model, batches, forward=None):
    """Record every activation absmax over `batches` (running max across
    batches and across calls, as the JAX `calibrate` continues from existing
    `quant` variables). `forward(batch)` runs the model (default: `model`),
    e.g. with the deploy runner's normalisation and compute dtype. A model
    whose int8 path is not ported raises NotImplementedError
    (`unsupported`)."""
    reason = unsupported(model)
    if reason:
        raise NotImplementedError(reason)
    forward = model if forward is None else forward
    n = 0
    with quantized(model, "calibrate"):
        for batch in batches:
            forward(batch)
            n += 1
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    return model


def compute_dtype(x):
    """The dtype the surrounding forward computes in: autocast's where it is
    on for the device of `x` (a tensor or a QTensor), else float32 (the JAX
    modules' `dtype`)."""
    kind = (x.q if isinstance(x, QTensor) else x).device.type
    return torch.get_autocast_dtype(kind) if torch.is_autocast_enabled(kind) else torch.float32


# float32(1 / 127), exact as a Python float
_INV127 = (torch.tensor(1.0, dtype=torch.float32) / 127.0).item()


def _symmetric_qparams(absmax, eps=1e-6):
    """max(absmax, eps) / 127 as the JAX package computes it under jit: XLA
    rewrites the division by the constant 127 into a multiplication by its
    float32 reciprocal, which rounds differently for some absmax."""
    return torch.clamp_min(absmax.float(), eps) * _INV127


class QTensor(NamedTuple):
    """An int8 activation and its per-tensor symmetric scale: value =
    q * scale. `q` is an NCHW int8 tensor (channels_last on CUDA), `scale`
    a 0-d float32 tensor."""

    q: torch.Tensor
    scale: torch.Tensor


def dequant(x, dtype=torch.float32):
    """QTensor -> float tensor (identity on plain tensors)."""
    if isinstance(x, QTensor):
        return requant.dequant(x.q, x.scale, dtype)
    return x


def qtensor_from(x, absmax):
    """Quantize a float activation into a QTensor with a calibrated absmax."""
    scale = _symmetric_qparams(absmax)
    return QTensor(requant.quantize(x, scale), scale)


def qadd_act(a, b, absmax, act=None):
    """Residual add (+ optional relu, the one activation the ResNet blocks
    take) of two int8 or float operands, requantized with the calibrated
    output absmax in one pass. An int8 operand is dequantized to float32
    whatever the compute dtype. Returns a QTensor."""
    if act not in (None, F.relu, torch.relu):
        raise ValueError("qadd_act: act must be None or relu, got %r" % (act,))
    scale = _symmetric_qparams(absmax)
    (qa, sa), (qb, sb) = ((x.q, x.scale) if isinstance(x, QTensor) else (x, None) for x in (a, b))
    return QTensor(requant.add_act_quantize(qa, qb, sa, sb, scale, act is not None), scale)


def repeat_nearest(q, scale):
    """Nearest-neighbour upsample of an NCHW int8 payload by an integer
    scale: each output pixel copies one input pixel, so it stays int8
    (F.interpolate takes no int8 on CUDA). Works on the NHWC view, so a
    channels_last input gives a channels_last output."""
    s = int(scale)
    n, c, h, w = q.shape
    v = q.permute(0, 2, 3, 1)
    v = v[:, :, None, :, None, :].expand(n, h, s, w, s, c).reshape(n, h * s, w * s, c)
    return v.permute(0, 3, 1, 2)


def qmaxpool(x, window, stride, padding):
    """Max-pool an int8 QTensor's payload (max commutes with the positive
    scale). F.max_pool2d takes no int8 on CUDA, so it pools a float16 copy,
    which holds every int8 value exactly. The JAX version pads with -128,
    this one with -inf: the same result, since every window of a k/s/p pool
    with p < k holds a real pixel."""
    q = F.max_pool2d(x.q.to(torch.float16), window, stride, padding).to(torch.int8)
    return QTensor(q, x.scale)


class AbsMax(nn.Module):
    """A calibrated activation absmax: a 0-d float32 non-persistent buffer
    (outside `state_dict()`), raised by `observe` in calibrate mode. Reading
    it before any calibration raises, as int8 without calibration does in
    the JAX package. Named like the JAX `quant` leaf it mirrors
    (`act_absmax`, `out_absmax`, `fuse_absmax`, `mid_absmax`)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("value", torch.zeros((), dtype=torch.float32), persistent=False)
        self.calibrated = False

    def observe(self, *xs):
        for x in xs:
            self.value = torch.maximum(self.value, x.detach().abs().max().float())
        self.calibrated = True

    def set(self, value):
        """Take a calibrated value (the weight bridge's `flax_quant_to_torch`)."""
        self.value = torch.as_tensor(value, dtype=torch.float32, device=self.value.device).reshape(())
        self.calibrated = True

    def get(self):
        if not self.calibrated:
            raise RuntimeError("int8 mode needs a calibration first (quant.calibrate)")
        return self.value


class QuantConv(nn.Conv2d):
    """`nn.Conv2d` that runs int8 PTQ under a quantization mode; its
    parameters and `state_dict()` are the float conv's.

    float: the plain conv (a QTensor input is dequantized first);
    calibrate: records the input's absmax (`act_absmax`), then the float conv;
    int8: the input is an int8 QTensor (a producer already quantized it) or
      is quantized with the calibrated absmax; the weights are quantized per
      output channel with scale max|W| over (in, kh, kw) / 127 and packed as
      (out, kh, kw, in/groups) int8, once per weight version (an in-place
      update, a device move or a loaded state gives a new version); then
      `int8_conv` computes float32(int32 sum) * (s_x * s_w), plus the bias,
      and writes it in the compute dtype (JAX `quant.py:246-260`).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.qmode = None
        self.act_absmax = AbsMax()
        self._packed = None  # ((data_ptr, version, device), wq, s_w)

    def packed_weight(self):
        """(wq int8 (out, kh, kw, in/groups) contiguous, s_w float32 (out,))."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                s_w = _symmetric_qparams(w.detach().abs().amax(dim=(1, 2, 3)))
                # per-channel scales: the plain version, once per weight version
                wq = requant.quantize_ref(w.detach(), s_w.view(-1, 1, 1, 1))
                wq = wq.permute(0, 2, 3, 1).contiguous()
            self._packed = (key, wq, s_w)
        return self._packed[1], self._packed[2]

    def forward(self, x):
        qmode = quantizing(self)
        if qmode != "int8":
            x = dequant(x)
            if qmode == "calibrate":
                self.act_absmax.observe(x)
            return super().forward(x)
        if isinstance(x, QTensor):
            s_x, xq = x.scale, x.q
        else:
            s_x = _symmetric_qparams(self.act_absmax.get())
            if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
                # a channel slice (ShuffleNetV2's split): the quantize pass takes dense memory
                x = x.contiguous(memory_format=torch.channels_last if x.is_cuda
                                 else torch.contiguous_format)
            xq = requant.quantize(x, s_x)
        wq, s_w = self.packed_weight()
        if xq.device.type == "cuda":
            xq = xq.contiguous(memory_format=torch.channels_last)
        return _int8_conv.int8_conv(
            xq, wq, s_x * s_w, None if self.bias is None else self.bias.detach().float(),
            self.stride, self.padding, self.dilation, self.groups, out_dtype=compute_dtype(xq),
        )
