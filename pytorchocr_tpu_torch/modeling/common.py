"""Shared model blocks — port of pytorchocr_tpu/modeling/common.py.

NCHW `nn.Module`s. Submodule names mirror the flax ones (`conv`, `bn`) so the
weight bridge (utils/weights.py) maps flax paths onto torch names one to one.

ConvBNAct carries the int8 PTQ flow of ops/quant.py: its conv is a
`QuantConv`, and with `emit_q` it hands its consumers an int8 QTensor under
int8 mode. `finish_residual` and `quant_max_pool` keep a ResNet block's
output int8. SEModule (PPLCNet's squeeze-excite) is below; DPModule, which
no config of the repo uses, waits for ROADMAP.md A.11.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from ..parallel import functional


def make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


ACTS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "hardswish": hard_swish,
    "hard_swish": hard_swish,
    "hsigmoid": hard_sigmoid,
    "hardsigmoid": hard_sigmoid,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "leakyrelu0.2": lambda x: F.leaky_relu(x, 0.2),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
}


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training-mode running statistics follow flax's
    BatchNorm (modeling/common.py:125): the batch mean and the *biased*
    batch variance (torch's own update takes the unbiased variance, n/(n-1)
    times larger), blended as `flax_momentum * running + (1 - flax_momentum)
    * batch` with flax_momentum = 1 - momentum (flax's 0.9 is torch's 0.1).

    Both statistics are the ones the normalisation itself used: the batch
    mean and 1/sqrt(var + eps) that F.batch_norm's kernel saves for its
    backward (torch._batch_norm_impl_index is the op F.batch_norm calls), so
    no reduction runs twice. That variance is the stable one; flax's default
    E[x^2] - E[x]^2 in float32 (use_fast_variance) differs from it only by
    the digits it loses where |mean| >> std. Eval mode is nn.BatchNorm2d's.

    Under a mesh with several ranks in its data group the statistics are
    the global batch's, as the JAX step's are (parallel/mesh.py:8-11 of
    the JAX package: the jitted step sees the whole batch): the sums of x
    and then of (x - mean)^2 go through parallel.functional.all_sum, which
    reduces by all-reduce alone (gloo has no all-gather of CUDA tensors),
    keeps the two-pass variance and carries the gradient across ranks."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if functional.data_world() > 1:
            return self._global_batch(x)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        with torch.no_grad():
            var = torch.clamp(invstd.pow(-2) - self.eps, min=0.0)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch(self, x):
        xf = x if x.dtype == torch.float64 else x.float()
        dims = (0, 2, 3)
        # the sums of x and the element count in one all-reduce
        local = torch.cat([xf.sum(dims), xf.new_full((1,), float(x.numel() // x.shape[1]))])
        sums = functional.all_sum(local)
        count = sums[-1]
        mean = sums[:-1] / count
        centred = xf - mean[None, :, None, None]
        var = functional.all_sum((centred * centred).sum(dims)) / count
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = centred * scale[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class ConvBNAct(nn.Module):
    """conv -> BN -> activation. `padding` None means symmetric d*(k-1)//2,
    an int is symmetric. `bn_momentum` is the flax one (0.9), i.e. torch
    momentum 0.1. The JAX version's asymmetric padding serves only the
    stem_space_to_depth stem, which is not ported.

    `emit_q`: under int8 mode the output is quantized with a calibrated
    absmax (`out_absmax`) and returned as a QTensor, so the consumer conv or
    residual add reads int8 (JAX common.py:168-179). Set where the JAX
    package sets it in a region that is on by default (the backbone, the DB
    head's conv1); the FPN laterals' region (`q8_fpn_topdown`) is off, so
    they do not emit."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, dilation=1, use_bias=False, act="relu",
                 use_bn=True, bn_eps=1e-5, bn_momentum=0.9, emit_q=False):
        super().__init__()
        ks = _pair(kernel_size)
        if padding is None:
            padding = tuple(dilation * (k - 1) // 2 for k in ks)
        elif not isinstance(padding, int):
            raise NotImplementedError("ConvBNAct takes None or an int padding")
        self.conv = quant.QuantConv(
            in_channels, out_channels, ks, _pair(stride), padding=padding,
            dilation=dilation, groups=groups, bias=use_bias,
        )
        self.bn = (
            BatchNorm2d(out_channels, eps=bn_eps, momentum=1.0 - bn_momentum)
            if use_bn else None
        )
        self.act = act
        self.qmode = None
        self.out_absmax = quant.AbsMax() if emit_q else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = ACTS[self.act](x)
        qmode = quant.quantizing(self) if self.out_absmax is not None else None
        if qmode == "calibrate":
            self.out_absmax.observe(x)
        elif qmode == "int8":
            return quant.qtensor_from(x, self.out_absmax.get())
        return x


def finish_residual(block, out, identity, act_fn):
    """Residual add + activation tail of the ResNet blocks, with the int8
    flow (JAX common.py:148-173): in int8 mode both operands may be int8
    QTensors and the sum is requantized with the block's calibrated
    `out_absmax` (a QTensor out); calibrate mode records that absmax; float
    mode is `act(out + identity)`."""
    qmode = quant.quantizing(block)
    if qmode == "int8":
        return quant.qadd_act(out, identity, block.out_absmax.get(), act=act_fn)
    y = act_fn(out + identity)
    if qmode == "calibrate":
        block.out_absmax.observe(y)
    return y


def quant_max_pool(x, window, stride, padding):
    """max_pool that keeps an int8 QTensor int8; plain tensors take the
    normal max_pool."""
    if isinstance(x, quant.QTensor):
        return quant.qmaxpool(x, window, stride, padding)
    return max_pool(x, window, stride, padding)


def max_pool(x, window, strides, padding=(0, 0)):
    """torch MaxPool2d on NCHW: symmetric padding with -inf, as the JAX
    `max_pool` pads."""
    return F.max_pool2d(x, _pair(window), _pair(strides), _pair(padding))


def resize_nearest(x, scale):
    """Nearest-neighbour upsample by an integer scale on NCHW. Equal, element
    for element, to the JAX version's depthwise transposed conv."""
    s = int(scale)
    if s == 1:
        return x
    return F.interpolate(x, scale_factor=s, mode="nearest")


class SEModule(nn.Module):
    """Squeeze-excitation, JAX modeling/common.py:183: the spatial mean, a
    1x1 conv to channels // reduction (with bias), relu, a 1x1 conv back
    (with bias), hard_sigmoid, and x scaled by it. Names `fc1`, `fc2` as
    flax's."""

    def __init__(self, channels, reduction=4):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * hard_sigmoid(s)
