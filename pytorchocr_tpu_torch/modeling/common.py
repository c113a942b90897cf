"""Shared model blocks — port of pytorchocr_tpu/modeling/common.py.

NCHW `nn.Module`s. Submodule names mirror the flax ones (`conv`, `bn`) so the
weight bridge (utils/weights.py) maps flax paths onto torch names one to one.

ConvBNAct carries the int8 PTQ flow of ops/quant.py: its conv is a
`QuantConv`, and with `emit_q` it hands its consumers an int8 QTensor under
int8 mode. `finish_residual` and `quant_max_pool` keep a ResNet block's
output int8. SEModule (PPLCNet's squeeze-excite), DPModule (which no
config of the repo uses) and the drop path of ConvNeXt and Swin are below.
"""

import contextlib
import threading

import numpy as np
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


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The context of a forward that a checkpoint recomputes in the backward
    (trainer.make_train_step's `remat`): BatchNorm2d leaves its running
    statistics as the first forward left them, as jax.checkpoint's pure
    recompute does. Thread-local: the backward may run on autograd's own
    thread, which enters this context itself."""
    before = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = before


def _update_running(bn, mean, var):
    """The flax blend of the batch statistics into `bn`'s running ones,
    except inside a recompute (`recomputing`)."""
    if getattr(_RECOMPUTE, "active", False):
        return
    with torch.no_grad():
        keep = 1.0 - bn.momentum
        bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
        bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)
        bn.num_batches_tracked.add_(1)


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
        _update_running(self, mean, torch.clamp(invstd.detach().pow(-2) - self.eps, min=0.0))
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
        _update_running(self, mean, var)
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


class DPModule(nn.Module):
    """Depthwise then pointwise ConvBNAct, JAX modeling/common.py:214: `dw`
    a k x k conv with one group a channel, `pw` a 1x1 conv to
    `out_channels`, each with BN and `act`. The flax module reads its input
    width from the input; here it is `in_channels`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, act="leakyrelu"):
        super().__init__()
        self.dw = ConvBNAct(in_channels, in_channels, kernel_size, stride, groups=in_channels,
                            act=act)
        self.pw = ConvBNAct(in_channels, out_channels, 1, 1, act=act)

    def forward(self, x):
        return self.pw(self.dw(x))


def linspace_f32(stop, num):
    """`[float(r) for r in jnp.linspace(0, stop, num)]` on the JAX package's
    CPU: jnp.linspace computes `0 * (1 - i / (num - 1)) + stop * (i / (num -
    1))` in float32, which XLA folds to `(stop * (1 / (num - 1))) * i`, and
    ends on `stop`; numpy's float32 linspace differs in the last bit on some
    entries (the drop-path rates of JAX det_convnext.py:70-72)."""
    if num <= 1:
        return [0.0] * num
    f = np.float32
    rates = (f(stop) * (f(1) / f(num - 1))) * np.arange(num - 1, dtype=f)
    return [float(v) for v in rates] + [float(f(stop))]


def drop_path(x, rate, training, generator):
    """Stochastic depth of JAX det_convnext.py:47-53 and det_swin.py:148-154:
    in training with `rate` > 0, each sample of `x` is kept with probability
    1 - rate (a Bernoulli mask over the batch axis from `generator`, a
    torch.Generator on `x`'s device) and divided by the keep probability.

    The JAX train step hands the model only a "sample" rng
    (pytorchocr_tpu/trainer.py:159), so a drop path > 0 in a train-mode
    forward raises flax's InvalidRngError there ("needs PRNG for
    'dropout'"); the port's step hands no generator either, and the same
    forward raises here."""
    if rate <= 0.0 or not training:
        return x
    if generator is None:
        raise RuntimeError(
            "drop path %g in a train-mode forward needs a torch.Generator: the train step "
            "hands the model none, as the JAX step hands it only a 'sample' rng "
            "(pytorchocr_tpu/trainer.py:159), where flax raises InvalidRngError ('needs PRNG "
            "for \"dropout\"'); set drop_path_rate: 0 to train" % rate)
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep
