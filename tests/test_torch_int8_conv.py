"""The int8 convolution (pytorchocr_tpu_torch/ops/int8_conv.py).

On the CPU its plain version runs against what the JAX package computes,
`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)` and the
float32 dequant of pytorchocr_tpu/ops/quant.py:252-255: the int32 sums must
be equal (compared as float32, exact below 2^24, which every case here
stays under) and the float32 outputs equal to the last bit (one multiply and
one add, each rounded once, on both sides).

The `cuda`-marked tests hold the hand-written kernel (csrc/int8_conv.cu)
against the plain version on the card, exactly, at those shapes and at the
stem and layer shapes of DB-ResNet18 on 4 pages of 736x1280; they skip
without a card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu_torch.ops import int8_conv
from torch_port_util import cuda_device  # noqa: F401  (fixture)

# (name, N, Cin, H, W, Cout, k, stride, padding, dilation, groups, bias)
CASES = [
    ("stem 7x7/2 Cin 3", 2, 3, 23, 30, 16, 7, 2, 3, 1, 1, True),
    ("3x3/1", 2, 16, 12, 14, 8, 3, 1, 1, 1, 1, False),
    ("3x3/2", 2, 16, 13, 11, 24, 3, 2, 1, 1, 1, True),
    ("1x1/2 downsample", 3, 32, 10, 9, 16, 1, 2, 0, 1, 1, False),
    ("3x3 dilation 2", 2, 16, 15, 17, 8, 3, 1, 2, 2, 1, False),
    ("odd H W, Cin 24", 1, 24, 9, 31, 10, 3, 1, 1, 1, 1, True),
    ("depthwise 3x3/2", 2, 8, 11, 13, 8, 3, 2, 1, 1, 8, False),
    ("groups 2", 2, 8, 10, 10, 6, 3, 1, 1, 1, 2, True),
]


def make_case(n, cin, h, w, cout, k, groups, bias, seed):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, cin, h, w)).astype(np.int8)
    wq = rng.randint(-127, 128, (cout, k, k, cin // groups)).astype(np.int8)
    scale = (rng.rand(cout) * 1e-3 + 1e-5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32) if bias else None
    return xq, wq, scale, b


def jax_int8_conv(xq, wq, stride, padding, dilation, groups):
    """The JAX package's int8 conv: NHWC x HWIO -> int32, as quant.py runs it."""
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 3, 1)), jnp.asarray(wq.transpose(1, 2, 3, 0)),
        window_strides=(stride, stride), padding=[(padding, padding)] * 2,
        rhs_dilation=(dilation, dilation), feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    return np.asarray(acc).transpose(0, 3, 1, 2)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_int8_conv_equals_jax(case):
    _, n, cin, h, w, cout, k, stride, padding, dilation, groups, bias = case
    xq, wq, scale, b = make_case(n, cin, h, w, cout, k, groups, bias, seed=cout + h)
    acc = jax_int8_conv(xq, wq, stride, padding, dilation, groups)
    assert acc.dtype == np.int32 and np.abs(acc).max() < 2 ** 24
    ones = torch.ones(cout)
    got = int8_conv.int8_conv(_t(xq), _t(wq), ones, None, stride, padding, dilation, groups)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))
    want = acc.astype(np.float32) * scale[None, :, None, None]
    if b is not None:
        want = want + b[None, :, None, None]
    got = int8_conv.int8_conv(_t(xq), _t(wq), _t(scale), _t(b), stride, padding, dilation,
                              groups)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xq, wq, scale, _ = make_case(1, 8, 6, 6, 4, 3, 1, False, seed=0)
    x, wt, s = _t(xq), _t(wq), _t(scale)
    with pytest.raises(TypeError, match="xq"):
        int8_conv.int8_conv(x.float(), wt, s)
    with pytest.raises(ValueError, match="channels"):
        int8_conv.int8_conv(x, wt, s, groups=2)
    with pytest.raises(ValueError, match="scale"):
        int8_conv.int8_conv(x, wt, s[:2])
    with pytest.raises(ValueError, match="empty"):
        int8_conv.int8_conv(x[:, :, :2], wt, s)


# DB-ResNet18 at 4 pages of 736x1280: the stem, a layer-1 conv, layer 4's
# strided conv, a 1x1/2 downsample and the head's 3x3 over the fused map
CARD_CASES = CASES + [
    ("db stem 4x736x1280", 4, 3, 736, 1280, 64, 7, 2, 3, 1, 1, False),
    ("db layer1 3x3 64", 4, 64, 184, 320, 64, 3, 1, 1, 1, 1, False),
    ("db layer4 3x3/2 256->512", 4, 256, 46, 80, 512, 3, 2, 1, 1, 1, False),
    ("db downsample 1x1/2 128->256", 4, 128, 92, 160, 256, 1, 2, 0, 1, 1, False),
    ("db head 3x3 256->64", 4, 256, 184, 320, 64, 3, 1, 1, 1, 1, True),
    ("Cout 40, M not a tile multiple", 1, 32, 7, 9, 40, 3, 1, 1, 1, 1, True),
    ("depthwise 5x5 96", 2, 96, 24, 48, 96, 5, 1, 2, 1, 96, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_equals_plain_on_card(cuda_device, case):
    _, n, cin, h, w, cout, k, stride, padding, dilation, groups, bias = case
    xq, wq, scale, b = make_case(n, cin, h, w, cout, k, groups, bias, seed=cout + h)
    x = _t(xq).to(cuda_device).contiguous(memory_format=torch.channels_last)
    args = (_t(wq).to(cuda_device), _t(scale).to(cuda_device),
            None if b is None else _t(b).to(cuda_device), stride, padding, dilation, groups)
    before = int8_conv.launches
    got = int8_conv.int8_conv(x, *args)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    want = int8_conv.int8_conv_ref(x, *args)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_kernel_rejects_nchw_input(cuda_device):
    xq, wq, scale, _ = make_case(1, 16, 6, 6, 4, 3, 1, False, seed=0)
    x = _t(xq).to(cuda_device)
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv.int8_conv(x, _t(wq).to(cuda_device), _t(scale).to(cuda_device))
