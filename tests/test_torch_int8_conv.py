"""The int8 convolution (pytorchocr_tpu_torch/ops/int8_conv.py).

On the CPU its plain version runs against what the JAX package computes,
`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)` and the
float32 dequant of pytorchocr_tpu/ops/quant.py:252-255: the int32 sums must
be equal (compared as float32, exact below 2^24, which every case here
stays under) and the float32 outputs equal to the last bit (one multiply and
one add, each rounded once, on both sides); with `out_dtype=bf16` equal to
the JAX result cast to bf16 (`QuantConv`'s `y.astype(dtype)`, quant.py:259).

The `cuda`-marked tests hold the hand-written kernel (csrc/int8_conv.cu)
against the plain version on the card, exactly, in float32 and bf16, at
those shapes, at the DB-ResNet18 shapes of 4 pages of 736x1280 (stem,
layers, downsamples, FPN laterals and the head), which take each of the
GEMM's load modes and tile sizes, and at the zoo's depthwise shapes and
edges (int8_dwconv: whole-row runs and channel chunks, one, two or four
channels a thread, 3x3 and 5x5 at stride 1 and 2, dilation, multipliers;
Cg > 1 takes int8_conv_direct); they skip without a card."""

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
    ("Cin 24 3x3, Wo 100", 2, 24, 9, 100, 10, 3, 1, 1, 1, 1, True),
    ("depthwise 3x3/2 C58", 2, 58, 11, 13, 58, 3, 2, 1, 1, 58, True),
    ("depthwise 3x3/1 C88", 1, 88, 9, 10, 88, 3, 1, 1, 1, 88, False),
    ("depthwise 5x5/2 C40", 2, 40, 13, 15, 40, 5, 2, 2, 1, 40, True),
    ("depthwise 3x3 dilation 2", 2, 16, 12, 14, 16, 3, 1, 2, 2, 16, False),
    ("depthwise multiplier 2", 2, 12, 10, 11, 24, 3, 1, 1, 1, 12, True),
    ("groups 4, Cg 4", 2, 16, 10, 9, 8, 3, 1, 1, 1, 4, True),
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_int8_conv_bf16_equals_jax(case):
    """out_dtype=bf16: the JAX package's int8 conv, dequant and bias in
    float32, then `.astype(bfloat16)`, as QuantConv does under bf16."""
    _, n, cin, h, w, cout, k, stride, padding, dilation, groups, bias = case
    xq, wq, scale, b = make_case(n, cin, h, w, cout, k, groups, bias, seed=cout + h)
    acc = jax_int8_conv(xq, wq, stride, padding, dilation, groups)
    want = jnp.asarray(acc).astype(jnp.float32) * jnp.asarray(scale)[None, :, None, None]
    if b is not None:
        want = want + jnp.asarray(b)[None, :, None, None]
    want = np.asarray(want.astype(jnp.bfloat16)).view(np.int16)
    got = int8_conv.int8_conv(_t(xq), _t(wq), _t(scale), _t(b), stride, padding, dilation,
                              groups, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


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
    with pytest.raises(TypeError, match="out_dtype"):
        int8_conv.int8_conv(x, wt, s, out_dtype=torch.float16)


# DB-ResNet18 at 4 pages of 736x1280: the stem (its input patch), a layer-1 conv
# (cp.async gathers, 128-row tiles, N 64), layer 2-4 convs (N 128; layers 3
# and 4 on 64-row tiles), the 1x1/2 downsamples, the FPN laterals (A by TMA)
# and the head's 3x3 over the fused map; the stem of 4 portrait pages
# (1056x736: 368-pixel output rows, so 128-pixel tiles straddle two rows)
CARD_CASES = CASES + [
    ("db stem 4x736x1280", 4, 3, 736, 1280, 64, 7, 2, 3, 1, 1, False),
    ("db stem 4x1056x736 portrait", 4, 3, 1056, 736, 64, 7, 2, 3, 1, 1, False),
    ("db layer1 3x3 64", 4, 64, 184, 320, 64, 3, 1, 1, 1, 1, False),
    ("db layer2 3x3 128", 4, 128, 92, 160, 128, 3, 1, 1, 1, 1, False),
    ("db layer3 3x3 256", 4, 256, 46, 80, 256, 3, 1, 1, 1, 1, False),
    ("db layer4 3x3/2 256->512", 4, 256, 46, 80, 512, 3, 2, 1, 1, 1, False),
    ("db downsample 1x1/2 128->256", 4, 128, 92, 160, 256, 1, 2, 0, 1, 1, False),
    ("db fpn in2 1x1 64->256", 4, 64, 184, 320, 256, 1, 1, 0, 1, 1, False),
    ("db fpn in5 1x1 512->256", 4, 512, 23, 40, 256, 1, 1, 0, 1, 1, False),
    ("db head 3x3 256->64", 4, 256, 184, 320, 64, 3, 1, 1, 1, 1, True),
    ("Cout 40, M not a tile multiple", 1, 32, 7, 9, 40, 3, 1, 1, 1, 1, True),
    ("1x1 Cin 16, K under a stage", 1, 16, 7, 9, 24, 1, 1, 0, 1, 1, True),
    ("byte loads at N 128", 1, 3, 30, 40, 128, 7, 2, 3, 1, 1, True),
    ("input patch: Cin 3, 64-pixel rows", 1, 3, 20, 256, 16, 7, 2, 3, 1, 1, True),
    ("input patch: Cin 24 3x3", 2, 24, 9, 64, 10, 3, 1, 1, 1, 1, True),
    ("input patch: Cin 8 dilation 2, N 128", 1, 8, 12, 128, 136, 3, 1, 2, 2, 1, False),
    ("input patch straddling rows: Cin 3 7x7/2, Wo 75", 2, 3, 20, 150, 16, 7, 2, 3, 1, 1, True),
    ("input patch straddling rows: Cin 8 dilation 2, Wo 130", 1, 8, 12, 130, 40, 3, 1, 2, 2, 1,
     False),
    ("depthwise 5x5 96", 2, 96, 24, 48, 96, 5, 1, 2, 1, 96, True),
    # the depthwise convs of the int8 MobileNetV3 and ShuffleNetV2 detectors
    # at 4 pages of 736x1280 (int8_dwconv): the largest, ShuffleNetV2's odd
    # channel counts, the widest channels, 5x5 at stride 1 and 2
    ("zoo dw C8 4x368x640 3x3/1", 4, 8, 368, 640, 8, 3, 1, 1, 1, 8, False),
    ("zoo dw C16 4x368x640 3x3/2", 4, 16, 368, 640, 16, 3, 2, 1, 1, 16, False),
    ("zoo dw C58 4x184x320 3x3/2", 4, 58, 184, 320, 58, 3, 2, 1, 1, 58, False),
    ("zoo dw C116 4x46x80 3x3/1", 4, 116, 46, 80, 116, 3, 1, 1, 1, 116, True),
    ("zoo dw C576 4x23x40 5x5/1", 4, 576, 23, 40, 576, 5, 1, 2, 1, 576, False),
    ("zoo dw C336 4x46x80 5x5/2", 4, 336, 46, 80, 336, 5, 2, 2, 1, 336, True),
    # int8_dwconv's edges: output rows narrower than a thread's 4 columns,
    # fewer output rows than a band, a multiplier on chunked channels
    ("depthwise Wo 3", 2, 16, 9, 5, 16, 3, 1, 0, 1, 16, True),
    ("depthwise H 2, 5x5", 1, 32, 2, 50, 32, 5, 1, 2, 1, 32, False),
    ("depthwise multiplier 3, C 100", 1, 100, 8, 21, 300, 3, 2, 1, 1, 100, True),
]
OUT_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_equals_plain_on_card(cuda_device, case, out_dtype):
    _, n, cin, h, w, cout, k, stride, padding, dilation, groups, bias = case
    xq, wq, scale, b = make_case(n, cin, h, w, cout, k, groups, bias, seed=cout + h)
    x = _t(xq).to(cuda_device).contiguous(memory_format=torch.channels_last)
    args = (_t(wq).to(cuda_device), _t(scale).to(cuda_device),
            None if b is None else _t(b).to(cuda_device), stride, padding, dilation, groups)
    before = int8_conv.launches
    got = int8_conv.int8_conv(x, *args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    want = int8_conv.int8_conv_ref(x, *args, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
def test_kernel_unaligned_input_on_card(cuda_device):
    """A payload that starts off a 16-byte boundary takes the byte loads."""
    xq, wq, scale, b = make_case(2, 32, 12, 14, 48, 3, 1, True, seed=5)
    flat = torch.zeros(xq.size + 1, dtype=torch.int8, device=cuda_device)
    x = flat[1:].view(2, 12, 14, 32).permute(0, 3, 1, 2)
    x.copy_(_t(xq))
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16
    args = (_t(wq).to(cuda_device), _t(scale).to(cuda_device), _t(b).to(cuda_device), 1, 1, 1, 1)
    for out_dtype in OUT_DTYPES:
        assert torch.equal(int8_conv.int8_conv(x, *args, out_dtype=out_dtype),
                           int8_conv.int8_conv_ref(x, *args, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,k,stride", [(58, 3, 2), (40, 3, 1), (144, 5, 1)],
                         ids=["C58 one run", "C40 byte gathers", "C144 byte copies"])
def test_kernel_unaligned_grouped_input_on_card(cuda_device, cin, k, stride):
    """A depthwise payload that starts off a 16-byte (and a 4-byte)
    boundary: the whole-row run's aligned superset (C 58), one channel a
    thread where four would need 4-byte pixels (C 40), and chunked channels
    copied byte by byte (C 144)."""
    xq, wq, scale, b = make_case(2, cin, 11, 19, cin, k, cin, True, seed=cin)
    flat = torch.zeros(xq.size + 1, dtype=torch.int8, device=cuda_device)
    x = flat[1:].view(2, 11, 19, cin).permute(0, 3, 1, 2)
    x.copy_(_t(xq))
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 4
    args = (_t(wq).to(cuda_device), _t(scale).to(cuda_device), _t(b).to(cuda_device), stride,
            k // 2, 1, cin)
    before = int8_conv.branch_launches["depthwise"]
    for out_dtype in OUT_DTYPES:
        assert torch.equal(int8_conv.int8_conv(x, *args, out_dtype=out_dtype),
                           int8_conv.int8_conv_ref(x, *args, out_dtype=out_dtype))
    assert int8_conv.branch_launches["depthwise"] == before + len(OUT_DTYPES)


@pytest.mark.cuda
def test_kernel_rejects_nchw_input(cuda_device):
    xq, wq, scale, _ = make_case(1, 16, 6, 6, 4, 3, 1, False, seed=0)
    x = _t(xq).to(cuda_device)
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv.int8_conv(x, _t(wq).to(cuda_device), _t(scale).to(cuda_device))
