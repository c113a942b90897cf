"""int8 convolution with an exact int32 sum and a float32 dequant — the
port's counterpart of the int8 conv that XLA lowers for the JAX package
(pytorchocr_tpu/ops/quant.py:252-259, `lax.conv_general_dilated(xq, wq,
preferred_element_type=int32)` then `* (s_x * s_w)`, the bias and the cast to
the compute dtype). It replaces no Pallas kernel; PyTorch has no int8
convolution on CUDA.

    y[n, oc, ho, wo] = out_dtype(float32(sum_k xq * wq) * scale[oc] (+ bias[oc]))

with the multiply and the add rounded separately (no fused multiply-add) and
the float32 result rounded once to `out_dtype` (float32 or bf16), so the
kernel's output equals the plain version's bit for bit.

On a CUDA tensor `int8_conv` launches the hand-written kernel
`csrc/int8_conv.cu` or raises; on a CPU tensor it runs the plain PyTorch
version `int8_conv_ref`. There is no other route.
"""

import torch
import torch.nn.functional as F

from .. import _kernels

launches = 0  # kernel launches (only where the CUDA kernel is launched)
# the same launches by the kernel's branch (csrc/int8_conv.cu:route): the
# wgmma implicit GEMM for groups == 1, int8_dwconv for one input channel a
# group (depthwise, channel multipliers), int8_conv_direct for the other
# grouped convs (Cg > 1, windows past 5x5, strides past 2 or unequal)
BRANCHES = ("wgmma", "depthwise", "direct")
branch_launches = dict.fromkeys(BRANCHES, 0)
_routes = {}  # (Cin, Cout, kh, kw, sh, sw, dh, dw, groups) -> branch name


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(a) for a in v)


def out_size(h, w, kh, kw, stride, padding, dilation):
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    return ((h + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
            (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1)


def int8_conv_ref(xq, wq, scale, bias=None, stride=1, padding=0, dilation=1, groups=1,
                  out_dtype=torch.float32):
    """Plain PyTorch version: F.conv2d in float64 on the int8 values, which
    is exact (every product is below 2^14 and every sum below 2^53), rounded
    to int32, then the same dequant in float32 and the cast to `out_dtype`.
    `wq` is packed (out, kh, kw, in/groups)."""
    with torch.autocast(xq.device.type, enabled=False):
        acc = F.conv2d(xq.double(), wq.permute(0, 3, 1, 2).double(), None,
                       _pair(stride), _pair(padding), _pair(dilation), groups)
    y = torch.round(acc).to(torch.int32).float() * scale.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y.to(out_dtype)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError("%s: dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))
    if t.device != device:
        raise ValueError("%s: on %s, expected %s" % (name, t.device, device))


OUT_DTYPES = (torch.float32, torch.bfloat16)


def int8_conv(xq, wq, scale, bias=None, stride=1, padding=0, dilation=1, groups=1,
              out_dtype=torch.float32):
    """int8 conv of `xq` (N, Cin, H, W) int8 with `wq` (Cout, kh, kw,
    Cin/groups) int8; symmetric `padding`. `scale` and `bias` are float32
    (Cout,). Returns `out_dtype` (float32 or bf16) (N, Cout, Ho, Wo),
    channels_last on CUDA. On CUDA `xq` must be channels_last and `wq`
    contiguous."""
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError("xq and wq must be 4-D, got %s and %s"
                         % (tuple(xq.shape), tuple(wq.shape)))
    n, cin, h, w = xq.shape
    cout, kh, kw, cg = wq.shape
    if groups < 1 or cin % groups or cout % groups or cg != cin // groups:
        raise ValueError("channels: input %d, weight (%d, %d, %d, %d), groups %d"
                         % (cin, cout, kh, kw, cg, groups))
    device = xq.device
    _check("xq", xq, torch.int8, (n, cin, h, w), device)
    _check("wq", wq, torch.int8, (cout, kh, kw, cg), device)
    _check("scale", scale, torch.float32, (cout,), device)
    if bias is not None:
        _check("bias", bias, torch.float32, (cout,), device)
    if out_dtype not in OUT_DTYPES:
        raise TypeError("out_dtype %s, expected one of %s" % (out_dtype, OUT_DTYPES))
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError("empty output %dx%d" % (ho, wo))

    if device.type == "cpu":
        return int8_conv_ref(xq, wq, scale, bias, stride, padding, dilation, groups, out_dtype)
    if device.type != "cuda":
        raise NotImplementedError("int8_conv: no kernel for %s" % device)
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("xq: the kernel takes channels_last memory")
    if not (wq.is_contiguous() and scale.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("wq, scale and bias must be contiguous")
    if max(n * h * w * cin, n * ho * wo * cout, cout * kh * kw * cg) >= 2 ** 31:
        raise ValueError("int8_conv: a tensor of 2^31 elements or more")
    y = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device).permute(0, 3, 1, 2)
    launch(xq, wq, scale, bias, y, stride, padding, dilation, groups)
    return y


def launch(xq, wq, scale, bias, y, stride, padding, dilation, groups):
    """One launch of the kernel into `y` (float32 or bf16) on CUDA tensors
    that `int8_conv` has checked and allocated: no checks, no allocation."""
    global launches
    n, cin, h, w = xq.shape
    cout, kh, kw, _ = wq.shape
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    fn = _kernels.load("int8_conv")
    err = _kernels.call(
        fn, xq.device, xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        n, h, w, cin, cout, kh, kw, y.shape[2], y.shape[3], sh, sw, ph, pw, dh, dw, groups,
        int(y.dtype == torch.bfloat16), torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("int8_conv kernel launch failed: %s" % (
            "libcuda's tensor-map encoder is missing or refused the shape" if err == -1
            else "cudaError %d" % err))
    launches += 1
    branch_launches[branch(cin, cout, kh, kw, sh, sw, dh, dw, groups)] += 1


def branch(*shape):
    """The kernel's branch for (Cin, Cout, kh, kw, sh, sw, dh, dw, groups),
    as the C side routes it (int8_conv_route), kept per shape."""
    if shape not in _routes:
        _routes[shape] = BRANCHES[_kernels.load("int8_conv", "int8_conv_route")(*shape)]
    return _routes[shape]
