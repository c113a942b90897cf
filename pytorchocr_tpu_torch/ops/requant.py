"""The int8 requantize passes of the PTQ path — the port's counterpart of
the XLA fusions that the JAX package's elementwise int8 ops compile to
(pytorchocr_tpu/ops/quant.py:119-122 `_quantize`, 140-163 `dequant`,
`qtensor_from`, `qadd_act`). They replace no Pallas kernel.

  quantize(x, scale)           clamp(round(x.float() / scale), -127, 127) int8
  dequant(q, scale, dtype)     (q.float() * scale).to(dtype)
  add_act_quantize(a, b, scale_a, scale_b, out_scale, relu)
                               quantize(relu?(deq(a) + deq(b)), out_scale)

`round` rounds half to even, as jnp.round does. An operand of
`add_act_quantize` is an int8 payload with its scale (dequantized to
float32) or a float32 or bf16 tensor (scale None); the add follows torch's
type promotion (two bf16 tensors add to a bf16 sum). Scales are 0-d float32
tensors on the data's device. Tensors are contiguous or channels_last, the
operands of the add alike; each output keeps the input's memory format.

On a CUDA tensor each entry point launches the hand-written kernel
`csrc/requant.cu` (one pass: each input read once, each output written
once) or raises; on a CPU tensor it runs the plain PyTorch version beside
it (`*_ref`), which is the code the port ran before the kernel. There is no
other route.
"""

import torch

from .. import _kernels

launches = 0  # kernel launches (only where the CUDA kernel is launched)

FLOATS = (torch.float32, torch.bfloat16)
_KIND = {torch.int8: 1, torch.float32: 2, torch.bfloat16: 3}


def quantize_ref(x, scale):
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def dequant_ref(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def add_act_quantize_ref(a, b, scale_a, scale_b, out_scale, relu):
    a, b = (dequant_ref(t, s) if t.dtype == torch.int8 else t
            for t, s in ((a, scale_a), (b, scale_b)))
    out = a + b
    if relu:
        out = torch.relu(out)
    return quantize_ref(out, out_scale)


def _dense(name, t):
    """Raise unless `t` is contiguous or channels_last (one dense run in
    memory order)."""
    if not (t.is_contiguous()
            or (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError("%s: the kernel takes contiguous or channels_last memory, got strides %s"
                         % (name, tuple(t.stride())))


def _check_scale(name, s, device):
    if not torch.is_tensor(s) or s.dtype != torch.float32 or s.dim() != 0:
        raise ValueError("%s: a 0-d float32 tensor expected, got %s" % (
            name, "%s %s" % (s.dtype, tuple(s.shape)) if torch.is_tensor(s) else type(s).__name__))
    if s.device != device:
        raise ValueError("%s: on %s, expected %s" % (name, s.device, device))


def _check_dtype(name, t, dtypes):
    if t.dtype not in dtypes:
        raise TypeError("%s: dtype %s, expected one of %s" % (name, t.dtype, dtypes))


def _cuda(device):
    if device.type != "cuda":
        raise NotImplementedError("requant: no kernel for %s" % device)


def _out(like, dtype):
    """An empty tensor of `like`'s shape and strides (its memory format)."""
    return torch.empty_like(like, dtype=dtype, memory_format=torch.preserve_format)


def _launch(symbol, device, *args):
    global launches
    err = _kernels.call(_kernels.load("requant", symbol), device, *args,
                        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("requant kernel %s failed: error %d" % (symbol, err))
    launches += 1


def quantize(x, scale):
    """int8 `x` / `scale` rounded half to even and clamped to [-127, 127];
    `x` float32 or bf16."""
    _check_dtype("x", x, FLOATS)
    _dense("x", x)
    _check_scale("scale", scale, x.device)
    if x.device.type == "cpu":
        return quantize_ref(x, scale)
    _cuda(x.device)
    q = _out(x, torch.int8)
    _launch("requant_quantize", x.device, x.data_ptr(), _KIND[x.dtype], scale.data_ptr(),
            q.data_ptr(), x.numel())
    return q


def dequant(q, scale, dtype=torch.float32):
    """`q` int8 times `scale`, as float32 or bf16."""
    _check_dtype("q", q, (torch.int8,))
    if dtype not in FLOATS:
        raise TypeError("dequant: dtype %s, expected one of %s" % (dtype, FLOATS))
    _dense("q", q)
    _check_scale("scale", scale, q.device)
    if q.device.type == "cpu":
        return dequant_ref(q, scale, dtype)
    _cuda(q.device)
    y = _out(q, dtype)
    _launch("requant_dequant", q.device, q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            _KIND[dtype], q.numel())
    return y


def add_act_quantize(a, b, scale_a, scale_b, out_scale, relu):
    """int8 quantize(relu?(deq(a) + deq(b)), out_scale). `a` and `b`: int8
    with a 0-d float32 scale, or float32 / bf16 with scale None; the same
    shape and memory format."""
    for name, t, s in (("a", a, scale_a), ("b", b, scale_b)):
        _check_dtype(name, t, (torch.int8,) + FLOATS)
        _dense(name, t)
        if t.dtype == torch.int8:
            _check_scale("scale_" + name, s, a.device)
        elif s is not None:
            raise ValueError("scale_%s: a float operand takes no scale" % name)
    # both dense and of one shape: the same memory order unless exactly one
    # of them is contiguous
    if a.shape != b.shape or a.is_contiguous() != b.is_contiguous():
        raise ValueError("a and b: shapes %s and %s, strides %s and %s; the kernel takes one "
                         "shape and memory format" % (tuple(a.shape), tuple(b.shape),
                                                      a.stride(), b.stride()))
    if a.device != b.device:
        raise ValueError("a and b: on %s and %s" % (a.device, b.device))
    _check_scale("out_scale", out_scale, a.device)
    if a.device.type == "cpu":
        return add_act_quantize_ref(a, b, scale_a, scale_b, out_scale, relu)
    _cuda(a.device)
    q = _out(a, torch.int8)
    _launch("requant_add", a.device,
            a.data_ptr(), _KIND[a.dtype], None if scale_a is None else scale_a.data_ptr(),
            b.data_ptr(), _KIND[b.dtype], None if scale_b is None else scale_b.data_ptr(),
            out_scale.data_ptr(), q.data_ptr(), a.numel(), int(bool(relu)))
    return q
