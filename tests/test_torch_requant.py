"""The int8 requantize passes (pytorchocr_tpu_torch/ops/requant.py).

On the CPU each entry point runs its plain version, held bit for bit
against the JAX package's own ops (pytorchocr_tpu/ops/quant.py `_quantize`,
`qtensor_from`, `qadd_act`, `dequant`), run eagerly and under `jax.jit`:
exact half-way ties (x / scale = k + 0.5, which must round to even), values
past +-127 scale, negative zero, float32 and bf16 inputs, and every operand
combination of `add_act_quantize` with relu on and off. Where the two JAX
runs differ, each difference is explained:
  * the scale of `qtensor_from`: under jit XLA computes absmax / 127 as
    absmax * float32(1/127); the port follows the jitted scale, and the
    eager run is held to the port given the eager scale;
  * the residual add under jit (XLA:CPU code, not the JAX package's
    semantics): it contracts a dequant's multiply into the add (one rounding
    where eager JAX and torch round twice), and without an activation it
    keeps a bf16 + bf16 sum in float32. The port follows the eager run (and
    PyTorch) bit for bit; every element where the jitted run differs is one
    of those two roundings (ROADMAP.md C).

The `cuda`-marked tests hold the hand-written kernel (csrc/requant.cu)
against the plain version on the card, exactly, at these inputs and at
4x64x368x640; they skip without a card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu_torch.ops import quant, requant
from torch_port_util import cuda_device  # noqa: F401  (fixture)


class _JaxQuant:
    """The JAX package's quant module, imported at first use: it needs flax,
    which the card's machine lacks, and the card tests never use it."""

    def __getattr__(self, name):
        from pytorchocr_tpu.ops import quant as jq

        return getattr(jq, name)


jquant = _JaxQuant()

SHAPE = (2, 8, 9, 13)


def _bits(t):
    """A torch tensor's bits as a numpy array (bf16 as uint16)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _torch(a, dtype):
    """A numpy float32 array as a torch tensor of `dtype` (values exact)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax(t):
    """A torch tensor as a jax array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def float_cases(dtype):
    """(name, x, scale) inputs of the quantize: ties, saturation, -0.0."""
    rng = np.random.RandomState(7)
    span = 130 if dtype == torch.float32 else 60  # bf16 holds k + 0.5 exactly below 64
    k = rng.randint(-span, span, SHAPE).astype(np.float32)
    cases = [("ties", (k + 0.5) * 0.25, 0.25)]  # x / scale = k + 0.5 exactly
    x = (rng.randn(*SHAPE) * 0.9).astype(np.float32)  # past +-127 scale: saturates
    x.flat[:5] = [0.0, -0.0, 0.5, -0.5, 1e30]
    cases.append(("random, saturating", x, 0.0071))
    return [(n, _torch(a, dtype), torch.tensor(s, dtype=torch.float32)) for n, a, s in cases]


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_quantize_equals_jax(dtype):
    quantize_jit = jax.jit(jquant._quantize)
    for name, x, scale in float_cases(dtype):
        got = requant.quantize(x, scale)
        assert got.dtype == torch.int8
        for want in (jquant._quantize(_jax(x), _jax(scale)), quantize_jit(_jax(x), _jax(scale))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    # ties round to even, not away from zero
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.5, -300.0])
    assert requant.quantize(x, torch.tensor(1.0)).tolist() == [0, 2, 2, 0, -2, 126, 127, -127]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_dequant_equals_jax(dtype):
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randint(-127, 128, SHAPE).astype(np.int8))
    scale = torch.tensor(0.0123, dtype=torch.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = requant.dequant(q, scale, dtype)
    assert got.dtype == dtype
    jq = jquant.QTensor(jnp.asarray(q.numpy()), jnp.asarray(scale.numpy()))
    deq_jit = jax.jit(jquant.dequant, static_argnums=1)
    for want in (jquant.dequant(jq, jdtype), deq_jit(jq, jdtype)):
        np.testing.assert_array_equal(_bits(got), _jbits(want))
    np.testing.assert_array_equal(_bits(quant.dequant(quant.QTensor(q, scale), dtype)),
                                  _bits(got))


def test_qtensor_from_follows_jit_scale():
    """The port's scale is XLA's under jit; the eager JAX run divides by
    127 and, for some absmax, gets another scale (here 6.458941: an ulp
    apart), then the same payload for that scale."""
    x = float_cases(torch.float32)[1][1]
    for absmax in (np.float32(6.458941), np.float32(0.9), np.float32(5.3)):
        got = quant.qtensor_from(x, torch.tensor(absmax))
        want = jax.jit(jquant.qtensor_from)(_jax(x), absmax)
        assert float(got.scale) == float(want.scale)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        eager = jquant.qtensor_from(_jax(x), absmax)
        np.testing.assert_array_equal(
            requant.quantize(x, torch.tensor(np.asarray(eager.scale))).numpy(),
            np.asarray(eager.q))
    assert float(jquant.qtensor_from(_jax(x), np.float32(6.458941)).scale) != float(
        quant.qtensor_from(x, torch.tensor(np.float32(6.458941))).scale)


KINDS = ["i8", "f32", "bf16"]
COMBOS = [(ka, kb) for ka in KINDS for kb in KINDS]


def _operand(kind, rng, spread):
    """(port operand, its scale or None, JAX operand) of one kind."""
    if kind == "i8":
        q = torch.from_numpy(rng.randint(-127, 128, SHAPE).astype(np.int8))
        s = torch.tensor(np.float32(spread / 127.0))
        return q, s, jquant.QTensor(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    x = (rng.randn(*SHAPE) * spread).astype(np.float32)
    x.flat[:3] = [-0.0, 0.0, spread * 0.5]
    t = _torch(x, torch.float32 if kind == "f32" else torch.bfloat16)
    return t, None, _jax(t)


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("kinds", COMBOS, ids=["%s+%s" % c for c in COMBOS])
def test_add_act_quantize_equals_jax(kinds, relu):
    rng = np.random.RandomState(len(kinds[0]) * 10 + len(kinds[1]) + relu)
    a, sa, ja = _operand(kinds[0], rng, 2.0)
    b, sb, jb = _operand(kinds[1], rng, 3.0)
    absmax = np.float32(3.9)  # the sums reach past it: saturation
    act = jax.nn.relu if relu else None
    eager = jquant.qadd_act(ja, jb, absmax, act=act)
    want_jit = jax.jit(lambda x, y, m: jquant.qadd_act(x, y, m, act=act))(ja, jb, absmax)
    assert float(eager.scale) == float(want_jit.scale)  # 3.9: the two scales agree
    out_scale = torch.tensor(np.asarray(want_jit.scale))
    got = requant.add_act_quantize(a, b, sa, sb, out_scale, relu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager.q))
    # the jitted run: equal but where its own roundings move an element
    jit_q = np.asarray(want_jit.q)
    apart = np.nonzero(got.numpy() != jit_q)
    assert len(apart[0]) <= 0.05 * got.numel(), len(apart[0])
    candidates = _jit_sums(a, sa, b, sb, relu)
    for idx in zip(*apart):
        assert any(int(requant.quantize_ref(torch.tensor(c[idx]), out_scale)) == jit_q[idx]
                   for c in candidates), idx
    # and through quant.qadd_act, the ResNet blocks' call
    qa = quant.QTensor(a, sa) if sa is not None else a
    qb = quant.QTensor(b, sb) if sb is not None else b
    port = quant.qadd_act(qa, qb, torch.tensor(absmax), act=torch.relu if relu else None)
    assert torch.equal(port.q, got) and float(port.scale) == float(want_jit.scale)


def _jit_sums(a, sa, b, sb, relu):
    """The float32 sums XLA:CPU's jitted add can form: a dequant's product
    kept exact into the add (a fused multiply-add), or a bf16 + bf16 sum
    kept in float32; relu applied."""
    def exact(t, s):  # float64 holds q * s and a float's value exactly
        return t.double() * float(s) if s is not None else t.double()

    def rounded(t, s):
        return requant.dequant_ref(t, s).double() if s is not None else t.double()

    sums = [exact(a, sa) + rounded(b, sb), rounded(a, sa) + exact(b, sb),
            exact(a, sa) + exact(b, sb)]
    return [torch.relu(x.float()) if relu else x.float() for x in sums]


def test_memory_format_is_kept():
    x = _torch(np.random.RandomState(9).randn(*SHAPE).astype(np.float32), torch.float32)
    cl = x.contiguous(memory_format=torch.channels_last)
    s = torch.tensor(0.01)
    q = requant.quantize(cl, s)
    assert q.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(q, requant.quantize(x, s))
    d = requant.dequant(q, s, torch.bfloat16)
    assert d.is_contiguous(memory_format=torch.channels_last)
    a = requant.add_act_quantize(q, cl, s, None, s, True)
    assert a.is_contiguous(memory_format=torch.channels_last)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(SHAPE)
    q = torch.zeros(SHAPE, dtype=torch.int8)
    s = torch.tensor(0.5)
    with pytest.raises(TypeError, match="x: dtype"):
        requant.quantize(x.half(), s)
    with pytest.raises(TypeError, match="q: dtype"):
        requant.dequant(q.int(), s)
    with pytest.raises(TypeError, match="dtype"):
        requant.dequant(q, s, torch.float16)
    with pytest.raises(ValueError, match="memory"):
        requant.quantize(x[:, :, ::2], s)
    with pytest.raises(ValueError, match="memory"):
        requant.dequant(q.transpose(2, 3), s)
    with pytest.raises(ValueError, match="memory format"):
        requant.add_act_quantize(q, x.contiguous(memory_format=torch.channels_last), s, None, s,
                                 False)
    with pytest.raises(ValueError, match="shape"):
        requant.add_act_quantize(q, x[:1], s, None, s, False)
    with pytest.raises(ValueError, match="scale: a 0-d"):
        requant.quantize(x, torch.tensor([0.5]))
    with pytest.raises(ValueError, match="scale: a 0-d"):
        requant.dequant(q, 0.5)
    with pytest.raises(ValueError, match="scale_a: a 0-d"):
        requant.add_act_quantize(q, x, s.double(), None, s, False)
    with pytest.raises(ValueError, match="scale_b: a float operand"):
        requant.add_act_quantize(q, x, s, s, s, False)
    with pytest.raises(ValueError, match="act must be None or relu"):
        quant.qadd_act(quant.QTensor(q, s), x, torch.tensor(1.0), act=torch.sigmoid)


# ---------------------------------------------------------------- the card

def _card_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    x.flat[:4] = [0.5 * 0.0125, -2.5 * 0.0125, -0.0, 1e30]  # ties at scale 0.0125, -0, saturation
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPE, (4, 64, 368, 640), (3, 5, 7, 11)],
                         ids=["small", "db 4x64x368x640", "odd numel"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_kernel_equals_plain_on_card(cuda_device, shape, channels_last):
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x32 = torch.from_numpy(_card_inputs(shape, 1)).to(cuda_device).contiguous(memory_format=fmt)
    y32 = torch.from_numpy(_card_inputs(shape, 2)).to(cuda_device).contiguous(memory_format=fmt)
    s = torch.tensor(0.0125, device=cuda_device)
    s2 = torch.tensor(0.031, device=cuda_device)
    before = requant.launches
    for x in (x32, x32.bfloat16()):
        got = requant.quantize(x, s)
        assert got.is_contiguous(memory_format=fmt)
        assert torch.equal(got, requant.quantize_ref(x, s))
    q = requant.quantize(x32, s)
    for dtype in (torch.float32, torch.bfloat16):
        got = requant.dequant(q, s, dtype)
        assert got.dtype == dtype and torch.equal(got, requant.dequant_ref(q, s, dtype))
    q2 = requant.quantize(y32, s2)
    ops = {"i8": (q, s), "i8b": (q2, s2), "f32": (y32, None), "bf16": (x32.bfloat16(), None),
           "bf16b": (y32.bfloat16(), None)}
    pairs = [("i8", "i8b"), ("i8", "f32"), ("bf16", "i8b"), ("f32", "bf16"), ("bf16", "bf16b"),
             ("f32", "f32"), ("i8", "bf16"), ("f32", "i8b"), ("bf16b", "f32")]
    for ka, kb in pairs:
        (a, sa), (b, sb) = ops[ka], ops[kb]
        for relu in (False, True):
            got = requant.add_act_quantize(a, b, sa, sb, s2, relu)
            want = requant.add_act_quantize_ref(a, b, sa, sb, s2, relu)
            assert torch.equal(got, want), (ka, kb, relu, int((got != want).sum()))
    torch.cuda.synchronize()
    assert requant.launches == before + 2 + 1 + 2 + 1 + 2 * len(pairs)


@pytest.mark.cuda
def test_kernel_unaligned_tensors_on_card(cuda_device):
    """Views that start off a 16-byte boundary take the element path."""
    n = 4099
    base = torch.from_numpy(_card_inputs((n + 3,), 3)).to(cuda_device)
    x = base[3:]
    s = torch.tensor(0.0125, device=cuda_device)
    assert torch.equal(requant.quantize(x, s), requant.quantize_ref(x, s))
    qb = requant.quantize(base, s)[1:n + 1]
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(requant.dequant(qb, s, dtype), requant.dequant_ref(qb, s, dtype))
    assert torch.equal(requant.add_act_quantize(qb, x, s, None, s, True),
                       requant.add_act_quantize_ref(qb, x, s, None, s, True))
