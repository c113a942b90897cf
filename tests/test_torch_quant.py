"""int8 PTQ of the port (pytorchocr_tpu_torch/ops/quant.py and the int8
branches of ConvBNAct, the ResNet blocks, the FPN and the DB head) against
the JAX package's (pytorchocr_tpu/ops/quant.py), on the CPU.

Weights cross through the weight bridge, calibrated absmax through
`flax_quant_to_torch`, so both sides quantize with the same scales. Then:
  * the elementwise int8 ops (`qtensor_from`, `qadd_act`, `qmaxpool`,
    `repeat_nearest`, `dequant`) are exact: the same float32 operations,
    each rounded once; `QuantConv` on the same int8 input agrees to 2 ulp
    (an exact int32 conv; XLA reorders the product of the two scales);
  * through a stack of layers, BN is computed in another order by XLA and
    PyTorch (last-bit differences), so a value that lies within an ulp of a
    rounding boundary can quantize one quantum apart: those elements are
    counted and bounded, and the outputs compared at a tolerance of a few
    quanta;
  * the port's own calibration equals the JAX one to rtol 1e-5 (float32
    convolutions summed in another order).
"""

import os
from functools import partial

import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.modeling import common as jcommon
from pytorchocr_tpu.ops import quant as jquant
from pytorchocr_tpu_torch.modeling import build_model, common
from pytorchocr_tpu_torch.ops import quant
from pytorchocr_tpu_torch.utils.weights import (
    flax_quant_to_torch, flax_to_state_dict, load_absmax,
)
from torch_port_util import assert_absmax_match, init_pair, nchw, nhwc

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


class JStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = jcommon.ConvBNAct(16, 3, 2, act="relu", emit_q=True, name="c1")(x, train)
        x = jcommon.ConvBNAct(16, 3, 1, groups=4, use_bias=True, emit_q=True, name="c2")(x, train)
        return jcommon.ConvBNAct(32, 1, 1, act=None, name="c3")(x, train)


class TStack(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = common.ConvBNAct(3, 16, 3, 2, act="relu", emit_q=True)
        self.c2 = common.ConvBNAct(16, 16, 3, 1, groups=4, use_bias=True, emit_q=True)
        self.c3 = common.ConvBNAct(16, 32, 1, 1, act=None)

    def forward(self, x):
        return self.c3(self.c2(self.c1(x)))


def test_conv_bn_act_stack_int8_matches_jax():
    """Calibration against JAX `quant.calibrate`, then the int8 stack (a
    plain-input QuantConv, an int8-QTensor-input grouped conv with a bias,
    both emitting int8) against JAX int8 with the bridged quant state."""
    x = np.random.RandomState(0).rand(2, 20, 24, 3).astype(np.float32)
    jmod, tmod = JStack(), TStack()
    variables, _ = init_pair(jmod, tmod, x)
    jcal = jquant.calibrate(jmod, variables, [jnp.asarray(x)])
    keys = set(tmod.state_dict())
    quant.calibrate(tmod, [nchw(x)])
    assert assert_absmax_match(tmod, jcal["quant"]) == 5
    state = flax_quant_to_torch(tmod, jcal["quant"])
    assert sorted(state) == ["c1.conv.act_absmax", "c1.out_absmax", "c2.conv.act_absmax",
                             "c2.out_absmax", "c3.conv.act_absmax"]
    with jquant.quantized("int8"):
        want = np.asarray(jax.jit(partial(jmod.apply, train=False))(jcal, x))
    with torch.no_grad(), quant.quantized(tmod, "int8"):
        got = nhwc(tmod(nchw(x)))
    assert set(tmod.state_dict()) == keys  # int8 leaves the state_dict as it was
    # c3's output is float: a c2 payload element one quantum off moves it by
    # at most |w| * s_c2 per tap; measured max 0 here
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("groups,bias", [(1, True), (8, False)])
def test_quant_conv_on_int8_input_equals_jax(groups, bias):
    """The same int8 QTensor into JAX QuantConv (jitted, as the deploy runs
    it) and the port's: the same per-channel int8 weights and the exact
    int32 conv. XLA reassociates the scale product under jit (its HLO
    computes max|W| * (s_x * (1/127)), the port (s_x * s_w) as the JAX
    source writes it), so the float32 outputs agree to 2 ulp of the product
    (rtol and atol 2.4e-7: outputs are below 1 here; the bias can cancel
    most of a product), not bit for bit."""
    rng = np.random.RandomState(groups)
    q = rng.randint(-127, 128, (2, 9, 11, 8)).astype(np.int8)
    scale = np.float32(0.0123)
    jmod = jcommon.ConvBNAct(8, 3, 2, groups=groups, use_bias=bias, use_bn=False, act=None)
    tmod = common.ConvBNAct(8, 8, 3, 2, groups=groups, use_bias=bias, use_bn=False, act=None)
    variables, _ = init_pair(jmod, tmod, q.astype(np.float32))
    variables = dict(variables, quant={"conv": {"act_absmax": np.float32(1.0)}})
    jx = jquant.QTensor(jnp.asarray(q), jnp.asarray(scale))
    with jquant.quantized("int8"):
        want = np.asarray(jax.jit(partial(jmod.apply, train=False))(variables, jx))
    tx = quant.QTensor(nchw(q), torch.tensor(scale))
    with torch.no_grad(), quant.quantized(tmod, "int8"):
        got = nhwc(tmod(tx))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=2.4e-7)


def test_elementwise_int8_ops_equal_jax():
    rng = np.random.RandomState(3)
    a = (rng.randn(2, 9, 7, 5) * 2).astype(np.float32)
    b = (rng.randn(2, 9, 7, 5) * 3).astype(np.float32)
    am, bm, om = np.float32(np.abs(a).max()), np.float32(np.abs(b).max()), np.float32(4.5)
    ja, jb = jquant.qtensor_from(jnp.asarray(a), am), jquant.qtensor_from(jnp.asarray(b), bm)
    ta, tb = quant.qtensor_from(nchw(a), torch.tensor(am)), quant.qtensor_from(nchw(b), torch.tensor(bm))
    np.testing.assert_array_equal(nhwc(ta.q), np.asarray(ja.q))
    assert float(ta.scale) == float(ja.scale)
    np.testing.assert_array_equal(nhwc(quant.dequant(ta)), np.asarray(jquant.dequant(ja)))
    # a residual tail: one int8 operand and one float, relu, requantized
    for x, y in ((ja, jb), (ja, jnp.asarray(b))):
        jw = jquant.qadd_act(x, y, om, act=jax.nn.relu)
        tw = quant.qadd_act(ta, tb if isinstance(y, jquant.QTensor) else nchw(b),
                            torch.tensor(om), act=torch.relu)
        np.testing.assert_array_equal(nhwc(tw.q), np.asarray(jw.q))
    jp, tp = jquant.qmaxpool(ja, 3, 2, 1), quant.qmaxpool(ta, 3, 2, 1)
    np.testing.assert_array_equal(nhwc(tp.q), np.asarray(jp.q))
    assert tp.q.dtype == torch.int8
    for s in (2, 4, 8):
        np.testing.assert_array_equal(nhwc(quant.repeat_nearest(ta.q, s)),
                                      np.asarray(jquant.repeat_nearest(ja.q, s)))
    cl = ta.q.contiguous(memory_format=torch.channels_last)
    assert quant.repeat_nearest(cl, 2).is_contiguous(memory_format=torch.channels_last)


def test_int8_without_calibration_raises():
    tmod = TStack().eval()
    with pytest.raises(RuntimeError, match="calibrat"), quant.quantized(tmod, "int8"):
        tmod(torch.zeros(1, 3, 16, 16))
    with pytest.raises(ValueError, match="at least one batch"):
        quant.calibrate(tmod, [])


DB_ARCH = {
    "model_type": "det",
    "algorithm": "DB",
    "Transform": None,
    "Backbone": {"name": "ResNet", "layers": 18},
    "Neck": {"name": "FPN", "out_channels": 64, "mode": "DB"},
    "Head": {"name": "DBHead", "k": 50},
    "return_all_feats": True,
}


@pytest.fixture(scope="module")
def db_int8():
    """A small DB-ResNet18 (FPN 64) on two 64x96 inputs: JAX and the port in
    float, calibrated, and in int8; the port in int8 twice, with its own
    calibration and with the JAX one."""
    x = np.random.RandomState(1).rand(2, 64, 96, 3).astype(np.float32)
    jmod, tmod = jax_build_model(DB_ARCH), build_model(DB_ARCH)
    variables, apply = init_pair(jmod, tmod, x)
    keys = set(tmod.state_dict())
    jcal = jquant.calibrate(jmod, variables, [jnp.asarray(x)])
    with jquant.quantized("int8"):
        want = jax.jit(partial(jmod.apply, train=False))(jcal, x)
    tx = nchw(x)
    out = dict(x=x, jcal=jcal, want=want, tmod=tmod, keys=keys)
    with torch.no_grad():
        out["float"] = tmod(tx)["maps"].numpy()
        quant.calibrate(tmod, [tx])
        out["n_leaves"] = assert_absmax_match(tmod, jcal["quant"])
        with quant.quantized(tmod, "int8"):
            out["own"] = tmod(tx)["maps"].numpy()
        out["state"] = flax_quant_to_torch(tmod, jcal["quant"])
        with quant.quantized(tmod, "int8"):
            out["got"] = tmod(tx)
    return out


def test_db_calibration_matches_jax(db_int8):
    # the stem's conv and output (2), 8 blocks x (conv1, conv2: conv and
    # output; the residual output) (40), 3 downsamples (6), 8 FPN convs and
    # the fused map (9), the head's conv1 (2) and mid (1)
    assert db_int8["n_leaves"] == len(db_int8["state"]) == 60


def test_db_int8_matches_jax(db_int8):
    """The prob map and the int8 payloads (C2..C5, the fused map) against
    JAX int8 with the same quant state. Measured: no payload element apart,
    prob maps within 3e-8. Bounds, for a BN rounding that lands a value on
    the other side of a quantization boundary: under 1% of the elements,
    none more than one quantum; prob map 2e-3."""
    got, want = db_int8["got"], db_int8["want"]
    gq, wq = nhwc(got["neck_out"].q).astype(np.int32), np.asarray(want["neck_out"].q, np.int32)
    assert gq.shape == wq.shape and got["neck_out"].q.dtype == torch.int8
    assert float(got["neck_out"].scale) == float(want["neck_out"].scale)
    diff = np.abs(gq - wq)
    assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())
    for c, w in zip(got["backbone_out"], want["backbone_out"]):
        cd = np.abs(nhwc(c.q).astype(np.int32) - np.asarray(w.q, np.int32))
        assert cd.max() <= 1 and cd.mean() < 0.01
    np.testing.assert_allclose(got["maps"].numpy(), np.asarray(want["maps"]), atol=2e-3)


def test_db_int8_tracks_float_and_keeps_state_dict(db_int8):
    """tests/test_quant.py's contract (int8 prob map valid and within 0.05
    mean of the float one) on the port's own calibration, and the
    state_dict / weight bridge untouched by int8."""
    own, ref = db_int8["own"], db_int8["float"]
    assert own.shape == ref.shape
    assert np.all(own >= 0) and np.all(own <= 1)
    assert np.abs(own - ref).mean() < 0.05
    tmod = db_int8["tmod"]
    assert set(tmod.state_dict()) == db_int8["keys"]
    flax_to_state_dict(tmod, jax.device_get(dict(db_int8["jcal"])))
    with pytest.raises(KeyError, match="no AbsMax"):
        load_absmax(tmod, {"head.binarize.conv1": torch.tensor(1.0)})


DB_CFG = """
Global: {distributed: False}
Architecture:
  model_type: det
  algorithm: DB
  Transform:
  Backbone: {name: ResNet, layers: 18}
  Neck: {name: FPN, out_channels: 64, mode: DB}
  Head: {name: DBHead, k: 50}
PostProcess: {name: DBPostProcess}
"""


def test_converter_writes_the_quant_collection(db_int8, tmp_path):
    """tools/convert_flax_to_torch.py on a checkpoint that holds a `quant`
    collection writes <out>.quant.pt beside the .pt; load_absmax sets a
    fresh model's scales from it."""
    import importlib.util

    from pytorchocr_tpu.utils.save_load import _save_pytree

    cfg = tmp_path / "db.yml"
    cfg.write_text(DB_CFG)
    jcal = jax.device_get(dict(db_int8["jcal"]))
    _save_pytree(str(tmp_path / "ckpt"), {k: jcal[k] for k in ("params", "batch_stats", "quant")})
    spec = importlib.util.spec_from_file_location(
        "convert_flax_to_torch", os.path.join(REPO, "tools", "convert_flax_to_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "det.pt")
    tool.convert(str(cfg), str(tmp_path / "ckpt"), out)
    absmax = torch.load(tool.quant_path(out), weights_only=True)
    assert tool.quant_path(out).endswith("det.quant.pt") and len(absmax) == 60
    model = build_model(dict(DB_ARCH, return_all_feats=False))
    model.load_state_dict(torch.load(out, weights_only=True))
    load_absmax(model, absmax)
    assert assert_absmax_match(model, jcal["quant"], rtol=0) == 60
