"""int8 PTQ of the rest of the detection zoo in the port against the JAX
package, on the CPU: DB on MobileNetV3 (small, large x0.5), ShuffleNetV2,
RepVGG-A0 in train and in deploy form, and DB++ (ResNet-18 + FPN with the
ASF attention), at narrow widths (FPN 32) on two 64x64 inputs.

Weights cross through the weight bridge (`shaped_pair`: random kernels,
biases and BN statistics), calibrated absmax through `flax_quant_to_torch`,
so both sides quantize with the same scales. Then, per model:
  * the port's own calibration equals JAX `quant.calibrate` leaf for leaf
    at rtol 1e-5 (float32 convolutions summed in another order);
  * the int8 forward with the JAX scales against the jitted JAX int8
    forward. Every conv of these backbones quantizes its own float input,
    so a value that lands within an ulp of a rounding boundary (BN and the
    convs' float32 sums differ in their last bits between XLA and oneDNN)
    can quantize one quantum apart and move what follows, so the int8
    payloads that the models hand on (the fused map of the DB FPN, whose
    x8 / x4 / x2 repeats copy one flip 64, 16 or 4 times; DB++'s backbone
    maps) are held to `FLIP_WORST` quanta on under `FLIP_SHARE` of the
    elements, and the prob maps to `MAPS_ATOL`;
  * the RepVGG deploy form's backbone stays float (its `reparam` is a plain
    conv in JAX): no `act_absmax` under it;
  * DB++'s laterals take the backbone's QTensors and give float maps: its
    fused map is float and its ASF has no scale.
Every detector config of configs/det passes `quant.unsupported`.
"""

import glob
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.ops import quant as jquant
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.ops import quant
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.weights import flax_quant_to_torch
from torch_port_util import assert_absmax_match, nchw, nhwc, shaped_pair

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# The int8 forwards, JAX's and the port's on the same scales. Measured on
# the fused map: ShuffleNetV2 5.5% of the elements one quantum apart (485
# up, 419 down) and 2 of 16,384 two apart, MobileNetV3 small 1.9% and large
# 0.9% one apart, RepVGG (both forms) and DB++ (its backbone maps) none;
# prob maps at most 1.42e-3 apart (ShuffleNetV2)
FLIP_WORST, FLIP_SHARE, MAPS_ATOL = 2, 0.1, 5e-3


def _arch(backbone, **neck):
    return {"model_type": "det", "algorithm": "DB", "Transform": None, "Backbone": backbone,
            "Neck": dict({"name": "FPN", "out_channels": 32, "mode": "DB"}, **neck),
            "Head": {"name": "DBHead", "k": 50}, "return_all_feats": True}


ZOO = {
    "mbv3_small": _arch({"name": "MobileNetV3", "model_name": "small", "width_mult": 0.35,
                         "use_se": True}),
    "mbv3_large05": _arch({"name": "MobileNetV3", "model_name": "large", "width_mult": 0.5,
                           "use_se": False}),
    "sfv2": _arch({"name": "ShuffleNetV2", "scale": 0.5}),
    "repvgg_train": _arch({"name": "RepVGG", "model_name": "A0"}),
    "repvgg_deploy": _arch({"name": "RepVGG", "model_name": "A0", "deploy": True}),
    "dbpp": _arch({"name": "ResNet", "layers": 18}, use_asf=True,
                  attention_type="scale_channel_spatial"),
}


@pytest.fixture(scope="module", params=sorted(ZOO))
def zoo_int8(request):
    """One model of ZOO in both packages: JAX calibrated and in int8 (jitted,
    as the JAX deploy runs it), the port calibrated on its own, then in int8
    on the JAX scales."""
    name = request.param
    arch = ZOO[name]
    x = np.random.RandomState(11).rand(2, 64, 64, 3).astype(np.float32)
    jmod, tmod = jax_build_model(arch), build_model(arch)
    variables, _ = shaped_pair(jmod, tmod, x, seed=3)
    jcal = jquant.calibrate(jmod, variables, [jnp.asarray(x)])
    with jquant.quantized("int8"):
        want = jax.jit(partial(jmod.apply, train=False))(jcal, x)
    tx = nchw(x)
    with torch.no_grad():
        quant.calibrate(tmod, [tx])
        n_leaves = assert_absmax_match(tmod, jcal["quant"])
        flax_quant_to_torch(tmod, jcal["quant"])
        with quant.quantized(tmod, "int8"):
            got = tmod(tx)
    return dict(name=name, tmod=tmod, jcal=jcal, want=want, got=got, n_leaves=n_leaves)


def _payload_flips(got, want):
    """(largest difference in quanta, share of elements apart) of two int8
    payloads, the port's NCHW against JAX's NHWC, on one scale."""
    assert got.q.dtype == torch.int8
    assert float(got.scale) == float(want.scale)
    d = np.abs(nhwc(got.q).astype(np.int32) - np.asarray(want.q, np.int32))
    return int(d.max()), float((d > 0).mean())


def test_zoo_calibration_matches_jax(zoo_int8):
    """Every JAX `quant` leaf has its calibrated AbsMax in the port, equal at
    rtol 1e-5 (assert_absmax_match), and no AbsMax of the port is left
    uncalibrated but those JAX has none for."""
    tmod = zoo_int8["tmod"]
    calibrated = [n for n, m in tmod.named_modules()
                  if isinstance(m, quant.AbsMax) and m.calibrated]
    assert len(calibrated) == zoo_int8["n_leaves"] > 0
    if zoo_int8["name"] == "repvgg_deploy":  # the folded backbone stays float
        assert not any(n.startswith("backbone.") for n in calibrated)
    if zoo_int8["name"] == "dbpp":  # laterals emit float; no fused-map or ASF scale
        assert not any(n.startswith("neck.concat_attention") for n in calibrated)
        assert "neck.fuse_absmax" not in calibrated


def test_zoo_int8_matches_jax(zoo_int8):
    """The prob maps and the int8 payloads handed on against the JAX int8
    forward on the same scales (module docstring)."""
    got, want = zoo_int8["got"], zoo_int8["want"]
    if zoo_int8["name"] == "dbpp":
        assert torch.is_tensor(got["neck_out"]) and not isinstance(got["neck_out"], quant.QTensor)
        for c, w in zip(got["backbone_out"], want["backbone_out"]):
            worst, share = _payload_flips(c, w)
            assert worst <= FLIP_WORST and share < FLIP_SHARE, (worst, share)
    else:
        for c in got["backbone_out"]:
            assert not isinstance(c, quant.QTensor)  # no emit_q in these backbones
        worst, share = _payload_flips(got["neck_out"], want["neck_out"])
        assert worst <= FLIP_WORST and share < FLIP_SHARE, (worst, share)
    maps = got["maps"].numpy()
    assert np.isfinite(maps).all() and maps.min() >= 0 and maps.max() <= 1
    np.testing.assert_allclose(maps, np.asarray(want["maps"]), atol=MAPS_ATOL)


def test_every_det_config_takes_int8():
    """quant.unsupported is None for the model of every config of
    configs/det (the distillation configs have no `backbone`, as before)."""
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "det", "*.yml")))
    assert len(paths) == 13
    for path in paths:
        model = build_model(load_config(path)["Architecture"])
        assert quant.unsupported(model) is None, path
