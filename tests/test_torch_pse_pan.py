"""The port's PSE and PAN detection against the JAX package: the device
expansion and aggregation (exact labels), the postprocesses (equal boxes),
and the models' modules in float32 with weights through the bridge.

Inputs come from seeded numpy. Kernel maps are nested (kernel k+1 inside
kernel k) blobs that overlap, so instances contest pixels, with some
components under min_area. Tolerances: boxes and labels exact; box scores
(means of a sigmoid taken by two frameworks) rtol 1e-6; model stacks at
rtol 1e-3 and atol 2e-3, as tests/test_torch_modules.py holds them, or 2e-6
of the stage's largest value where that is larger (untrained ResNet-50)."""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.modeling.necks.fpem_ffm import FPEM_FFM as JFPEM_FFM
from pytorchocr_tpu.ops import cc_label as jcc
from pytorchocr_tpu.ops.propagate import pse_np
from pytorchocr_tpu.postprocess.pan_postprocess import PANPostProcess as JaxPAN
from pytorchocr_tpu.postprocess.pse_postprocess import PSEPostProcess as JaxPSE
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.modeling.necks.fpem_ffm import FPEM_FFM
from pytorchocr_tpu_torch.ops import cc_label, propagate
from pytorchocr_tpu_torch.postprocess import build_post_process
from torch_port_util import DEEP, init_pair, nchw, nhwc

LEVELS = np.linspace(0.0, 0.8, 7)


def nested_field(rng, h, w, n):
    """max over `n` boxes of 1 - (normalized Chebyshev distance to the box
    centre), with noise for ragged edges: thresholds at rising levels give
    nested kernels, and overlapping boxes contest pixels."""
    yy, xx = np.mgrid[:h, :w]
    field = np.full((h, w), -1.0)
    for _ in range(n):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry, rx = rng.uniform(2, h / 5), rng.uniform(3, w / 4)
        field = np.maximum(field, 1 - np.maximum(np.abs(yy - cy) / ry, np.abs(xx - cx) / rx))
    return field + 0.08 * rng.rand(h, w)


def _jax_pse(kernels, min_area):
    return np.asarray(jcc.pse_expand_device(jnp.asarray(kernels), jnp.float32(min_area)))


def _jax_pa(kernels, emb, min_area):
    return np.asarray(jcc.pa_aggregate_device(jnp.asarray(kernels), jnp.asarray(emb),
                                              jnp.float32(min_area)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pse_expand_device_matches_jax(seed):
    rng = np.random.RandomState(seed)
    kernels = np.stack([nested_field(rng, 96, 160, 14) > t for t in LEVELS])
    min_area = 6
    stats = cv2.connectedComponentsWithStats(kernels[-1].astype(np.uint8), connectivity=4)[2]
    assert (stats[1:, 4] < min_area).sum() > 0  # the min-area filter has components to drop
    before = propagate.launches
    got = cc_label.pse_expand_device(torch.from_numpy(kernels), min_area).numpy()
    assert propagate.launches == before  # CPU tensors launch no kernel
    np.testing.assert_array_equal(got, _jax_pse(kernels, min_area))
    assert len(np.unique(got)) > 4 and (got > 0).sum() > (kernels[-1]).sum()


def test_pse_numbering_diverges_from_pse_np():
    """Divergence 2 of ROADMAP.md C. `pse_np` numbers components by their
    first raster pixel (cv2), the device path by their last; the fill rule
    gives a contested pixel to the larger id, so the two split contested
    pixels differently. The port follows the device path exactly."""
    text = np.zeros((24, 40), np.uint8)
    text[2:21, :] = 1
    seed = np.zeros_like(text)
    seed[2:21, 5] = 1  # A: first raster pixel first, last raster pixel last
    seed[10, 31] = 1  # B: (10, 18) lies 13 steps from both
    kernels = np.stack([text, seed])
    host = pse_np(kernels, 0)
    got = cc_label.pse_expand_device(torch.from_numpy(kernels > 0), 0).numpy()
    np.testing.assert_array_equal(got, _jax_pse(kernels > 0, 0))
    assert ((host > 0) == (got > 0)).all()
    assert (host[2:21, 5] == 1).all() and (got[2:21, 5] == 2).all()  # A: 1 on the host, 2 here
    a_host, a_dev = host == host[2, 5], got == got[2, 5]
    assert a_host[10, 18] != a_dev[10, 18]  # the contested pixel changes owner
    assert (a_host != a_dev).sum() > 1


def _pa_case(rng, h, w):
    field = nested_field(rng, h, w, 10)
    text, kernel = field > 0, field > 0.55
    # one text component with a kernel of > 1024 pixels and a 1-pixel one:
    # an extreme area ratio, so both labels' fills are gated
    text[10:60, 10:110] = True
    kernel[10:60, 10:110] = False
    kernel[14:56, 14:44] = True  # 1,260 pixels
    kernel[35, 90] = True
    emb = rng.randn(4, h, w).astype(np.float32)
    emb[:, 10:60, 10:70] = 0.3 * emb[:, 10:60, 10:70] + 1.0  # near the big kernel's mean
    return np.stack([text, kernel & text]), emb * text


@pytest.mark.parametrize("seed", [2, 3])
def test_pa_aggregate_device_matches_jax(seed):
    kernels, emb = _pa_case(np.random.RandomState(seed), 96, 160)
    labels, flag, _ = cc_label.pa_gate(torch.from_numpy(kernels), torch.from_numpy(emb), 0.1625)
    assert int(flag.sum()) >= 2  # the gate is exercised
    got = cc_label.pa_aggregate_device(torch.from_numpy(kernels), torch.from_numpy(emb),
                                       0.1625).numpy()
    np.testing.assert_array_equal(got, _jax_pa(kernels, emb, 0.1625))
    assert len(np.unique(got)) > 4 and (got > 0).sum() > (labels > 0).sum().item()


def _pse_maps(rng, n, h, w):
    maps = np.stack([np.stack([6.0 * (nested_field(rng, h, w, 8) - t) for t in LEVELS], -1)
                     for _ in range(n)])
    return maps.astype(np.float32)


def _assert_same_boxes(got, want):
    assert sum(len(r["points"]) for r in want) >= 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["points"], np.asarray(w["points"]))
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-6)


@pytest.mark.parametrize("scale", [1, 4])
@pytest.mark.parametrize("device_expand", [True, False])
def test_pse_postprocess_matches_jax(scale, device_expand):
    maps = _pse_maps(np.random.RandomState(4), 2, 24, 40)
    shape_list = [[192, 320, 2.0, 2.0], [96, 160, 1.0, 1.0]]
    cfg = {"name": "PSEPostProcess", "thresh": 0, "box_thresh": 0.5, "min_area": 16,
           "scale": scale, "use_device_expand": device_expand}
    want = JaxPSE(**{k: v for k, v in cfg.items() if k != "name"})(
        {"maps": jnp.asarray(maps)}, shape_list)
    got = build_post_process(cfg)({"maps": torch.from_numpy(maps)}, shape_list)
    _assert_same_boxes(got, want)


@pytest.mark.parametrize("scale", [1, 4])
@pytest.mark.parametrize("device_aggregate", [True, False])
def test_pan_postprocess_matches_jax(scale, device_aggregate):
    rng = np.random.RandomState(5)
    maps = []
    for _ in range(2):
        field = nested_field(rng, 24, 40, 8)
        maps.append(np.concatenate([6.0 * field[..., None], 6.0 * (field[..., None] - 0.5),
                                    rng.randn(24, 40, 4)], -1))
    maps = np.stack(maps).astype(np.float32)
    shape_list = [[192, 320, 2.0, 2.0], [96, 160, 1.0, 1.0]]
    cfg = {"name": "PANPostProcess", "thresh": 0, "box_thresh": 0.5, "min_area": 16,
           "min_kernel_area": 2.6, "scale": scale, "use_device_aggregate": device_aggregate}
    want = JaxPAN(**{k: v for k, v in cfg.items() if k != "name"})(
        {"maps": jnp.asarray(maps)}, shape_list)
    got = build_post_process(cfg)({"maps": torch.from_numpy(maps)}, shape_list)
    _assert_same_boxes(got, want)


ARCHS = {
    "pse": {"model_type": "det", "algorithm": "PSE", "Transform": None,
            "Backbone": {"name": "ResNet", "layers": 50},
            "Neck": {"name": "FPN", "out_channels": 32},
            "Head": {"name": "PSEHead", "hidden_dim": 16, "out_channels": 7},
            "return_all_feats": True},
    "pan": {"model_type": "det", "algorithm": "PAN", "Transform": None,
            "Backbone": {"name": "ResNet", "layers": 18},
            "Neck": {"name": "FPEM_FFM", "out_channels": 16, "mode": "v2", "fpem_num": 2},
            "Head": {"name": "PANHead", "hidden_dim": 16, "out_channels": 6},
            "return_all_feats": True},
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def det_outputs(request):
    """Each stage's output of a whole PSE (ResNet-50, FPN non-DB 32, PSEHead
    16 -> 7) or PAN (ResNet-18, FPEM_FFM v2 16 x2, PANHead 16 -> 6) model
    on a 64x64 input, from one JAX compile: (port, jax) NHWC numpy dicts."""
    arch = ARCHS[request.param]
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    tmod = build_model(arch)
    variables, apply = init_pair(jax_build_model(arch), tmod, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    want = apply(variables, x)

    def flat(y, conv, maps):
        out = {"C%d" % (i + 2): conv(f) for i, f in enumerate(y["backbone_out"])}
        out["neck"] = conv(y["neck_out"])
        out["maps"] = maps(y["maps"])
        return out

    return (flat(got, nhwc, lambda t: t.numpy()), flat(want, np.asarray, np.asarray))


@pytest.mark.parametrize("stage", ["C2", "C5", "neck", "maps"])
def test_pse_pan_models_match_jax(det_outputs, stage):
    """ResNet-50 (Bottleneck) and ResNet-18 feature maps, the FPN in non-DB
    mode and FPEM_FFM v2, and the PSE/PAN heads' maps."""
    got, want = det_outputs
    assert got[stage].shape == want[stage].shape
    if stage == "maps":
        assert got[stage].shape[-1] in (6, 7)
    # untrained ResNet-50 activations reach ~1e4: atol grows with the stage's
    # largest value (2e-6 of it, at least DEEP's 2e-3)
    atol = max(DEEP["atol"], 2e-6 * float(np.abs(want[stage]).max()))
    np.testing.assert_allclose(got[stage], want[stage], rtol=DEEP["rtol"], atol=atol)


def test_fpem_ffm_v1_matches_jax():
    rng = np.random.RandomState(7)
    chans = [8, 12, 16, 20]
    x = [rng.randn(2, 16 >> i, 16 >> i, c).astype(np.float32) for i, c in enumerate(chans)]
    tmod = FPEM_FFM(chans, out_channels=8, mode="v1", fpem_num=3)
    variables, apply = init_pair(JFPEM_FFM(in_channels=chans, out_channels=8, mode="v1",
                                           fpem_num=3), tmod, x)
    with torch.no_grad():
        got = nhwc(tmod([nchw(a) for a in x]))
    assert got.shape == (2, 16, 16, 32) and tmod.fused_channels == 32
    np.testing.assert_allclose(got, np.asarray(apply(variables, x)), **DEEP)
    # use_asf adds the ASF attention after the fusion (tests/test_torch_zoo.py)
    assert FPEM_FFM(chans, out_channels=8, use_asf=True).concat_attention is not None
    assert tmod.concat_attention is None
