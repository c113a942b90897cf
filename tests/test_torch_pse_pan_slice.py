"""The port's PSE and PAN detection slices against the JAX package: the same
small det checkpoints, the same tests/synth.py pages, through JAX
`Deter.run_batch` and the port's `Deter.run_batch`, both in float32 on the
CPU (the JAX deploy's bf16 default is patched to float32, as in
tests/test_torch_slice.py). Boxes must be equal. With int8 detection
(`quant=True`) both sides calibrate on the first page; the port's
calibration must equal the JAX one to rtol 1e-5. With the JAX one bridged
in, XLA's and PyTorch's last-bit BN differences still move int8 elements
at rounding boundaries a quantum apart, and through random-weight networks
such flips spread (tests/test_torch_quant.py), so the int8 logit maps are
held as the JAX package holds int8 against float (tests/test_quant.py):
correlation > 0.995 and mean |difference| < 5% of the mean |logit|; under
2% of the pixels change sign, and the boxes match by rectangle IoU >= 0.5
at hmean >= 0.6.

PSE: ResNet-18, FPN non-DB 32, PSEHead 16 -> 7, `scale: 1`, min side 224,
so the expansion runs at page resolution and each map fits one JAX
propagation call. PAN: ResNet-18, FPEM_FFM v2 16 x2, PANHead 16 -> 6,
`scale: 4`. Untrained weights map a page to noise, so the head's last 1x1
conv is first made text-like on the pages (utils.seeded.text_like_pse_head_
and text_like_pan_head_) and the same values are written into the JAX
checkpoint; the test asserts boxes are found."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "deploy")))

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.utils.config import load_config
from pytorchocr_tpu.utils.save_load import save_model
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.ops import propagate, runmax
from pytorchocr_tpu_torch.utils.seeded import text_like_pan_head_, text_like_pse_head_
from pytorchocr_tpu_torch.utils.weights import flax_quant_to_torch, load_flax_variables
from torch_port_util import assert_absmax_match, jax_train_state, rect_hmean

from synth import make_det_dataset

EVAL = """
Eval:
  dataset:
    name: SimpleDataSet
    label_file_list: [dummy]
    transforms:
      - DecodeImage: {img_mode: RGB, channel_first: False}
      - DetLabelEncode:
      - DetResizeForTest: {limit_side_len: 224, limit_type: min}
      - ToTensor:
      - Normalize: {mean: [0.485, 0.456, 0.406], std: [0.229, 0.224, 0.225]}
      - KeepKeys: {keep_keys: [image, shape, polys, ignore_tags]}
"""

CFGS = {
    "pse": """
Global: {distributed: False, seed: 1}
Architecture:
  model_type: det
  algorithm: PSE
  Transform:
  Backbone: {name: ResNet, layers: 18}
  Neck: {name: FPN, out_channels: 32}
  Head: {name: PSEHead, hidden_dim: 16, out_channels: 7}
PostProcess: {name: PSEPostProcess, thresh: 0, box_thresh: 0.85, min_area: 16, scale: 1}
""" + EVAL,
    "pan": """
Global: {distributed: False, seed: 1}
Architecture:
  model_type: det
  algorithm: PAN
  Transform:
  Backbone: {name: ResNet, layers: 18}
  Neck: {name: FPEM_FFM, out_channels: 16, mode: v2, fpem_num: 2}
  Head: {name: PANHead, hidden_dim: 16, out_channels: 6}
PostProcess: {name: PANPostProcess, thresh: 0, box_thresh: 0.85, min_area: 16,
              min_kernel_area: 2.6, scale: 4}
""" + EVAL,
}

TEXT_LIKE = {"pse": text_like_pse_head_, "pan": text_like_pan_head_}


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pse_pan_slice")
    label_file = make_det_dataset(str(tmp / "imgs"), n=2, size=224, seed=3)
    paths = [label_file.replace("det_label.txt", "det_%04d.png" % i) for i in range(2)]
    return tmp, [cv2.imread(p) for p in paths]


def _checkpoints(tmp, name, imgs):
    """A JAX checkpoint and the port's .pt of one seeded model whose head was
    made text-like on `imgs` through the port, written back into flax."""
    cfg = str(tmp / ("%s.yml" % name))
    with open(cfg, "w") as f:
        f.write(CFGS[name])
    state = jax_train_state(cfg, (1, 64, 64, 3))
    deter = Deter(cfg, None, device="cpu")
    model = deter.runner.model
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    load_flax_variables(model, variables)
    det_imgs = np.concatenate([deter._preprocess(im)[0] for im in imgs])
    x = torch.from_numpy(det_imgs).float()
    x = ((x / 255.0 - deter.runner.mean) / deter.runner.std).permute(0, 3, 1, 2)
    dark = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) < 128 for im in det_imgs])
    TEXT_LIKE[name](model, x, dark)
    params = jax.tree.map(np.array, variables["params"])
    conv2 = model.head.conv2
    params["head"]["conv2"]["kernel"] = np.ascontiguousarray(
        conv2.weight.detach().numpy().transpose(2, 3, 1, 0))
    params["head"]["conv2"]["bias"] = conv2.bias.detach().numpy().copy()
    save_model(state.replace(params=params), {}, load_config(cfg), str(tmp),
               prefix="%s_ckpt" % name)
    pt = str(tmp / ("%s.pt" % name))
    torch.save(model.state_dict(), pt)
    return cfg, str(tmp / ("%s_ckpt" % name)), pt


@pytest.fixture(scope="module")
def checkpoints(pages):
    """name -> (cfg, JAX checkpoint, .pt), made once per module."""
    tmp, imgs = pages
    made = {}

    def get(name):
        if name not in made:
            made[name] = _checkpoints(tmp, name, imgs)
        return made[name]

    return get


def _jax_deter(cfg, ckpt, imgs, quant=False):
    """The JAX Deter (float32) after run_batch(imgs), and the boxes."""
    import infer_det

    def f32(config, dtype=None):
        return jax_build_model(config["Architecture"], dtype=jnp.float32)

    patch = pytest.MonkeyPatch()
    patch.setattr(infer_det, "build_infer_model", f32)
    try:
        deter = infer_det.Deter(cfg, ckpt, quant=quant)
        return deter, deter.run_batch(imgs)
    finally:
        patch.undo()


@pytest.mark.parametrize("name", ["pse", "pan"])
def test_det_slice_matches_jax_run_batch(pages, checkpoints, name):
    _, imgs = pages
    cfg, ckpt, pt = checkpoints(name)
    want = _jax_deter(cfg, ckpt, imgs)[1]
    before = runmax.launches, propagate.launches
    got = Deter(cfg, pt, device="cpu").run_batch(imgs)
    assert (runmax.launches, propagate.launches) == before  # CPU tensors launch no kernel
    assert sum(len(b) for b in want) >= 2, "no text boxes found"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gb, wb in zip(g, w):
            np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb))


@pytest.mark.parametrize("name", ["pse", "pan"])
def test_det_slice_int8_matches_jax_run_batch(pages, checkpoints, name):
    """Deter(quant=True): the int8 flow through a ResNet-18 backbone into
    the FPN (PSE) or FPEM_FFM (PAN) ConvBNActs, which take its QTensors."""
    _, imgs = pages
    cfg, ckpt, pt = checkpoints(name)
    jdeter, want = _jax_deter(cfg, ckpt, imgs, quant=True)
    qvars = jax.device_get(jdeter.runner.variables["quant"])
    deter = Deter(cfg, pt, device="cpu", quant=True)
    deter.run_batch(imgs)
    assert_absmax_match(deter.runner.model, qvars)
    flax_quant_to_torch(deter.runner.model, qvars)
    got = deter.run_batch(imgs)
    assert sum(len(b) for b in want) >= 2, "no text boxes found"
    batch = np.concatenate([deter._preprocess(im)[0] for im in imgs])
    a, b = deter.runner(batch)["maps"].numpy(), np.asarray(jdeter.runner(batch)["maps"])
    # measured: corrcoef 0.9992 / 0.9996, mean |diff| 2.9% / 2.2% of mean
    # |map|, signs apart 0.96% / 0.41%, hmean 0.77 / 0.73 (PSE / PAN)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995
    assert np.abs(a - b).mean() < 0.05 * np.abs(b).mean()
    assert ((a > 0) != (b > 0)).mean() < 0.02
    assert rect_hmean(got, want) >= 0.6


def test_infer_det_cli_quant(pages, checkpoints, tmp_path):
    """`infer_det --quant --calib_n 1` on the CPU: calibrated on the first
    image, then every image's res_<name>.txt holds the boxes that
    Deter(quant=True) finds after `calibrate_on` that same image."""
    import subprocess

    _, imgs = pages
    cfg, _, pt = checkpoints("pan")
    src = tmp_path / "imgs"
    src.mkdir()
    for i, img in enumerate(imgs):
        cv2.imwrite(str(src / ("p%d.png" % i)), img)
    out = tmp_path / "out"
    script = ("import sys; sys.argv = sys.argv[:1] + sys.argv[2:];"
              "from pytorchocr_tpu_torch.deploy import infer_det; infer_det.main()")
    proc = subprocess.run([sys.executable, "-c", script, "--", "--config", cfg, "--model_path", pt,
                           "--img_path", str(src), "--out_dir", str(out), "--device", "cpu",
                           "--quant", "--calib_n", "1"],
                          cwd=os.path.join(os.path.dirname(__file__), ".."),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    deter = Deter(cfg, pt, device="cpu", quant=True)
    deter.calibrate_on([str(src / "p0.png")])
    for i in range(len(imgs)):
        want = [",".join(str(v) for v in np.asarray(b).reshape(-1).tolist())
                for b in deter.run(str(src / ("p%d.png" % i)))]
        assert (out / ("res_p%d.txt" % i)).read_text().splitlines() == want
