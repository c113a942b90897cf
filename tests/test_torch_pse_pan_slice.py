"""The port's PSE and PAN detection slices against the JAX package: the same
small det checkpoints, the same tests/synth.py pages, through JAX
`Deter.run_batch` and the port's `Deter.run_batch`, both in float32 on the
CPU (the JAX deploy's bf16 default is patched to float32, as in
tests/test_torch_slice.py). Boxes must be equal.

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
from pytorchocr_tpu_torch.utils.weights import load_flax_variables
from torch_port_util import jax_train_state

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


def _jax_run_batch(cfg, ckpt, imgs):
    import infer_det

    def f32(config, dtype=None):
        return jax_build_model(config["Architecture"], dtype=jnp.float32)

    patch = pytest.MonkeyPatch()
    patch.setattr(infer_det, "build_infer_model", f32)
    try:
        return infer_det.Deter(cfg, ckpt).run_batch(imgs)
    finally:
        patch.undo()


@pytest.mark.parametrize("name", ["pse", "pan"])
def test_det_slice_matches_jax_run_batch(pages, name):
    tmp, imgs = pages
    cfg, ckpt, pt = _checkpoints(tmp, name, imgs)
    want = _jax_run_batch(cfg, ckpt, imgs)
    before = runmax.launches, propagate.launches
    got = Deter(cfg, pt, device="cpu").run_batch(imgs)
    assert (runmax.launches, propagate.launches) == before  # CPU tensors launch no kernel
    assert sum(len(b) for b in want) >= 2, "no text boxes found"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gb, wb in zip(g, w):
            np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb))
