"""The port's whole serving slice against the JAX package: the same small
det and rec checkpoints (converted with tools/convert_flax_to_torch.py), the
same tests/synth.py pages, through JAX `OCRer.run_many` and the port's
`OCRer.run_many`, both in float32 on the CPU.

The JAX deploy builds its models in bf16 by default; that is a compute
policy, not the algorithm, so `build_infer_model` is patched to float32 here.
Boxes and texts must be equal; probs (rounded to 2 places by both Recers)
within 1e-4.

Untrained weights map a page to noise, so the det checkpoint's DBHead is
first made text-like (pytorchocr_tpu_torch.utils.seeded.text_like_db_head_:
phase-free deconvs, the last one along the dark-minus-light direction and
scaled so dark text lands above the threshold and the light page below it,
its bias set so the threshold sits in the widest gap of these pages' logits) and the same values are written into the JAX
checkpoint; the test asserts boxes are found."""

import importlib.util
import os
import subprocess
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
from pytorchocr_tpu_torch.deploy.common import Runner
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.deploy.run_ocr import OCRer
from pytorchocr_tpu_torch.utils.seeded import text_like_db_head_
from pytorchocr_tpu_torch.utils.weights import load_flax_variables
from torch_port_util import jax_train_state

from synth import make_det_dataset

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

DET_CFG = """
Global: {distributed: False, seed: 1}
Architecture:
  model_type: det
  algorithm: DB
  Transform:
  Backbone: {name: ResNet, layers: 18}
  Neck: {name: FPN, out_channels: 32, mode: DB}
  Head: {name: DBHead, k: 50}
PostProcess: {name: DBPostProcess, thresh: 0.3, box_thresh: 0.5, max_candidates: 100,
              unclip_ratio: 1.5, score_mode: poly}
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

REC_CFG = """
Global: {distributed: False, seed: 1, character_dict_path: , max_text_length: 25,
         use_space_char: False}
Architecture:
  model_type: rec
  algorithm: CRNN
  in_channels: 1
  Transform:
  Backbone: {name: VGG, model_name: v1, scale: 0.5}
  Neck: {name: SequenceEncoder, encoder_type: rnn, hidden_size: 32}
  Head: {name: CTCHead}
PostProcess: {name: CTCLabelDecode}
Eval:
  dataset:
    name: SimpleDataSet
    label_file_list: [dummy]
    transforms:
      - DecodeImage: {img_mode: GRAY, channel_first: False}
      - CTCLabelEncode:
      - RecResizeImg: {image_shape: [1, 32, 96]}
      - KeepKeys: {keep_keys: [image, label, length]}
"""


def _load_tool():
    path = os.path.join(REPO, "tools", "convert_flax_to_torch.py")
    spec = importlib.util.spec_from_file_location("convert_flax_to_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _text_like_det_state(state, det_cfg, pages):
    """Run text_like_db_head_ on the port's model (bridged from `state`) over
    `pages` and write the four changed tensors back into the flax params."""
    deter = Deter(det_cfg, None, device="cpu")
    model = deter.runner.model
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    load_flax_variables(model, variables)
    det_imgs = np.concatenate([deter._preprocess(cv2.imread(p))[0] for p in pages])
    x = torch.from_numpy(det_imgs).float()
    x = ((x / 255.0 - deter.runner.mean) / deter.runner.std).permute(0, 3, 1, 2)
    dark = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) < 128 for im in det_imgs])
    text_like_db_head_(model, x, dark)
    params = jax.tree.map(np.array, variables["params"])
    tower = params["head"]["binarize"]
    for name in ("deconv1", "deconv2"):
        w = getattr(model.head.binarize, name)
        # phase-free kernels: the spatial flip of the bridge is a no-op
        kernel = w.weight.detach().numpy().transpose(2, 3, 0, 1)
        tower[name]["kernel"] = np.ascontiguousarray(kernel)
        tower[name]["bias"] = w.bias.detach().numpy().copy()
    return state.replace(params=params)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    det_cfg, rec_cfg = str(tmp / "det.yml"), str(tmp / "rec.yml")
    (tmp / "det.yml").write_text(DET_CFG)
    (tmp / "rec.yml").write_text(REC_CFG)
    label_file = make_det_dataset(str(tmp / "imgs"), n=2, size=224, seed=3)
    pages = [label_file.replace("det_label.txt", "det_%04d.png" % i) for i in range(2)]

    det_state = jax_train_state(det_cfg, (1, 64, 64, 3))
    det_state = _text_like_det_state(det_state, det_cfg, pages)
    save_model(det_state, {}, load_config(det_cfg), str(tmp), prefix="det_ckpt")
    rec_state = jax_train_state(rec_cfg, (1, 32, 96, 1), char_num=37)
    save_model(rec_state, {}, load_config(rec_cfg), str(tmp), prefix="rec_ckpt")

    tool = _load_tool()
    det_pt, rec_pt = str(tmp / "det.pt"), str(tmp / "rec.pt")
    tool.convert(det_cfg, str(tmp / "det_ckpt"), det_pt)
    tool.convert(rec_cfg, str(tmp / "rec_ckpt"), rec_pt)
    return dict(det_cfg=det_cfg, rec_cfg=rec_cfg, pages=pages, tmp=tmp,
                det_ckpt=str(tmp / "det_ckpt"), rec_ckpt=str(tmp / "rec_ckpt"),
                det_pt=det_pt, rec_pt=rec_pt)


@pytest.fixture(scope="module")
def jax_result(slice_setup):
    import infer_det
    import infer_rec
    from run_ocr import OCRer as JaxOCRer

    def f32(config, dtype=None):
        return jax_build_model(config["Architecture"], dtype=jnp.float32)

    patch = pytest.MonkeyPatch()
    patch.setattr(infer_det, "build_infer_model", f32)
    patch.setattr(infer_rec, "build_infer_model", f32)
    try:
        s = slice_setup
        ocr = JaxOCRer(s["det_cfg"], s["det_ckpt"], s["rec_cfg"], s["rec_ckpt"])
        return ocr.run_many(s["pages"])
    finally:
        patch.undo()


def test_slice_matches_jax_run_many(slice_setup, jax_result):
    s = slice_setup
    ocr = OCRer(s["det_cfg"], s["det_pt"], s["rec_cfg"], s["rec_pt"], device="cpu")
    got = ocr.run_many(s["pages"])
    assert sum(len(page) for page in jax_result) >= 2, "no text boxes found"
    assert len(got) == len(jax_result)
    for page, want_page in zip(got, jax_result):
        assert len(page) == len(want_page)
        for (box, text, prob), (wbox, wtext, wprob) in zip(page, want_page):
            np.testing.assert_array_equal(box, np.asarray(wbox))
            assert text == wtext
            assert abs(prob - wprob) <= 1e-4


def test_cli_writes_res_txt(slice_setup, jax_result):
    """The port's CLI on the CPU writes the JAX CLI's res_*.txt rows, and
    loads no module of jax, flax or the JAX package."""
    s = slice_setup
    out = s["tmp"] / "cli_out"
    script = (
        "import sys; sys.argv = sys.argv[:1] + sys.argv[2:];"
        "from pytorchocr_tpu_torch.deploy import run_ocr; run_ocr.main();"
        "bad = [m for m in sys.modules"
        "       if m.split('.')[0] in ('jax', 'flax', 'pytorchocr_tpu')];"
        "assert not bad, bad"
    )
    cmd = [sys.executable, "-c", script, "--",
           "--det_config", s["det_cfg"], "--det_model_path", s["det_pt"],
           "--rec_config", s["rec_cfg"], "--rec_model_path", s["rec_pt"],
           "--img_path", s["pages"][0], "--out_dir", str(out), "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stem = os.path.splitext(os.path.basename(s["pages"][0]))[0]
    rows = (out / ("res_%s.txt" % stem)).read_text(encoding="UTF-8").splitlines()
    want = [
        ",".join([str(v) for v in np.asarray(box).reshape(-1).tolist()] + [text, str(prob)])
        for box, text, prob in jax_result[0]
    ]
    assert rows == want


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Runner(torch.nn.Identity(), device="cuda")
