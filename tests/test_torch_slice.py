"""The port's whole serving slice against the JAX package: the same small
det and rec checkpoints (converted with tools/convert_flax_to_torch.py), the
same tests/synth.py pages, through JAX `OCRer.run_many` and the port's
`OCRer.run_many`, both in float32 on the CPU.

The JAX deploy builds its models in bf16 by default; that is a compute
policy, not the algorithm, so `build_infer_model` is patched to float32 here.
Boxes and texts must be equal; probs (rounded to 2 places by both Recers)
within 1e-4. With the direction classifier (cls_mbv3small.yml, its fc made
decisive on the pages' crops by utils.seeded.decisive_cls_head_) and int8
detection (`det_quant`), int8 rounding differences move boxes, so the int8
runs are held at the bounds stated in their tests.

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
from pytorchocr_tpu_torch.deploy.infer_cls import Clser
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.deploy.run_ocr import OCRer, crop_lines
from pytorchocr_tpu_torch.ops import int8_conv
from pytorchocr_tpu_torch.utils.seeded import decisive_cls_head_, text_like_db_head_
from pytorchocr_tpu_torch.utils.weights import flax_quant_to_torch, load_flax_variables
from torch_port_util import assert_absmax_match, jax_train_state, rect_hmean

from synth import make_det_dataset

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLS_CFG = os.path.join(REPO, "configs", "cls", "cls_mbv3small.yml")

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
    det_pt, rec_pt, cls_pt = str(tmp / "det.pt"), str(tmp / "rec.pt"), str(tmp / "cls.pt")
    tool.convert(det_cfg, str(tmp / "det_ckpt"), det_pt)
    tool.convert(rec_cfg, str(tmp / "rec_ckpt"), rec_pt)
    cls_state = _decisive_cls_state(jax_train_state(CLS_CFG, (1, 48, 192, 3)), det_cfg, det_pt,
                                    pages)
    save_model(cls_state, {}, load_config(CLS_CFG), str(tmp), prefix="cls_ckpt")
    tool.convert(CLS_CFG, str(tmp / "cls_ckpt"), cls_pt)
    return dict(det_cfg=det_cfg, rec_cfg=rec_cfg, pages=pages, tmp=tmp,
                det_ckpt=str(tmp / "det_ckpt"), rec_ckpt=str(tmp / "rec_ckpt"),
                cls_ckpt=str(tmp / "cls_ckpt"), det_pt=det_pt, rec_pt=rec_pt, cls_pt=cls_pt)


def _crops(deter, pages):
    imgs = [cv2.imread(p) for p in pages]
    return [c for img, boxes in zip(imgs, deter.run_batch(imgs)) for c in crop_lines(img, boxes)]


def _decisive_cls_state(state, det_cfg, det_pt, pages):
    """decisive_cls_head_ on the port's cls model (bridged from `state`)
    over the float det model's crops of `pages`, written back into flax."""
    clser = Clser(CLS_CFG, None, device="cpu")
    model = clser.runner.model
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    load_flax_variables(model, variables)
    crops = _crops(Deter(det_cfg, det_pt, device="cpu"), pages)
    x = torch.from_numpy(np.stack([clser._prep(c) for c in crops])).permute(0, 3, 1, 2)
    decisive_cls_head_(model, x)
    params = jax.tree.map(np.array, variables["params"])
    params["head"]["fc"]["kernel"] = model.head.fc.weight.detach().numpy().T.copy()
    params["head"]["fc"]["bias"] = model.head.fc.bias.detach().numpy().copy()
    return state.replace(params=params)


def _jax_run_many(s, **kwargs):
    import infer_cls
    import infer_det
    import infer_rec
    from run_ocr import OCRer as JaxOCRer

    def f32(config, dtype=None):
        return jax_build_model(config["Architecture"], dtype=jnp.float32)

    patch = pytest.MonkeyPatch()
    for mod in (infer_det, infer_rec, infer_cls):
        patch.setattr(mod, "build_infer_model", f32)
    try:
        ocr = JaxOCRer(s["det_cfg"], s["det_ckpt"], s["rec_cfg"], s["rec_ckpt"], **kwargs)
        return ocr.run_many(s["pages"]), ocr
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def jax_result(slice_setup):
    return _jax_run_many(slice_setup)[0]


@pytest.fixture(scope="module")
def jax_result_cls_int8(slice_setup):
    """JAX run_many with the classifier and int8 detection; its calibrated
    det `quant` collection; and its int8 prob maps of the pages."""
    s = slice_setup
    result, ocr = _jax_run_many(s, cls_config=CLS_CFG, cls_model_path=s["cls_ckpt"],
                                det_quant=True)
    batch = np.concatenate([ocr.deter._preprocess(p)[0] for p in s["pages"]])
    maps = np.asarray(ocr.deter.runner(batch)["maps"])[..., 0]
    return result, jax.device_get(ocr.deter.runner.variables["quant"]), maps


def _assert_same_ocr(got, want):
    assert sum(len(page) for page in want) >= 2, "no text boxes found"
    assert len(got) == len(want)
    for page, want_page in zip(got, want):
        assert len(page) == len(want_page)
        for (box, text, prob), (wbox, wtext, wprob) in zip(page, want_page):
            np.testing.assert_array_equal(box, np.asarray(wbox))
            assert text == wtext
            assert abs(prob - wprob) <= 1e-4


def test_slice_matches_jax_run_many(slice_setup, jax_result):
    s = slice_setup
    ocr = OCRer(s["det_cfg"], s["det_pt"], s["rec_cfg"], s["rec_pt"], device="cpu")
    _assert_same_ocr(ocr.run_many(s["pages"]), jax_result)


def test_slice_with_cls_and_int8_det_matches_jax_run_many(slice_setup, jax_result_cls_int8):
    """run_many with the classifier and int8 detection. It calibrates lazily
    on the first page, to the JAX calibration within rtol 1e-5; then it runs
    with the JAX calibration bridged in (flax_quant_to_torch) against the
    JAX run_many. XLA and PyTorch round BN differently in the last bit, so
    where a value lies at a rounding boundary its int8 element lands a
    quantum apart, and through a random-weight network such differences
    spread (tests/test_torch_quant.py bounds them on a DB model); the seeded
    head, made text-like in float, then moves boxes. So the boxes are
    matched by rectangle IoU >= 0.5: hmean >= 0.75 (measured 0.87); a box
    equal on both sides reads the same text, through the same cls turn.
    Crops labelled "180" are turned before rec."""
    s = slice_setup
    want, qvars, _ = jax_result_cls_int8
    ocr = OCRer(s["det_cfg"], s["det_pt"], s["rec_cfg"], s["rec_pt"], CLS_CFG, s["cls_pt"],
                det_quant=True, device="cpu")
    before = int8_conv.launches
    assert sum(len(page) for page in ocr.run_many(s["pages"])) >= 2
    assert ocr.deter.runner.quant and int8_conv.launches == before  # CPU: the plain version
    model = ocr.deter.runner.model
    assert_absmax_match(model, qvars)
    flax_quant_to_torch(model, qvars)
    got = ocr.run_many(s["pages"])
    equal = 0
    for page, want_page in zip(got, want):
        texts = {tuple(np.asarray(b).reshape(-1)): t for b, t, _ in want_page}
        for box, text, _ in page:
            key = tuple(np.asarray(box).reshape(-1))
            if key in texts:
                assert texts[key] == text
                equal += 1
    assert sum(map(len, want)) >= 2 and rect_hmean(got, want) >= 0.75 and equal >= 1
    labels = ocr.clser.run_batch(_crops(ocr.deter, s["pages"]))
    assert {label for label, _ in labels} == {"0", "180"}


def _run_cli(s, out, *extra):
    """The port's CLI in a subprocess on the first page; its res_*.txt rows.
    The subprocess also checks that no module of jax, flax or the JAX
    package loaded."""
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
           "--img_path", s["pages"][0], "--out_dir", str(out), "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stem = os.path.splitext(os.path.basename(s["pages"][0]))[0]
    return (out / ("res_%s.txt" % stem)).read_text(encoding="UTF-8").splitlines()


def _rows(page):
    return [",".join([str(v) for v in np.asarray(box).reshape(-1).tolist()] + [text, str(prob)])
            for box, text, prob in page]


def test_cli_writes_res_txt(slice_setup, jax_result):
    """The port's CLI on the CPU writes the JAX CLI's res_*.txt rows."""
    s = slice_setup
    assert _run_cli(s, s["tmp"] / "cli_out") == _rows(jax_result[0])


def test_cli_with_cls_and_det_quant_writes_res_txt(slice_setup):
    """--cls_config/--cls_model_path and --det_quant: the CLI calibrates on
    its one page and writes the rows of OCRer.run_many on that page."""
    s = slice_setup
    rows = _run_cli(s, s["tmp"] / "cli_q_out", "--cls_config", CLS_CFG,
                    "--cls_model_path", s["cls_pt"], "--det_quant")
    ocr = OCRer(s["det_cfg"], s["det_pt"], s["rec_cfg"], s["rec_pt"], CLS_CFG, s["cls_pt"],
                det_quant=True, device="cpu")
    want = ocr.run_many(s["pages"][:1])[0]
    assert rows and rows == _rows(want)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Runner(torch.nn.Identity(), device="cuda")



def test_int8_moves_the_seeded_boxes_as_far_as_in_jax(slice_setup, jax_result, jax_result_cls_int8):
    """int8 against float boxes (rectangle IoU >= 0.5) on the seeded slice:
    the port's hmean lies within 0.2 of the JAX package's (measured 0.53 in
    JAX). The seeded head, made text-like in float, keeps its threshold a
    hair from the nearest pixel, so int8 moves its boxes in both; a trained
    detector keeps 0.9 (tests/test_quant.py:258)."""
    s = slice_setup
    want, qvars, _ = jax_result_cls_int8
    jax_h = rect_hmean(want, jax_result)
    float_ocr = OCRer(s["det_cfg"], s["det_pt"], s["rec_cfg"], s["rec_pt"], device="cpu")
    ocr = OCRer(s["det_cfg"], s["det_pt"], s["rec_cfg"], s["rec_pt"], det_quant=True,
                device="cpu")
    ocr.deter.runner.quant = True
    flax_quant_to_torch(ocr.deter.runner.model, qvars)
    h = rect_hmean(ocr.run_many(s["pages"]), float_ocr.run_many(s["pages"]))
    assert abs(h - jax_h) <= 0.2, (h, jax_h)
