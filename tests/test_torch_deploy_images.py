"""The result images of the port's deploy CLIs against the JAX package's, on
the CPU: each drawing function of pytorchocr_tpu_torch/deploy/utils.py (a
copy of deploy/utils.py) gives the JAX function's pixels on the same boxes
and texts, with an explicit TrueType font and with the fallback search; the
four CLIs write res_<name>.jpg beside res_<name>.txt (run_ocr's image is
the page with the rows of its res_*.txt drawn); `--show` without a display
warns and goes on."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "deploy")))

import utils as jutils  # the JAX package's deploy/utils.py

from pytorchocr_tpu_torch.deploy import infer_cls, infer_det, infer_rec, run_ocr
from pytorchocr_tpu_torch.deploy import utils as tutils
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.seeded import seeded_init_, text_like_db_head_

from synth import make_det_dataset

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLS_CFG = os.path.join(REPO, "configs", "cls", "cls_mbv3small.yml")
DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
FONTS = [None] + ([DEJAVU] if os.path.exists(DEJAVU) else [])

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
  Head: {name: CTCHead, out_channels: 37}
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


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A drawn 224x224 page, a DB-ResNet18 (FPN 32) whose seeded head maps
    its dark text to boxes, a seeded CRNN and direction classifier, each
    saved as a .pt state_dict; one line crop of the page."""
    tmp = tmp_path_factory.mktemp("images")
    (tmp / "det.yml").write_text(DET_CFG)
    (tmp / "rec.yml").write_text(REC_CFG)
    label = make_det_dataset(str(tmp / "pages"), n=1, size=224, seed=3)
    page = label.replace("det_label.txt", "det_0000.png")
    deter = Deter(str(tmp / "det.yml"), None, device="cpu")
    model = seeded_init_(deter.runner.model, torch.Generator().manual_seed(0))
    img = deter._preprocess(cv2.imread(page))[0]
    x = ((torch.from_numpy(img).float() / 255.0 - deter.runner.mean) / deter.runner.std)
    dark = cv2.cvtColor(img[0], cv2.COLOR_RGB2GRAY) < 128
    text_like_db_head_(model, x.permute(0, 3, 1, 2), dark)
    out = dict(tmp=tmp, page=page, det_cfg=str(tmp / "det.yml"), rec_cfg=str(tmp / "rec.yml"))
    out["det_pt"] = str(tmp / "det.pt")
    torch.save(model.state_dict(), out["det_pt"])
    for kind, cfg in (("rec", out["rec_cfg"]), ("cls", CLS_CFG)):
        net = seeded_init_(build_model(load_config(cfg)["Architecture"]),
                           torch.Generator().manual_seed(1))
        out[kind + "_pt"] = str(tmp / (kind + ".pt"))
        torch.save(net.state_dict(), out[kind + "_pt"])
    boxes = Deter(out["det_cfg"], out["det_pt"], device="cpu").run(page)
    assert len(boxes) > 0
    out["boxes"] = boxes
    x0, y0 = np.asarray(boxes[0]).min(0).astype(int)
    x1, y1 = np.asarray(boxes[0]).max(0).astype(int)
    out["crop"] = str(tmp / "crop.png")
    cv2.imwrite(out["crop"], cv2.imread(page)[y0:y1 + 1, x0:x1 + 1])
    return out


def _same_pixels(got, want, got_path, want_path):
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(got_path), cv2.imread(want_path))


def test_draw_det_res_equals_jax(served, tmp_path):
    got = tutils.draw_det_res(served["boxes"], served["page"], str(tmp_path / "t.jpg"))
    want = jutils.draw_det_res(served["boxes"], served["page"], str(tmp_path / "j.jpg"))
    _same_pixels(got, want, str(tmp_path / "t.jpg"), str(tmp_path / "j.jpg"))


@pytest.mark.parametrize("font", FONTS, ids=lambda f: "fallback" if f is None else "ttf")
@pytest.mark.parametrize("fn", ["draw_rec_res", "draw_cls_res"])
def test_draw_rec_and_cls_res_equal_jax(served, tmp_path, fn, font):
    text = "hello" if fn == "draw_rec_res" else "180"
    got = getattr(tutils, fn)(text, 0.97, served["crop"], str(tmp_path / "t.jpg"), font)
    want = getattr(jutils, fn)(text, 0.97, served["crop"], str(tmp_path / "j.jpg"), font)
    _same_pixels(got, want, str(tmp_path / "t.jpg"), str(tmp_path / "j.jpg"))


@pytest.mark.parametrize("font", FONTS, ids=lambda f: "fallback" if f is None else "ttf")
def test_draw_ocr_res_equals_jax(served, tmp_path, font):
    res = [[np.asarray(b), "w%d" % i, 0.5 + 0.01 * i] for i, b in enumerate(served["boxes"])]
    got = tutils.draw_ocr_res(res, served["page"], str(tmp_path / "t.jpg"), font)
    want = jutils.draw_ocr_res(res, served["page"], str(tmp_path / "j.jpg"), font)
    _same_pixels(got, want, str(tmp_path / "t.jpg"), str(tmp_path / "j.jpg"))


def _parse_ocr_rows(path):
    rows = []
    for line in open(path, encoding="UTF-8").read().splitlines():
        parts = line.split(",")
        coords = np.array([int(v) for v in parts[:8]]).reshape(4, 2)
        rows.append([coords, ",".join(parts[8:-1]), float(parts[-1])])
    return rows


def test_the_four_clis_write_res_jpg(served, tmp_path, monkeypatch, capsys):
    """infer_det, infer_rec, infer_cls and run_ocr on the CPU write
    res_<name>.jpg of the input's size beside res_<name>.txt; run_ocr's is
    the page with its res_*.txt rows drawn (draw_ocr_res). With `--show`
    and no display each warns and writes the same files."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    page, crop = served["page"], served["crop"]
    runs = {
        "det": (infer_det, page, ["--config", served["det_cfg"], "--model_path",
                                  served["det_pt"]]),
        "rec": (infer_rec, crop, ["--config", served["rec_cfg"], "--model_path",
                                  served["rec_pt"]]),
        "cls": (infer_cls, crop, ["--config", CLS_CFG, "--model_path", served["cls_pt"]]),
        "ocr": (run_ocr, page, ["--det_config", served["det_cfg"], "--det_model_path",
                                served["det_pt"], "--rec_config", served["rec_cfg"],
                                "--rec_model_path", served["rec_pt"]]),
    }
    for name, (cli, image, args) in runs.items():
        out = tmp_path / name
        stem = os.path.splitext(os.path.basename(image))[0]
        monkeypatch.setattr(sys, "argv", [name] + args + [
            "--img_path", image, "--out_dir", str(out), "--device", "cpu", "--show"])
        cli.main()
        assert "--show ignored: no display" in capsys.readouterr().out
        assert (out / ("res_%s.txt" % stem)).exists()
        jpg = cv2.imread(str(out / ("res_%s.jpg" % stem)))
        assert jpg is not None and jpg.shape == cv2.imread(image).shape
    rows = _parse_ocr_rows(tmp_path / "ocr" / "res_det_0000.txt")
    assert len(rows) == len(served["boxes"]) > 0
    tutils.draw_ocr_res(rows, page, str(tmp_path / "again.jpg"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ocr" / "res_det_0000.jpg")),
                                  cv2.imread(str(tmp_path / "again.jpg")))
