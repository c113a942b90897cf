"""The port's direction classifier against the JAX package, float32 on the
CPU: ClsResizeImg, the recognition MobileNetV3 (small x0.35, the width of
configs/cls/cls_mbv3small.yml), ClsHead, ClsPostProcess and `Clser.run_batch`
against the JAX `Clser` on the same crops with the same weights (through the
weight bridge).

Tolerances: the host resize is exact; the backbone is a deep float32 stack
(DEEP, as tests/test_torch_modules.py holds ResNet: XLA:CPU and oneDNN sum
convolutions in other orders); the head's softmax at 1e-6. Untrained
weights give p ~ 0.5 on every crop, so the fc is first made decisive on the
crops (utils.seeded.decisive_cls_head_) and the same values are written
into the JAX variables; the crop nearest a tie lies over 0.05 in logits
from it, far beyond the float32 differences, so the labels must be equal,
and the probs, rounded to 2 places by both Clsers, within 0.01."""

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

from pytorchocr_tpu.data.imaug.rec_img_aug import ClsResizeImg as JClsResizeImg
from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.postprocess.cls_postprocess import ClsPostProcess as JClsPostProcess
from pytorchocr_tpu.utils.config import load_config
from pytorchocr_tpu_torch.data.imaug import ClsResizeImg
from pytorchocr_tpu_torch.deploy.infer_cls import Clser
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.utils.seeded import decisive_cls_head_
from pytorchocr_tpu_torch.utils.weights import load_flax_variables
from torch_port_util import DEEP, init_pair, nchw, nhwc

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLS_CFG = os.path.join(REPO, "configs", "cls", "cls_mbv3small.yml")


def make_crops(n, seed):
    """Text-line crops of several sizes, drawn with cv2, half of them upside
    down."""
    rng = np.random.RandomState(seed)
    crops = []
    for i in range(n):
        h, w = int(rng.randint(20, 44)), int(rng.randint(60, 260))
        img = np.full((h, w, 3), int(rng.randint(200, 256)), np.uint8)
        cv2.putText(img, "ab%dxy" % i, (2, h - 6), cv2.FONT_HERSHEY_SIMPLEX, h / 40.0,
                    (20, 20, 20), 2)
        crops.append(cv2.rotate(img, cv2.ROTATE_180) if i % 2 else img)
    return crops


def test_cls_resize_img_equals_jax():
    for i, crop in enumerate(make_crops(4, 0)):
        shape = [3, 48, 192] if i % 2 else [3, 32, 100]
        got = ClsResizeImg(shape)({"image": crop.copy()})["image"]
        want = JClsResizeImg(shape)({"image": crop.copy()})["image"]
        assert got.shape == want.shape == (shape[1], shape[2], 3)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cls_pair():
    """The cls config's model (MobileNetV3 small x0.35 + ClsHead) in JAX and
    in the port, with bridged randomised weights, and both outputs on two
    48x192 inputs (backbone features and head probabilities)."""
    arch = dict(load_config(CLS_CFG)["Architecture"], return_all_feats=True)
    jmod, tmod = jax_build_model(arch), build_model(arch)
    x = np.random.RandomState(1).randn(2, 48, 192, 3).astype(np.float32)
    variables, apply = init_pair(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    return variables, got, apply(variables, x)


def test_mobilenet_v3_small_and_cls_head_match_jax(cls_pair):
    _, got, want = cls_pair
    feats, jfeats = nhwc(got["backbone_out"]), np.asarray(want["backbone_out"])
    assert feats.shape == jfeats.shape == (2, 1, 48, 192)
    np.testing.assert_allclose(feats, jfeats, **DEEP)
    probs = got["head_out"].numpy()
    np.testing.assert_allclose(probs, np.asarray(want["head_out"]), atol=1e-6, rtol=1e-5)
    assert got["head_out"].dtype == torch.float32 and np.allclose(probs.sum(1), 1.0)


def test_cls_postprocess_equals_jax():
    rng = np.random.RandomState(2)
    preds = rng.rand(6, 2).astype(np.float32)
    labels = rng.randint(0, 2, 6)
    post = build_post_process({"name": "ClsPostProcess", "label_list": ["0", "180"]})
    want = JClsPostProcess(label_list=["0", "180"])(preds, labels)
    assert post(torch.from_numpy(preds), labels) == want
    assert post(preds) == want[0]


def test_clser_run_batch_matches_jax(cls_pair, tmp_path):
    """`Clser.run_batch` against the JAX Clser on the same crops and weights:
    the fc of the bridged weights made decisive on the crops."""
    import infer_cls

    crops = make_crops(12, 3)
    variables = jax.tree.map(np.array, cls_pair[0])
    clser = Clser(CLS_CFG, None, device="cpu")
    model = clser.runner.model
    load_flax_variables(model, variables)
    x = torch.from_numpy(np.stack([clser._prep(c) for c in crops])).permute(0, 3, 1, 2)
    assert decisive_cls_head_(model, x) > 0.05
    variables["params"]["head"]["fc"]["kernel"] = model.head.fc.weight.detach().numpy().T.copy()
    variables["params"]["head"]["fc"]["bias"] = model.head.fc.bias.detach().numpy().copy()

    patch = pytest.MonkeyPatch()
    patch.setattr(infer_cls, "build_infer_model",
                  lambda config, dtype=None: jax_build_model(config["Architecture"],
                                                             dtype=jnp.float32))
    patch.setattr(infer_cls, "load_variables", lambda ckpt: variables)
    try:
        want = infer_cls.Clser(CLS_CFG, "bridged").run_batch(crops)
    finally:
        patch.undo()
    got = clser.run_batch(crops)
    assert len(got) == len(want) == 12
    assert 3 <= sum(label == "180" for label, _ in got) <= 9
    for (label, p), (wlabel, wp) in zip(got, want):
        assert label == wlabel
        assert abs(p - wp) <= 0.01
    img = tmp_path / "crop.png"
    cv2.imwrite(str(img), crops[1])
    assert clser.run(str(img)) == got[1]


def test_infer_cls_cli_writes_label_prob(cls_pair, tmp_path):
    """`python -m pytorchocr_tpu_torch.deploy.infer_cls` on the CPU writes
    res_<name>.txt as `label,prob`, the rows of Clser.run, and loads no
    module of jax, flax or the JAX package."""
    crops = make_crops(3, 5)
    imgs = tmp_path / "crops"
    imgs.mkdir()
    for i, crop in enumerate(crops):
        cv2.imwrite(str(imgs / ("c%d.png" % i)), crop)
    clser = Clser(CLS_CFG, None, device="cpu")
    load_flax_variables(clser.runner.model, jax.tree.map(np.array, cls_pair[0]))
    pt = str(tmp_path / "cls.pt")
    torch.save(clser.runner.model.state_dict(), pt)
    script = (
        "import sys; sys.argv = sys.argv[:1] + sys.argv[2:];"
        "from pytorchocr_tpu_torch.deploy import infer_cls; infer_cls.main();"
        "bad = [m for m in sys.modules"
        "       if m.split('.')[0] in ('jax', 'flax', 'pytorchocr_tpu')];"
        "assert not bad, bad"
    )
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, "-c", script, "--", "--config", CLS_CFG,
                           "--model_path", pt, "--img_path", str(imgs), "--out_dir", str(out),
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    clser = Clser(CLS_CFG, pt, device="cpu")
    for i in range(3):
        label, prob = clser.run(str(imgs / ("c%d.png" % i)))
        assert (out / ("res_c%d.txt" % i)).read_text() == "%s,%s\n" % (label, prob)
