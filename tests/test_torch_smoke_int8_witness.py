"""chip_smoke.py phase 21 (a)'s witness and control for the int8 zoo, on the
CPU at small sizes: `nudged_payloads` runs a seeded RepVGG-A0 DB int8
forward with every absmax moved a few ulps (and the deploy form's float
backbone in float64) and with every absmax moved 2^-10, and leaves the
model as it found it: the same float32 parameters, the same scales, the
int8 conv's wrapper back in place, the next forward bit for bit the first."""

import os
import sys

import cv2
import pytest
import torch

import chip_smoke
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.ops import int8_conv
from pytorchocr_tpu_torch.utils.config import load_config, save_config
from pytorchocr_tpu_torch.utils.seeded import seeded_init_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))


def _repvgg(tmp_path, deploy):
    """A seeded RepVGG-A0 DB config read at 128 on the short side, its .pt,
    and with `deploy` chip_smoke.repvgg_fold's folded form of it."""
    cfg = load_config(os.path.join(REPO, "configs", "det", "det_repvgg_db_synth.yml"))
    for op in cfg["Eval"]["dataset"]["transforms"]:
        if "DetResizeForTest" in op:
            op["DetResizeForTest"] = {"limit_side_len": 128, "limit_type": "min"}
    path = str(tmp_path / "repvgg.yml")
    save_config(cfg, path)
    model = build_model(cfg["Architecture"])
    seeded_init_(model, torch.Generator().manual_seed(0))
    pt = str(tmp_path / "det.pt")
    torch.save(model.state_dict(), pt)
    if deploy:
        pt, path = chip_smoke.repvgg_fold(str(tmp_path), path, pt)[:2]
    return path, pt


@pytest.mark.parametrize("deploy", [False, True])
def test_witness_and_control_leave_the_model_as_it_was(tmp_path, deploy):
    import synth

    label = synth.make_det_dataset(str(tmp_path / "imgs"), n=2, size=192, seed=5)
    pages = [label.replace("det_label.txt", "det_%04d.png" % i) for i in range(2)]
    cfg, pt = _repvgg(tmp_path, deploy)
    deter = Deter(cfg, pt, device="cpu", quant=True)
    deter.calibrate_on([cv2.imread(pages[0])])
    model = deter.runner.model
    absmax = chip_smoke._absmax_state(model)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    wrapper = int8_conv.int8_conv
    first = chip_smoke._int8_payloads(deter, pages)
    assert list(first)[0] == chip_smoke.INT8_CONV2_INPUT and "neck" in first

    got = chip_smoke.nudged_payloads(deter, pages, absmax, first)
    assert got["float64 backbone"] is deploy
    assert list(got["witness"]) == list(got["control"]) == list(first)
    # the control moves the early payload; each reading counts within its payload
    assert got["control"][chip_smoke.INT8_CONV2_INPUT][0] > 0
    for reading in (*got["witness"].values(), *got["control"].values()):
        apart, n, by_one, most = reading
        assert 0 <= by_one <= apart <= n and (most > 0) == (apart > 0)

    assert int8_conv.int8_conv is wrapper
    after = model.state_dict()
    assert all(after[k].dtype == v.dtype and torch.equal(after[k], v) for k, v in state.items())
    assert all(torch.equal(v, absmax[k]) for k, v in chip_smoke._absmax_state(model).items())
    again = chip_smoke._int8_payloads(deter, pages)
    assert all(r[0] == 0 for r in chip_smoke.payloads_apart(first, again).values())
