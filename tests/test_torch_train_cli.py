"""The port's training and eval CLIs, `python -m pytorchocr_tpu_torch.tools.train`
and `.eval`, in subprocesses on the CPU (`-o Global.use_gpu=False`) with a
small DB config: 2 train steps, one eval, `latest` and `best_accuracy`
written, the eval CLI reading the checkpoint back to the train run's
metric; neither process loads a module of jax, flax or the JAX package.
The same for a small CRNN and a small classifier (their eval run in
process), whose checkpoint directory the serving CLIs (`deploy.infer_rec`,
`deploy.infer_cls`) then load: their texts and labels, and their
probabilities as the CLIs write them (2 places), equal the eval post
process's on the same lines; so do the CLIs' serving classes on a bare .pt
of the same model.
`Global.use_gpu: True` without a card raises."""

import json
import os
import subprocess
import sys

import pytest
import torch

from pytorchocr_tpu_torch.deploy.infer_cls import Clser
from pytorchocr_tpu_torch.deploy.infer_rec import Recer
from pytorchocr_tpu_torch.tools import eval as eval_cli
from pytorchocr_tpu_torch.tools import program
from torch_port_util import tiny_det_config, tiny_rec_cls_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = (
    "import importlib, json, sys\n"
    "mod = importlib.import_module(sys.argv[1])\n"
    "out = mod.run(sys.argv[2:])\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pytorchocr_tpu'))\n"
    "assert not bad, bad\n"
    "keys = ('steps', 'hmean', 'precision', 'recall', 'acc', 'norm_edit_dis', 'best')\n"
    "out = {k: v for k, v in out.items() if k in keys}\n"
    "print('RESULT ' + json.dumps(out))\n"
)


def _run(module, *argv):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, module, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):]), proc.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import synth

    tmp = tmp_path_factory.mktemp("cli")
    label = synth.make_det_dataset(str(tmp / "data"), n=4, size=160, seed=3)
    cfg = tiny_det_config(tmp / "cfg.yml", "configs/det/det_r18_db_synth.yml", label, label,
                          tmp / "out")
    report, log = _run("pytorchocr_tpu_torch.tools.train", "-c", cfg,
                       "-o", "Global.use_gpu=False", "Global.seed=5")
    return dict(tmp=tmp, cfg=cfg, report=report, log=log)


def test_train_cli_trains_evaluates_and_checkpoints(trained):
    out = trained["tmp"] / "out"
    assert trained["report"]["steps"] == 2
    for prefix in ("latest", "best_accuracy"):
        assert (out / prefix / "state.pt").is_file()
        assert json.loads((out / prefix / "global_state.json").read_text())["global_step"] == 2
    assert (out / "config.yml").is_file() and (out / "train.log").is_file()
    assert "cur metric, precision:" in trained["log"]
    assert "Global.distributed: True without the torchrun environment" in trained["log"]
    assert "TF32 off" in trained["log"]


def test_eval_cli_reads_the_checkpoint_back(trained):
    best = trained["report"]["best"]
    got, _ = _run("pytorchocr_tpu_torch.tools.eval", "-c", trained["cfg"], "-o",
                  "Global.use_gpu=False",
                  "Global.checkpoints=%s" % (trained["tmp"] / "out" / "best_accuracy"))
    for k in ("precision", "recall", "hmean"):
        assert got[k] == best[k], k


@pytest.fixture(scope="module", params=["rec", "cls"])
def trained_rec_cls(request, tmp_path_factory):
    import synth

    kind = request.param
    tmp = tmp_path_factory.mktemp("cli_" + kind)
    if kind == "rec":
        label = synth.make_rec_dataset(str(tmp / "data"), n=10, charset="0123456789abc",
                                       seed=3)
    else:
        label = synth.make_cls_dataset(str(tmp / "data"), n=10, seed=3)
    cfg = tiny_rec_cls_config(tmp / "cfg.yml", kind, label, label, tmp / "out")
    report, log = _run("pytorchocr_tpu_torch.tools.train", "-c", cfg,
                       "-o", "Global.use_gpu=False", "Global.seed=5")
    return dict(kind=kind, tmp=tmp, cfg=cfg, label=label, report=report, log=log)


def _eval_reading(cfg_path, ckpt):
    """{image stem: (text or label, its probability to 2 places, as the
    serving CLIs write it)} of the eval post process over the config's eval
    loader, the model read from the checkpoint directory."""
    from pytorchocr_tpu_torch.data import build_dataloader
    from pytorchocr_tpu_torch.postprocess import build_post_process
    from pytorchocr_tpu_torch.tools.train import build_train_model, set_head_channels
    from pytorchocr_tpu_torch.trainer import make_eval_step
    from pytorchocr_tpu_torch.utils.config import load_config
    from pytorchocr_tpu_torch.utils.logging import get_logger
    from pytorchocr_tpu_torch.utils.save_load import load_model

    cfg = load_config(cfg_path)
    cfg["Global"]["checkpoints"] = str(ckpt)
    loader, _ = build_dataloader(cfg, "Eval", get_logger())
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    set_head_channels(cfg, post)
    model = build_train_model(cfg, torch.device("cpu"))
    load_model(cfg, model)
    eval_step = make_eval_step(model)
    read = []
    for batch in loader:
        read += [(t, round(float(p), 2)) for t, p in post(eval_step(torch.from_numpy(batch[0])))]
    stems = [os.path.splitext(os.path.basename(ln.decode().split("\t")[0]))[0]
             for ln in loader.dataset.data_lines]
    return dict(zip(stems, read))


def test_rec_cls_train_eval_and_serve_from_the_checkpoint(trained_rec_cls):
    t = trained_rec_cls
    out = t["tmp"] / "out"
    assert t["report"]["steps"] == 2
    for prefix in ("latest", "best_accuracy"):
        assert (out / prefix / "state.pt").is_file()
    assert "cur metric, acc:" in t["log"] and ", acc: " in t["log"].split("cur metric")[0]
    best = t["report"]["best"]
    got = eval_cli.run(["-c", t["cfg"], "-o", "Global.use_gpu=False",
                        "Global.checkpoints=%s" % (out / "best_accuracy")])
    for k in ("acc", "norm_edit_dis") if t["kind"] == "rec" else ("acc",):
        assert got[k] == best[k], k

    want = _eval_reading(t["cfg"], out / "best_accuracy")
    assert len(want) == 10
    res = t["tmp"] / "res"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorchocr_tpu_torch.deploy.infer_" + t["kind"], "--config",
         t["cfg"], "--model_path", str(out / "best_accuracy"), "--img_path",
         str(t["tmp"] / "data"), "--out_dir", str(res), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = {}
    for f in res.glob("res_*.txt"):
        text, prob = f.read_text().rstrip("\n").rsplit(",", 1)
        served[f.name[len("res_"):-len(".txt")]] = (text, float(prob))
    assert served == want

    # a bare .pt of the same model, through the serving class the CLI builds
    torch.save(torch.load(out / "best_accuracy" / "state.pt", weights_only=True)["model"],
               t["tmp"] / "bare.pt")
    server = (Recer if t["kind"] == "rec" else Clser)(t["cfg"], str(t["tmp"] / "bare.pt"),
                                                      device="cpu")
    images = sorted((t["tmp"] / "data").glob("*.png"))
    assert {p.stem: server.run(str(p)) for p in images} == want


def test_use_gpu_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_gpu"):
        program.select_device({"use_gpu": True})
    assert program.select_device({"use_gpu": False}) == torch.device("cpu")
