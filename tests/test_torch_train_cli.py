"""The port's training and eval CLIs, `python -m pytorchocr_tpu_torch.tools.train`
and `.eval`, in subprocesses on the CPU (`-o Global.use_gpu=False`) with a
small DB config: 2 train steps, one eval, `latest` and `best_accuracy`
written, the eval CLI reading the checkpoint back to the train run's
metric; neither process loads a module of jax, flax or the JAX package.
`Global.use_gpu: True` without a card raises."""

import json
import os
import subprocess
import sys

import pytest
import torch

from pytorchocr_tpu_torch.tools import program
from torch_port_util import tiny_db_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = (
    "import importlib, json, sys\n"
    "mod = importlib.import_module(sys.argv[1])\n"
    "out = mod.run(sys.argv[2:])\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pytorchocr_tpu'))\n"
    "assert not bad, bad\n"
    "out = {k: v for k, v in out.items() if k in ('steps', 'hmean', 'precision', 'recall', 'best')}\n"
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
    cfg = tiny_db_config(tmp / "cfg.yml", label, label, tmp / "out")
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
    assert "Global.distributed: True with one process" in trained["log"]
    assert "TF32 off" in trained["log"]


def test_eval_cli_reads_the_checkpoint_back(trained):
    best = trained["report"]["best"]
    got, _ = _run("pytorchocr_tpu_torch.tools.eval", "-c", trained["cfg"], "-o",
                  "Global.use_gpu=False",
                  "Global.checkpoints=%s" % (trained["tmp"] / "out" / "best_accuracy"))
    for k in ("precision", "recall", "hmean"):
        assert got[k] == best[k], k


def test_use_gpu_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_gpu"):
        program.select_device({"use_gpu": True})
    assert program.select_device({"use_gpu": False}) == torch.device("cpu")
