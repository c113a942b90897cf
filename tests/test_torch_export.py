"""Export and multi-replica serving of the port's deploy runtime, on the CPU:
a small DB model's eval forward through torch.export, saved as .pt2 and
loaded, against the eager forward and against the JAX package's export of
the same weights (deploy/common.py `export_serialized` / `load_serialized`);
`python -m pytorchocr_tpu_torch.deploy.export_model` (export, then --run)
on a config's model; a Runner over two replicas against one, bit for bit,
as the JAX package's test_jitrunner_data_parallel_serving holds its mesh."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "deploy")))

import common as jcommon  # the JAX package's deploy/common.py

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu_torch.deploy import export_model
from pytorchocr_tpu_torch.deploy.common import (
    Runner, export_program, load_program, save_program,
)
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.utils.seeded import seeded_init_
from torch_port_util import DEEP, nchw, shaped_pair

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

DB_ARCH = {"model_type": "det", "algorithm": "DB", "Transform": None,
           "Backbone": {"name": "ResNet", "layers": 18},
           "Neck": {"name": "FPN", "out_channels": 32, "mode": "DB"},
           "Head": {"name": "DBHead", "k": 50}}


@pytest.fixture(scope="module")
def db_pair():
    x = np.random.RandomState(2).rand(2, 64, 96, 3).astype(np.float32)
    jmod, tmod = jax_build_model(DB_ARCH), build_model(DB_ARCH)
    variables, _ = shaped_pair(jmod, tmod, x, seed=4)
    return x, jmod, tmod, variables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_exported_program_round_trip_equals_the_eager_forward(db_pair, tmp_path, dtype):
    """Exported, saved to .pt2, loaded: the maps of float32 NHWC images, in
    the compute dtype, equal to the eager forward under the same autocast
    within 1e-6 (the exported graph runs its own decompositions, e.g. of
    eval-mode BN; measured 2.4e-7 in float32, 0 in bf16)."""
    x, _, tmod, _ = db_pair
    path = str(tmp_path / "db.pt2")
    size = save_program(export_program(tmod, x.shape, torch.device("cpu"), dtype), path)
    assert size > 1e6
    fn = load_program(path)
    with torch.no_grad():
        got = fn(torch.from_numpy(x))
        with torch.autocast("cpu", dtype=dtype, enabled=dtype != torch.float32):
            want = tmod(nchw(x))["maps"].to(dtype)
    assert got.dtype == dtype and got.shape == (2, 64, 96, 1)  # NHWC, the JAX layout
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_export_matches_the_jax_export(db_pair, tmp_path):
    """The same weights through JAX deploy/common.py's export_serialized and
    load_serialized (a float32 model, as the test can run it on the CPU)
    and through the port's .pt2: the maps within DEEP (atol 2e-3, rtol
    1e-3; XLA:CPU and oneDNN sum in different orders)."""
    x, jmod, tmod, variables = db_pair

    def forward(images):
        return jmod.apply(variables, images.astype(jnp.float32), train=False)["maps"]

    blob = jcommon.export_serialized(forward, jnp.zeros(x.shape, jnp.float32))
    want = np.asarray(jcommon.load_serialized(blob)(jnp.asarray(x)))
    path = str(tmp_path / "db.pt2")
    save_program(export_program(tmod, x.shape, torch.device("cpu"), torch.float32), path)
    with torch.no_grad():
        got = load_program(path)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **DEEP)


def test_export_model_cli_exports_and_runs_on_the_cpu(tmp_path, capsys):
    """export_model.main on det_r18_db.yml's model (seeded weights as a .pt)
    writes a .pt2 of its maps; --run loads it and times one call."""
    cfg = os.path.join(REPO, "configs", "det", "det_r18_db.yml")
    from pytorchocr_tpu_torch.utils.config import load_config

    model = seeded_init_(build_model(load_config(cfg)["Architecture"]),
                         torch.Generator().manual_seed(0))
    pt, out = str(tmp_path / "det.pt"), str(tmp_path / "det.pt2")
    torch.save(model.state_dict(), pt)
    export_model.main(["--config", cfg, "--model_path", pt, "--shape", "1,64,64,3",
                       "--out", out, "--device", "cpu"])
    assert "exported %s" % out in capsys.readouterr().out
    export_model.main(["--run", out, "--shape", "1,64,64,3", "--device", "cpu"])
    assert "output (1, 64, 64, 1) float32 in" in capsys.readouterr().out
    maps, ms = export_model.run(out, (1, 64, 64, 3), "cpu")
    assert maps.shape == (1, 64, 64, 1) and maps.dtype == torch.float32 and ms > 0
    assert bool(((maps >= 0) & (maps <= 1)).all())
    assert "on the CPU" in capsys.readouterr().out


def test_runner_data_parallel_serving(tmp_path):
    """A Runner over two replicas (both on the CPU) pads the batch to a
    multiple of two, runs half on each and gathers in order: float32
    outputs bit for bit one replica's, for a batch of 4 and a batch of 3;
    int8 after one calibration, the replicas' scales equal to the first's."""
    model = seeded_init_(build_model(DB_ARCH), torch.Generator().manual_seed(5))
    x = (np.random.RandomState(0).rand(4, 64, 64, 3) * 255).astype(np.uint8)
    norm = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    torch.save(model.state_dict(), tmp_path / "db.pt")
    single = Runner(model, "cpu", **norm)
    dp = Runner(build_model(DB_ARCH), ["cpu", "cpu"], **norm).load_state(str(tmp_path / "db.pt"))
    assert len(dp.replicas) == 2 and dp.replicas[1] is not dp.model
    second = dp.replicas[1].state_dict()
    assert all(torch.equal(v, second[k]) for k, v in model.state_dict().items())
    for batch in (x, x[:3]):
        got, want = dp(batch)["maps"], single(batch)["maps"]
        assert got.shape[0] == len(batch)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    single.calibrate([x[:2]])
    dp.calibrate([x[:2]])
    scales = [{n: float(m.value) for n, m in r.named_modules() if hasattr(m, "calibrated")
               and m.calibrated} for r in dp.replicas]
    assert scales[0] == scales[1] and len(scales[0]) == 60
    torch.testing.assert_close(dp(x[:3])["maps"], single(x[:3])["maps"], rtol=0, atol=0)
