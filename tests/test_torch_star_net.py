"""STAR-Net in the port against the JAX package, on the CPU: the JAX bilinear
sampler `grid_sample_bilinear` (values and gradients, inside and outside
[-1, 1]), where `F.grid_sample` differs from it, the TPS transform, and a
small STAR-Net (TPS small, VGG v1 x0.5, BiLSTM 32, CTC over 37 classes)
with its CTC texts; the published config served through `infer_rec`; two
train steps across the transform's unfreeze against the JAX make_train_step
and a small STAR-Net through train -> eval -> serve.

The TPS's localization net is seeded as a perturbation of RARE's init: its
fc2 weight small and random, its fiducial bias stretched by 1.15, so that
the grid depends on the input and part of it leaves [-1, 1], where the JAX
rule and `F.grid_sample` part. Tolerances: the sampler and its gradients
within 1e-6 (float32); the TPS and the whole model at DEEP (atol 2e-3, rtol
1e-3); CTC texts equal."""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.modeling.transforms.tps import TPS as JTPS
from pytorchocr_tpu.modeling.transforms.tps import grid_sample_bilinear as jax_grid_sample
from pytorchocr_tpu.postprocess import build_post_process as jax_build_post
from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.deploy import infer_rec
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.modeling.transforms.tps import TPS, grid_sample_bilinear
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import eval as eval_cli
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.seeded import decisive_ctc_head_, seeded_init_
from pytorchocr_tpu_torch.utils.weights import load_flax_variables
from torch_port_util import (DEEP, nchw, nhwc, perturbed_tps_params, shaped_variables,
                             tiny_rec_cls_config, train_cli)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

STARNET = {
    "model_type": "rec", "algorithm": "STARNet", "in_channels": 1,
    "Transform": {"name": "TPS", "num_fiducial": 20, "model_name": "small"},
    "Backbone": {"name": "VGG", "model_name": "v1", "scale": 0.5},
    "Neck": {"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 32},
    "Head": {"name": "CTCHead", "out_channels": 37},
}


def _grid(rng, n, h, w, lo=-1.5, hi=1.5):
    return rng.uniform(lo, hi, (n, h, w, 2)).astype(np.float32)


def test_grid_sample_matches_jax_inside_and_outside():
    """Values and the gradients with respect to the image and the grid
    (through wx, wy), on a grid of which about a half lies outside [-1, 1]."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 5, 7, 3).astype(np.float32)
    grid = _grid(rng, 2, 4, 9)
    assert (np.abs(grid) > 1).any(axis=-1).mean() > 0.3
    cot = rng.randn(2, 4, 9, 3).astype(np.float32)

    def jf(im, g):
        return jnp.sum(jax_grid_sample(im, g) * cot)

    want = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    jg_img, jg_grid = jax.grad(jf, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti = nchw(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    got = grid_sample_bilinear(ti, tg)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6, rtol=1e-6)
    (got * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(ti.grad), np.asarray(jg_img), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg_grid), atol=1e-6, rtol=1e-6)


def test_f_grid_sample_differs_from_the_jax_rule_outside_the_grid_range():
    """The recorded divergence: inside [-1, 1] F.grid_sample (border,
    align_corners=True) equals the JAX rule; outside it returns the border
    pixel where the JAX rule blends the border column with its neighbour by
    x - floor(x): at (-1.3, 0) and (1.2, -1.1) on a 4x6 image they differ by
    about 0.1."""
    img = np.random.RandomState(1).rand(1, 4, 6, 1).astype(np.float32)
    inside = _grid(np.random.RandomState(2), 1, 8, 8, -1.0, 1.0)
    outside = np.array([[[[-1.3, 0.0], [1.2, -1.1]]]], np.float32)
    for grid, same in ((inside, True), (outside, False)):
        ref = grid_sample_bilinear(nchw(img), torch.from_numpy(grid))
        lib = F.grid_sample(nchw(img), torch.from_numpy(grid), mode="bilinear",
                            padding_mode="border", align_corners=True)
        np.testing.assert_allclose(nhwc(ref), np.asarray(
            jax_grid_sample(jnp.asarray(img), jnp.asarray(grid))), atol=1e-6, rtol=1e-6)
        diff = float((ref - lib).abs().max())
        if same:
            assert diff < 1e-6
        else:
            assert (ref - lib).abs().flatten().min() > 0.05, diff


@pytest.mark.parametrize("model_name", ["small", "large"])
def test_tps_matches_jax(model_name):
    """The rectified images and the grid, part of which leaves [-1, 1]."""
    x = np.random.RandomState(3).randn(3, 32, 64, 1).astype(np.float32)
    jmod, tmod = JTPS(in_channels=1, model_name=model_name), TPS(1, 20, model_name)
    variables = shaped_variables(jmod, x, seed=3)
    perturbed_tps_params(variables["params"], np.random.RandomState(4))
    load_flax_variables(tmod, variables)
    tmod.eval()
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        grid = tmod.grid(nchw(x))
        got = nhwc(tmod(nchw(x)))
    assert float((grid.abs() > 1).any(dim=-1).float().mean()) > 0.01
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **DEEP)


def test_seeded_init_keeps_rare_init():
    """seeded_init_ gives the TPS the JAX initialisers: fc2's weight zero and
    its bias the fiducial grid, the tail `fc` zero; so the first grid is the
    fixed RARE warp for every input."""
    tmod = seeded_init_(TPS(1, 20, "small"), torch.Generator().manual_seed(0))
    assert not tmod.loc_net.fc2.weight.any() and not tmod.fc.weight.any()
    assert float(tmod.loc_net.fc2.bias.detach().abs().max()) == 1.0
    x = torch.randn(2, 1, 32, 64)
    g = tmod.eval().grid(x)
    assert torch.equal(g[0], g[1])


def test_star_net_matches_jax_with_its_ctc_texts():
    """The small STAR-Net's CTC probabilities at DEEP and its CTCLabelDecode
    texts equal, the CTC head made decisive (utils.seeded.decisive_ctc_head_,
    no blank prior, so that the texts are not empty) and written back into
    the flax params."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (8, 32, 64, 1)).astype(np.float32)
    jmod, tmod = jax_build_model(STARNET), build_model(STARNET)
    variables = shaped_variables(jmod, x, seed=5)
    perturbed_tps_params(variables["params"]["transform"], rng)
    load_flax_variables(tmod, variables)
    tmod.eval()
    decisive_ctc_head_(tmod, nchw(x), blank_bias=0.0)
    fc = variables["params"]["head"]["fc"]
    fc["kernel"] = tmod.head.fc.weight.detach().numpy().T.copy()
    fc["bias"] = tmod.head.fc.bias.detach().numpy().copy()
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        got = tmod(nchw(x))
    np.testing.assert_allclose(got.numpy(), want, **DEEP)
    post = {"name": "CTCLabelDecode", "character_dict_path": None, "use_space_char": False}
    texts = [t for t, _ in build_post_process(post)(got)]
    assert texts == [t for t, _ in jax_build_post(post)(want)]
    assert sum(map(len, texts)) > 0


def test_star_net_config_serves_through_infer_rec(tmp_path, monkeypatch):
    """rec_vgg_tps_bilstm_ctc.yml as published (TPS large, VGG v1, BiLSTM
    256, CTC over the 6,623-character table and blank), seeded weights as a
    .pt, through `python -m pytorchocr_tpu_torch.deploy.infer_rec`'s main on
    two drawn lines: one res_*.txt each."""
    import synth

    cfg = os.path.join(REPO, "configs", "rec", "rec_vgg_tps_bilstm_ctc.yml")
    label = synth.make_rec_dataset(str(tmp_path / "lines"), n=2)
    recer = infer_rec.Recer(cfg, None, device="cpu")
    seeded_init_(recer.runner.model, torch.Generator().manual_seed(0))
    pt = str(tmp_path / "rec.pt")
    torch.save(recer.runner.model.state_dict(), pt)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", ["infer_rec", "--config", cfg, "--model_path", pt,
                                      "--img_path", os.path.dirname(label), "--out_dir",
                                      str(out), "--device", "cpu"])
    infer_rec.main()
    assert len(list(out.glob("res_*.txt"))) == 2


def test_star_net_train_eval_and_serve_from_the_checkpoint(tmp_path):
    """The same for a small STAR-Net (the transform frozen for the whole
    run, as freeze_transform_epochs: 60 sets it here): the eval's acc and
    norm_edit_dis equal the train run's, and Recer on best_accuracy reads
    the eval lines as the eval post process does."""
    import synth

    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.utils.save_load import load_model

    label = synth.make_rec_dataset(str(tmp_path / "lines"), n=8, charset="0123456789abc")
    cfg = tiny_rec_cls_config(tmp_path / "cfg.yml", "starnet", label, label, tmp_path / "out")
    report = train_cli(cfg, "Global.seed=5")
    assert report["steps"] == 2
    ckpt = str(tmp_path / "out" / "best_accuracy")
    metric = eval_cli.run(["-c", cfg, "-o", "Global.use_gpu=False",
                           "Global.checkpoints=%s" % ckpt])
    for k in ("acc", "norm_edit_dis"):
        assert metric[k] == report["best"][k]
    recer = infer_rec.Recer(cfg, ckpt, device="cpu")
    config = load_config(cfg)
    config["Global"]["checkpoints"] = ckpt
    config["Architecture"]["Head"]["out_channels"] = len(recer.rec_post_process_class.character)
    model = build_train_model(config, torch.device("cpu"))
    load_model(config, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, recer.runner.model.state_dict()[k]), k
    import cv2

    paths = [ln.split("\t")[0] for ln in open(label).read().splitlines()]
    texts = [t for t, _ in recer.run_batch([cv2.imread(p) for p in paths])]
    loader, _ = build_dataloader(config, "Eval", get_logger())
    model.eval()
    want = []
    with torch.no_grad():
        for batch in loader:
            probs = model(torch.from_numpy(batch[0]).permute(0, 3, 1, 2))
            want += [t for t, _ in recer.rec_post_process_class(probs)]
    assert texts == want


def test_tps_trains_after_serving_in_the_same_process():
    """The TPS matrices are cached per (F, h, w, device); a first call under
    torch.inference_mode (serving) must not cache inference tensors that a
    later training step cannot save for its backward."""
    from pytorchocr_tpu_torch.modeling.transforms.tps import tps_matrices

    tps_matrices.cache_clear()
    tmod = TPS(1, 20, "small")
    x = torch.randn(2, 1, 32, 48)
    with torch.inference_mode():
        tmod.eval()(x)
    tmod.train()(x).sum().backward()
    assert tmod.loc_net.fc2.bias.grad is not None


def test_star_net_two_train_steps_cross_the_unfreeze(tmp_path, monkeypatch):
    """Two STAR-Net steps against the JAX make_train_step, the transform
    frozen for the first (tests/test_torch_train_zoo.py:check_two_steps
    states the checks and their tolerances)."""
    from test_torch_train_zoo import check_two_steps, setup_steps

    check_two_steps(setup_steps("starnet", tmp_path), monkeypatch)
