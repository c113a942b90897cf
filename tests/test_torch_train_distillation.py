"""Distillation training in the port against the JAX package, on the CPU.

One train step of the CML model (tests/test_distillation.py's: a frozen
ResNet-18 teacher and two MobileNetV3-small x0.5 students, FPN 32, 64x64,
bs 2, the CML config's three losses) and one of the rec DML model (two
CRNNs at VGG x0.5, BiLSTM 48, 1x32x64, bs 4, CTC + DML), each with its
config's optimizer (amsgrad + WarmupPolyLR), from one JAX init bridged into
the port, against the JAX `make_train_step`: every loss term (rtol 1e-5);
every trained leaf's gradient, read from the first moment the step leaves
((1 - b1) g on both sides; the JAX state carried over by
`load_optax_adam_state`), within 5e-4 relative L2 of the JAX one, or,
where the two float32 gradients differ by more (the students' early
backbone layers, up to 5.5e-4 measured: float32 rounding on both sides),
both held to the port's float64 gradient as test_torch_train_zoo.py holds
them (JAX's within 2e-2 relative L2 of it, the port's no further than the
larger of that and twice JAX's distance); the parameters after the update
within 2 lr everywhere, within 0.1 lr on >= 97% of them and the updates
correlated > 0.999 (test_torch_train_zoo.py's limits: Adam's first update
is lr times the gradient's sign, so an element whose gradient lies within
rounding of 0 may move either way); the BN running statistics rtol 2e-2 /
atol 2e-3; and the teacher, its parameters and its BN statistics, bit for
bit where it started on both sides. flax runs with its stable batch
variance, as in test_torch_train_step.py.

Then `load_submodel_pretrained` from a port checkpoint directory (a DB
model with its threshold tower onto the frozen teacher built without it),
`tools.train` / `tools.eval` on small copies of the det and the rec DML
configs, and a build of all 8 distillation configs at
full width.
"""

import copy
import os

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import eval as eval_cli
from pytorchocr_tpu_torch.tools.train import set_head_channels
from pytorchocr_tpu_torch.trainer import batch_to_device, float_preds, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.save_load import load_submodel_pretrained, save_model
from pytorchocr_tpu_torch.utils.seeded import seeded_init_
from pytorchocr_tpu_torch.utils.weights import (flax_to_state_dict, load_flax_variables,
                                                load_optax_adam_state)
from test_distillation import LOSS_CFG, _arch, _det_batch
from test_torch_distillation import rec_arch
from torch_port_util import _plain, shaped_train_state, train_cli

CPU = torch.device("cpu")
GRAD_LIMIT = 2e-2  # chip_smoke.py's relative-L2 limit of a float32 leaf against float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.join(d, f) for d in ("configs/det/distillation",
                                               "configs/rec/distillation")
                 for f in os.listdir(os.path.join(REPO, d)))
REC_LOSS = {"name": "CombinedLoss", "loss_config_list": [
    {"DistillationCTCLoss": {"weight": 1.0, "model_name_list": ["Student", "Student2"],
                             "key": "head_out"}},
    {"DistillationDMLLoss": {"weight": 1.0, "act": "softmax", "use_log": True,
                             "model_name_pairs": [["Student", "Student2"]], "key": "head_out"}}]}


def _rec_batch(rng, bs=4):
    lengths = rng.randint(1, 9, bs).astype(np.int64)
    labels = np.zeros((bs, 25), np.int64)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.randint(1, 37, k)
    return (rng.randn(bs, 32, 64, 1).astype(np.float32), labels, lengths)


def float64_grads(arch, variables, loss_fn, batch):
    """The port's train-mode gradients in float64 from the bridged weights
    (the DB head's sigmoids stay float32, as the module computes them)."""
    model = build_model(arch)
    load_flax_variables(model, variables)
    model.double().train()
    b = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
              for x in batch_to_device(batch, CPU))
    preds = model(b[0].permute(0, 3, 1, 2), data=b)
    loss_fn(float_preds(preds, torch.float64), b)["loss"].backward()
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("kind", ["cml", "rec_dml"])
def test_one_train_step_matches_jax_make_train_step(kind, monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    if kind == "cml":
        arch, loss_cfg, batch = _arch(), LOSS_CFG, _det_batch(n=2, hw=64)
        optimizer = load_config(os.path.join(
            REPO, "configs/det/distillation/det_cml_db_synth.yml"))["Optimizer"]
    else:
        arch, loss_cfg, batch = rec_arch(), REC_LOSS, _rec_batch(np.random.RandomState(0))
        optimizer = load_config(os.path.join(
            REPO, "configs/rec/distillation/rec_dml_ctc_synth.yml"))["Optimizer"]
    jmodel, jloss = jax_build_model(arch), jax_build_loss(loss_cfg)
    tx, jsched = jax_build_optimizer(optimizer, epochs=1, step_each_epoch=2)
    jstate = shaped_train_state(jmodel, tx, batch[0], seed=5)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    jbatch = tuple(jnp.asarray(b) for b in batch)
    jstep = jax_make_train_step(jmodel, jloss, tx, create_mesh(devices=jax.devices()[:1]),
                                donate=False)
    jstate, jlosses = jstep(jstate, jbatch)

    model = build_model(arch)
    load_flax_variables(model, variables)
    loss_fn = build_loss(loss_cfg)
    opt, _ = build_optimizer(optimizer, epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    grad64 = float64_grads(arch, variables, loss_fn, batch)
    frozen = [p for n, p in model.named_parameters()
              if not p.requires_grad and "bias_hh" not in n]  # bias_hh: held at 0 (rnn.py)
    assert len(frozen) == (sum(1 for _ in model.models_0.parameters()) if kind == "cml" else 0)
    assert not any(p is q for q in frozen for p in opt.param_groups[0]["params"])
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    lr = opt.current_lr()
    assert lr == pytest.approx(float(jsched(0)), rel=1e-6)
    losses = make_train_step(model, loss_fn, opt)(batch_to_device(batch, CPU))

    assert sorted(losses) == sorted(jlosses) and len(losses) >= (10 if kind == "cml" else 4)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    # the gradients, from the first moments the step left: mu = (1 - b1) g on both
    # sides; the JAX ones carried over by load_optax_adam_state (the teacher's are
    # zeros there, its parameters in the optimizer with zero gradients)
    ams = jstate.opt_state[0]
    if kind == "cml":
        assert not any(np.any(np.asarray(v)) for v in jax.tree.leaves(ams.mu["models_0"]))
    jopt, _ = build_optimizer(optimizer, epochs=1, step_each_epoch=2,
                              parameters=model.parameters())
    load_optax_adam_state(jopt, model, {"count": ams.count, "mu": jax.device_get(ams.mu),
                                        "nu": jax.device_get(ams.nu),
                                        "nu_max": jax.device_get(ams.nu_max)},
                          variables["batch_stats"])
    assert jopt.param_groups[0]["count"] == opt.param_groups[0]["count"] == 1
    after = flax_to_state_dict(model, {"params": jax.device_get(jstate.params),
                                       "batch_stats": jax.device_get(jstate.batch_stats)})
    named, trained = dict(model.named_parameters()), []
    for k, p in named.items():
        if k.startswith("models_0.") and kind == "cml":
            assert p.grad is None and torch.equal(p.detach(), p0[k]), k
            continue
        if p.grad is None:
            assert "bias_hh" in k, k
            continue
        trained.append(k)
        mu, jmu = opt.state[p]["mu"], jopt.state[p]["mu"]
        if float(jmu.norm()) < 1e-6:  # a bias before a train-mode BN: 0 + rounding
            assert float(mu.norm()) < 1e-6, k
            continue
        rel = float((mu - jmu).norm() / jmu.norm())
        if rel >= 5e-4:  # then held to the float64 gradient (module docstring)
            g64 = grad64[k].float()
            port_err, jax_err = float((mu / 0.1 - g64).norm()), float((jmu / 0.1 - g64).norm())
            assert jax_err <= GRAD_LIMIT * float(g64.norm()), (k, jax_err, float(g64.norm()))
            assert port_err <= max(2 * jax_err, GRAD_LIMIT * float(g64.norm())), (
                k, rel, port_err, jax_err)
    dt = torch.cat([(named[k].detach() - p0[k]).flatten() for k in trained])
    dj = torch.cat([(after[k] - p0[k]).flatten() for k in trained])
    err = (dt - dj).abs()
    assert float(err.max()) <= 2 * lr
    assert float((err <= 0.1 * lr).float().mean()) >= 0.97
    assert float(torch.corrcoef(torch.stack([dt, dj]))[0, 1]) > 0.999
    sd = model.state_dict()
    for k in sd:
        if k.startswith("models_0.") and kind == "cml":  # the teacher, parameters and buffers
            assert torch.equal(sd[k], sd0[k]), k
            if "running" in k or "num_batches" not in k:
                np.testing.assert_array_equal(after[k].numpy(), sd0[k].numpy(), err_msg=k)
        elif "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=k)


def _teacher_checkpoint(tmp_path):
    """A seeded ResNet-18 DB model with FPN 32 (the CML teacher's layout, its
    threshold tower included) saved as a port checkpoint directory."""
    teacher_cfg = {k: v for k, v in _arch()["Models"]["Teacher"].items()
                   if k not in ("pretrained", "freeze_params")}
    solo = seeded_init_(build_model(teacher_cfg), torch.Generator().manual_seed(7))
    opt, _ = build_optimizer({"base_lr": 1e-3, "optim": {"name": "Adam"}}, 1, 1,
                             solo.parameters())
    save_model(solo, opt, {"start_epoch": 1, "global_step": 1, "best_model": {}},
               str(tmp_path / "teacher"), prefix="best_accuracy")
    return solo, str(tmp_path / "teacher" / "best_accuracy")


def test_load_submodel_pretrained_grafts_a_port_checkpoint_onto_the_teacher(tmp_path):
    solo, ckpt = _teacher_checkpoint(tmp_path)
    arch = _arch()
    arch["Models"]["Teacher"]["pretrained"] = ckpt
    model = seeded_init_(build_model(arch), torch.Generator().manual_seed(8))
    students = {k: v.clone() for k, v in model.state_dict().items()
                if not k.startswith("models_0.")}
    load_submodel_pretrained(model, arch)
    want = solo.state_dict()
    got = model.models_0.state_dict()
    assert set(want) - set(got) == {k for k in want if k.startswith("head.thresh.")} != set()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    for k, v in students.items():
        assert torch.equal(model.state_dict()[k], v), k
    arch["Models"]["Teacher"]["pretrained"] = str(tmp_path / "missing")
    with pytest.raises(AssertionError, match="Teacher.pretrained does not exist"):
        load_submodel_pretrained(model, arch)


def _tiny_distillation_config(path, base, train_label, eval_label, save_dir, teacher=None):
    """A small copy of a distillation config: MobileNetV3-small x0.5
    students with FPN 32 (det) or VGG x0.5 with BiLSTM 48 (rec), the
    teacher's FPN 32 and its `pretrained` checkpoint, 64x64 crops (det) or
    1x32x64 lines (rec), bs 2 / 4, float32, CPU, one epoch with an eval."""
    import yaml

    cfg = load_config(os.path.join(REPO, base))
    cfg["Global"].update(use_gpu=False, use_amp=False, epoch_num=1, print_batch_step=1,
                         save_model_dir=str(save_dir), eval_epoch_step=[0, 1],
                         log_smooth_window=2)
    rec = cfg["Architecture"]["model_type"] == "rec"
    for name, m in cfg["Architecture"]["Models"].items():
        if rec:
            m["Backbone"]["scale"] = 0.5
            m["Neck"]["hidden_size"] = 48
            continue
        m["Neck"]["out_channels"] = 32
        if name == "Teacher":
            m["pretrained"] = teacher
        else:
            m["Backbone"]["model_name"] = "small"
    for mode in ("Train", "Eval"):
        for op in cfg[mode]["dataset"]["transforms"]:
            name = next(iter(op))
            if name == "FusedDetAugCrop":
                op[name]["size"] = [64, 64]
            elif name == "DetResizeForTest":
                op[name] = {"limit_side_len": 64, "limit_type": "min"}
            elif name == "RecResizeImg":
                op[name]["image_shape"] = [1, 32, 64]
        cfg[mode]["loader"].update(num_workers=1)
        if rec or mode == "Train":
            cfg[mode]["loader"]["batch_size_per_card"] = 4 if rec else 2
    cfg["Train"]["dataset"]["label_file_list"] = [str(train_label)]
    cfg["Eval"]["dataset"]["label_file_list"] = [str(eval_label)]
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f, sort_keys=False)
    return str(path)


@pytest.mark.parametrize("kind", ["det_dml", "rec_dml"])
def test_tools_train_and_eval_on_small_distillation_configs(kind, tmp_path):
    """`python -m pytorchocr_tpu_torch.tools.train` in a subprocess that loads
    no module of jax, flax or the JAX package; tools.eval.run on
    best_accuracy gives the train run's metric, the better student's by
    DistillationMetric."""
    import synth

    if kind == "det_dml":
        label = synth.make_det_dataset(str(tmp_path / "data"), n=4, size=160, seed=3)
        base = "configs/det/distillation/det_dml_db_synth.yml"
    else:
        label = synth.make_rec_dataset(str(tmp_path / "data"), n=8)
        base = "configs/rec/distillation/rec_dml_ctc_synth.yml"
    cfg = _tiny_distillation_config(tmp_path / "cfg.yml", base, label, label, tmp_path / "out")
    report = train_cli(cfg, "Global.seed=5")
    assert report["steps"] == 2
    best = report["best"]
    indicator = "hmean" if kind == "det_dml" else "acc"
    assert best[indicator] == max(best["Student_" + indicator], best["Student2_" + indicator])
    out = str(tmp_path / "out" / "best_accuracy")
    metric = eval_cli.run(["-c", cfg, "-o", "Global.use_gpu=False",
                           "Global.checkpoints=" + out])
    for k in ("Student_" + indicator, "Student2_" + indicator, indicator):
        assert metric[k] == pytest.approx(best[k], abs=1e-9), k


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_every_distillation_config_builds_at_full_width(path):
    """Each config's model as tools.train builds it (the charset sizing
    every CTC head), with its teacher frozen; build only."""
    cfg = load_config(os.path.join(REPO, path))
    post = build_post_process(copy.deepcopy(cfg["PostProcess"]), cfg["Global"])
    set_head_channels(cfg, post)
    model = build_model(cfg["Architecture"])
    names = list(cfg["Architecture"]["Models"])
    assert list(model.model_names) == names
    frozen = [k for k, m in cfg["Architecture"]["Models"].items() if m.get("freeze_params")]
    assert list(model.frozen_names) == frozen
    for i, name in enumerate(names):
        sub = getattr(model, "models_%d" % i)
        assert sum(p.numel() for p in sub.parameters()) > 1e5
        assert all(p.requires_grad != (name in frozen) for k, p in sub.named_parameters()
                   if "bias_hh" not in k), name
    build_loss(cfg["Loss"])
