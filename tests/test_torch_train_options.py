"""The JAX trainer's remaining options in the port, on the CPU: one DB-Swin
train step against the JAX make_train_step; AdamW, SGD and RMSprop against
optax over 5 steps of a schedule; `Global.remat` against the plain step;
`Global.use_profiler` writing its trace.

Tolerances, float32. The DB-Swin step (Swin embed 32 at 64x64 crops, FPN 32,
bs 2; flax's BN in its stable-variance mode, as
test_torch_train_step.py runs it): the loss to rtol 1e-5, every gradient to
a relative L2 of 5e-4, the parameters after the amsgrad step within 2 x lr
of JAX's everywhere and within 0.1 x lr on >= 97% of them, the BN running
statistics to rtol 2e-2 / atol 2e-3 (test_torch_train_step.py's bounds for
the DB-ResNet18 step). The optimizers: the parameters after 5 steps within
1e-6 of their largest |value|, where torch.optim.RMSprop (eps outside the
square root) misses by more than 10%. Remat: gradients, losses and running
statistics bit for bit the plain step's.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import program
from pytorchocr_tpu_torch.tools import train as train_tool
from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.seeded import seeded_init_
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import (shaped_train_state, tiny_det_config, tiny_rec_cls_config,
                             tiny_table_config)

CPU = torch.device("cpu")
SWIN = {"name": "SwinTransformer", "embed_dim": 32, "depths": [2, 2, 2, 2],
        "num_heads": [1, 2, 4, 8], "drop_path_rate": 0.0}


def test_db_swin_step_matches_jax_make_train_step(tmp_path, monkeypatch):
    import synth
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    label = synth.make_det_dataset(str(tmp_path / "data"), n=4, size=160, seed=1)
    path = tiny_det_config(tmp_path / "cfg.yml", "configs/det/det_r18_db_synth.yml", label,
                           label, tmp_path / "out")
    cfg = load_config(path)
    cfg["Architecture"]["Backbone"] = dict(SWIN)
    cfg["Global"]["distributed"] = False
    loader, _ = build_dataloader(cfg, "Train", get_logger())
    random.seed(2)
    np.random.seed(2)
    batch = next(iter(loader))

    jmodel = jax_build_model(cfg["Architecture"])
    tx, jsched = jax_build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=len(loader))
    jstate = shaped_train_state(jmodel, tx, batch[0], seed=3)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    jloss = jax_build_loss(cfg["Loss"])

    def loss_at(params, b):
        preds, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats},
                                jnp.asarray(b[0]), train=True, mutable=["batch_stats"])
        return jloss(preds, tuple(jnp.asarray(x) for x in b))["loss"]

    jgrad = jax.jit(jax.grad(loss_at))(jstate.params, tuple(batch))
    jstep = jax_make_train_step(jmodel, jloss, tx, create_mesh(devices=jax.devices()[:1]),
                                donate=False)
    jstate, jl = jstep(jstate, tuple(jnp.asarray(x) for x in batch))

    model = build_model(cfg["Architecture"])
    load_flax_variables(model, variables)
    opt, _ = build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=len(loader),
                             parameters=model.parameters())
    lr = opt.current_lr()
    assert lr == pytest.approx(float(jsched(0)), rel=1e-6)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    tl = make_train_step(model, build_loss(cfg["Loss"]), opt)(batch_to_device(batch, CPU))
    np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
    want = flax_to_state_dict(model, {"params": jax.device_get(jgrad),
                                      "batch_stats": variables["batch_stats"]})
    for k, p in model.named_parameters():
        # a bias before a train-mode BN (the DB head's deconv1; the output taps'
        # LayerNorms, under the FPN's lateral conv and BN): 0 + rounding
        if k.endswith("deconv1.bias") or (k.startswith("backbone.out_norm") and "bias" in k):
            assert float(want[k].norm()) < 1e-6 and float(p.grad.norm()) < 1e-6, k
            continue
        rel = float((p.grad - want[k]).norm() / want[k].norm())
        assert rel < 5e-4, (k, rel)
    after = flax_to_state_dict(model, {"params": jax.device_get(jstate.params),
                                       "batch_stats": jax.device_get(jstate.batch_stats)})
    dt = torch.cat([(p.detach() - p0[k]).flatten() for k, p in model.named_parameters()])
    dj = torch.cat([(after[k] - p0[k]).flatten() for k, _ in model.named_parameters()])
    err = (dt - dj).abs()
    assert float(err.max()) <= 2 * lr
    assert float((err <= 0.1 * lr).float().mean()) >= 0.97
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), after[k].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=k)


OPTIMS = [
    {"name": "AdamW"},
    {"name": "AdamW", "weight_decay": 0.05, "betas": [0.8, 0.99]},
    {"name": "SGD"},
    {"name": "SGD", "momentum": 0.9, "nesterov": True, "weight_decay": 1e-3},
    {"name": "SGD", "momentum": 0.9},
    {"name": "RMSprop"},
    {"name": "RMSprop", "alpha": 0.9, "momentum": 0.5},
]


def _run_both(optim, grads, p0):
    cfg = {"base_lr": 0.01, "optim": optim,
           "lr_decay": {"name": "WarmupCosineLR", "warmup_epoch": 1}}
    tx, _ = jax_build_optimizer(cfg, epochs=2, step_each_epoch=3)
    params = {str(i): jnp.asarray(p) for i, p in enumerate(p0)}
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, _ = build_optimizer(cfg, epochs=2, step_each_epoch=3, parameters=tp)
    for g in grads:
        upd, state = tx.update({str(i): jnp.asarray(x) for i, x in enumerate(g)}, state, params)
        params = optax.apply_updates(params, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    return [np.asarray(params[str(i)]) for i in range(len(p0))], [p.detach().numpy() for p in tp]


@pytest.mark.parametrize("optim", OPTIMS, ids=lambda o: "-".join(
    "%s%s" % (k, v) for k, v in o.items()))
def test_optimizer_matches_optax(optim):
    """5 steps with a warmup-cosine schedule (LR 0 at the first step, as
    optax's schedule gives it) on gradients of scale 1 and 1e-4 (where
    RMSprop's eps, 1e-8, weighs on the second moment)."""
    rng = np.random.RandomState(len(str(optim)))
    shapes = [(3, 4), (5,), (2, 3, 3, 3)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    scales = (1.0, 1e-4, 1.0)
    grads = [[(sc * rng.randn(*s)).astype(np.float32) for s, sc in zip(shapes, scales)]
             for _ in range(5)]
    want, got = _run_both(optim, grads, p0)
    for w, g, p in zip(want, got, p0):
        assert np.abs(w - p).max() > 0  # the schedule moved them
        assert float(np.abs(g - w).max() / np.abs(w).max()) <= 1e-6
    if optim["name"] == "RMSprop":  # the control: torch's rule, eps outside the root
        tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        ctl = torch.optim.RMSprop(tp, lr=0.01, alpha=optim.get("alpha", 0.99), eps=1e-8,
                                  momentum=optim.get("momentum", 0.0))
        _, jsched = jax_build_optimizer({"base_lr": 0.01, "optim": optim, "lr_decay": {
            "name": "WarmupCosineLR", "warmup_epoch": 1}}, epochs=2, step_each_epoch=3)
        for i, g in enumerate(grads):
            for group in ctl.param_groups:
                group["lr"] = float(jsched(i))
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x.copy())
            ctl.step()
        w = want[1]
        miss = float(np.abs(tp[1].detach().numpy() - w).max() / np.abs(w - p0[1]).max())
        assert miss > 0.1, miss


def _table_setup(tmp_path, p=0.25):
    import synth

    label = synth.make_pubtab_dataset(str(tmp_path / "data"), n=4, size=64)
    cfg_path = tiny_table_config(tmp_path / "t.yml", label, tmp_path / "out", p, 12, 64)
    cfg = program.preprocess(argv=["-c", cfg_path])[0]
    train_tool.set_head_channels(cfg, build_post_process(cfg["PostProcess"], cfg["Global"]))
    rng = np.random.RandomState(7)
    n_cls, bs, steps = cfg["Architecture"]["Head"]["out_channels"], 2, 14
    td = 48  # "<td></td>" in the merged table
    structure = np.zeros((bs, steps), np.int64)
    masks = np.zeros((bs, steps, 1), np.float32)
    for i in range(bs):
        k = rng.randint(6, 12)
        structure[i, 1:k + 1] = np.where(rng.rand(k) < 0.5, td, rng.randint(1, n_cls - 1, k))
        structure[i, k + 1] = n_cls - 1
        masks[i, 1:k + 1, 0] = rng.rand(k) > 0.5
    batch = (rng.randint(0, 256, (bs, 64, 64, 3)).astype(np.uint8), structure,
             (rng.rand(bs, steps, 8) * masks).astype(np.float32), masks,
             *[rng.randint(1, 6, bs).astype(np.int32) for _ in range(2)],
             np.tile(np.array([64, 64, 1.0, 1.0, 64, 64]), (bs, 1)))
    return cfg, batch


def _step_once(cfg, batch, remat):
    model = build_model(cfg["Architecture"])
    seeded_init_(model, torch.Generator().manual_seed(8))
    opt, _ = build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    spec = cfg["Global"]["_device_normalize_spec"]["Train"]
    step = make_train_step(model, build_loss(cfg["Loss"]), opt,
                           input_transform=build_input_transform(spec), remat=remat)
    losses = step(batch_to_device(batch, CPU))
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k
             or "num_batches" in k}
    return losses, grads, stats


def test_remat_step_equals_the_plain_step(tmp_path, monkeypatch):
    """SLANet (PPLCNet x0.5 with its BNs, SLAHead with scheduled sampling at
    p = 0.25, 12 steps): one step with Global.remat and one without, from
    one seeded init on one batch: the losses, every gradient and every BN
    running statistic bit for bit alike, and the coins drawn alike (the
    recompute's coins feed the gradient). Two controls show the test would
    see a fault: the recompute left to update the running statistics moves
    them, and a generator made outside the recomputed function draws other
    coins there and moves the head's gradients."""
    from pytorchocr_tpu_torch import trainer

    cfg, batch = _table_setup(tmp_path)
    plain = _step_once(cfg, batch, remat=False)
    remat = _step_once(cfg, batch, remat=True)
    for a, b in zip(plain, remat):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k

    import contextlib

    monkeypatch.setattr(trainer, "recomputing", contextlib.nullcontext)
    _, _, stats = _step_once(cfg, batch, remat=True)
    assert any(not torch.equal(stats[k], plain[2][k]) for k in stats)
    monkeypatch.undo()

    made = {}

    def once_per_step(device, step):  # one generator for the forward and its recompute
        if step not in made:
            made[step] = torch.Generator(device=device).manual_seed((17 << 32) + int(step))
        return made[step]

    monkeypatch.setattr(trainer, "sample_generator", once_per_step)
    _, grads, _ = _step_once(cfg, batch, remat=True)
    assert any(not torch.equal(grads[k], plain[1][k]) for k in grads if k.startswith("head"))


def test_use_profiler_writes_the_trace(tmp_path):
    """Global.use_profiler with the window [1, 3) on a small CRNN run of 4
    steps: rank 0 writes save_model_dir/profile/trace_steps1-3.json, a
    Chrome trace whose events hold the train step's ops; without the option
    no trace is written."""
    import synth

    label = synth.make_rec_dataset(str(tmp_path / "rec"), n=16, seed=3)
    cfg = tiny_rec_cls_config(tmp_path / "rec.yml", "rec", label, label, tmp_path / "out")
    report = train_tool.run(["-c", cfg, "-o", "Global.use_gpu=False", "Global.use_profiler=True",
                             "Global.profile_start_step=1", "Global.profile_end_step=3",
                             "Global.cal_metric_during_train=False"])
    assert report["steps"] == 4
    path = report["profile"]
    assert path == os.path.join(str(tmp_path / "out"), "profile", "trace_steps1-3.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any("backward" in n.lower() for n in names)
    report = train_tool.run(["-c", cfg, "-o", "Global.use_gpu=False",
                             "Global.save_model_dir=%s" % (tmp_path / "out2")])
    assert report["profile"] is None
    assert not os.path.exists(str(tmp_path / "out2" / "profile"))
