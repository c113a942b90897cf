"""Multi-rank training of the port on the CPU: gloo worlds of 2 and 4
processes (tests/torch_parallel_worker.py, a `file://` rendezvous in the
test's tmp dir, one thread a rank), against the JAX package's one-device
step on the global batch, which is what its dp mesh computes (one jitted
step over the global view).

(a) The DB step of a small DB-ResNet18 (FPN 32, 64x64 crops, global batch 4
from the loader, amsgrad + WarmupPolyLR without warm-up so the first update
moves) at world 2 against the port at world 1 and against JAX's
make_train_step (flax's stable variance, as tests/test_torch_train_step.py
explains), all from the JAX init through the weight bridge: the loss and
its terms, every gradient, the parameters after the update and the BN
running statistics; the two ranks bit-identical. Against JAX the bound is
the float32 error of the one-rank port step measured here (`F32`); the
port's float64 step at world 2 against its float64 step at world 1 differs
by the order of its reductions alone (`F64`). (b) The control: per-rank
loss sums and OHEM range (a plain DistributedDataParallel's semantics, BN
still global) fail the F64 bound by orders of magnitude and miss the JAX
loss far outside the F32 one. (c) The CRNN of `__graft_entry__._dryrun_crnn_dp_tp`
(VGG x0.5, BiLSTM 32, CTC over 64 classes, Adam 1e-3) at world 4 as 2
(data) x 2 (model), the head's columns split in half over the model group,
against that arithmetic on one device. (d) The loader's shards against the
JAX loader's for 2 and 3 ranks, with the padding. (e) SLANet's step (its
loc loss global, its scheduled-sampling coins drawn for the global batch)
at world 2 against world 1. (f) `python -m torch.distributed.run
--nproc_per_node 2 -m pytorchocr_tpu_torch.tools.train` on the CPU."""

import copy
import json
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.data.loader import OCRDataLoader
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.tools import program
from pytorchocr_tpu_torch.trainer import batch_to_device, build_input_transform, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.seeded import seeded_init_
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import shaped_variables, tiny_det_config, tiny_table_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
CPU = torch.device("cpu")


class World:
    """A gloo world of `world` worker processes running `job`, started at
    once; `results()` waits for them and returns each rank's output."""

    def __init__(self, tmp, name, job, world):
        self.outs = [str(tmp / ("%s_%d.pt" % (name, r))) for r in range(world)]
        job_path = str(tmp / (name + "_job.pt"))
        torch.save(job, job_path)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, job_path, str(r), str(world), str(tmp / (name + ".init")),
             self.outs[r]], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self):
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=300)
                assert p.returncode == 0, out[-3000:]
        finally:  # a rank that failed leaves the others waiting in a collective
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(o, weights_only=False) for o in self.outs]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def _assert_ranks_identical(results):
    for r in results[1:]:
        for k, v in results[0]["state"].items():
            assert torch.equal(r["state"][k], v), k


def _to(transform, dtype):
    return None if transform is None else (lambda x: transform(x).to(dtype))


def _steps_in_one_process(cfg, state, batch, epochs=1, steps=4, dtype=torch.float32):
    model = build_model(cfg["Architecture"])
    model.load_state_dict(state)
    model.to(dtype)
    opt, _ = build_optimizer(cfg["Optimizer"], epochs=epochs, step_each_epoch=steps,
                             parameters=model.parameters())
    batch = [b.to(dtype) if b.is_floating_point() else b for b in batch_to_device(batch, CPU)]
    spec = cfg.get("Global", {}).get("_device_normalize_spec", {}).get("Train")
    losses = make_train_step(model, build_loss(cfg["Loss"]), opt,
                             input_transform=_to(build_input_transform(spec), dtype))(batch)
    return model, opt, {k: float(v) for k, v in losses.items()}


# ---------------------------------------------------------------- (a), (b) DB


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    import synth
    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import create_train_state
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    tmp = tmp_path_factory.mktemp("parallel_db")
    label = synth.make_det_dataset(str(tmp / "data"), n=8, size=160, seed=4)
    cfg = load_config(tiny_det_config(tmp / "cfg.yml", "configs/det/det_r18_db_synth.yml",
                                      label, label, tmp / "out", batch=4))
    cfg["Global"]["distributed"] = False
    cfg["Optimizer"]["lr_decay"]["warmup_epoch"] = 0
    loader, _ = build_dataloader(cfg, "Train", get_logger())
    random.seed(2)
    np.random.seed(2)
    batch = list(loader)[0]
    assert len(batch[0]) == 4

    jmodel = jax_build_model(cfg["Architecture"])
    tx, jsched = jax_build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=4)
    jstate = create_train_state(jmodel, tx, jax.random.PRNGKey(0), batch)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    model = build_model(cfg["Architecture"])
    load_flax_variables(model, variables)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    job = dict(kind="step", cfg=cfg, state=state, batch=list(batch), epochs=1,
               steps_per_epoch=4)
    worlds = {"f32": World(tmp, "db_f32", job, 2),
              "f64": World(tmp, "db_f64", dict(job, dtype=torch.float64), 2),
              "control": World(tmp, "db_control", dict(job, kind="per_rank_loss",
                                                       dtype=torch.float64), 2)}

    stats = normalization._compute_stats
    normalization._compute_stats = lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False})
    try:
        jloss = jax_build_loss(cfg["Loss"])
        jbatch = tuple(jnp.asarray(b) for b in batch)

        def loss_at(params):
            preds, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats},
                                    jbatch[0], train=True, mutable=["batch_stats"])
            return jloss(preds, jbatch)["loss"]

        jgrad = jax.jit(jax.grad(loss_at))(jstate.params)
        jstep = jax_make_train_step(jmodel, jloss, tx, create_mesh(devices=jax.devices()[:1]),
                                    donate=False)
        jstate, jl = jstep(jstate, jbatch)
    finally:
        normalization._compute_stats = stats
    jax_run = dict(
        losses={k: float(v) for k, v in jl.items()},
        grads=flax_to_state_dict(model, {"params": jax.device_get(jgrad),
                                         "batch_stats": variables["batch_stats"]}),
        state=flax_to_state_dict(model, {"params": jax.device_get(jstate.params),
                                         "batch_stats": jax.device_get(jstate.batch_stats)}))
    runs = {"jax": jax_run}
    for dtype in (torch.float32, torch.float64):
        one, opt, losses = _steps_in_one_process(cfg, state, batch, dtype=dtype)
        runs["one_" + str(dtype)[-2:]] = dict(
            losses=losses, state=one.state_dict(),
            grads={k: p.grad for k, p in one.named_parameters() if p.grad is not None})
    lr = float(opt.lr_schedule(0))
    assert lr > 0 and lr == pytest.approx(float(jsched(0)))
    for name, world in worlds.items():
        ranks = world.results()
        runs[name + "_ranks"] = ranks
        runs[name] = dict(losses={k: float(v) for k, v in ranks[0]["losses"].items()},
                          grads=ranks[0]["grads"], state=ranks[0]["state"])
    return dict(runs=runs, state=state, lr=lr)


def _held(got, want, state0, lr, loss_rtol, grad_rtol, bn_rtol, update):
    """`got` (losses, grads, state after the update) against `want`: the loss
    and its terms, every gradient leaf's relative L2, the parameters' moves
    (`update`: (bound everywhere, bound on 97% of them), in units of lr)
    and the BN running statistics."""
    for k, v in want["losses"].items():
        assert got["losses"][k] == pytest.approx(v, rel=loss_rtol), k
    for k, g in got["grads"].items():
        if k.endswith("deconv1.bias"):  # a bias before a train-mode BN: 0 + rounding
            assert float(g.norm()) < 1e-5 and float(want["grads"][k].norm()) < 1e-5
            continue
        assert _rel(g, want["grads"][k]) < grad_rtol, (k, _rel(g, want["grads"][k]))
    moved = torch.cat([(got["state"][k] - state0[k]).double().flatten() for k in got["grads"]])
    wmoved = torch.cat([(want["state"][k] - state0[k]).double().flatten() for k in got["grads"]])
    err = (moved - wmoved).abs()
    assert float(err.max()) <= update[0] * lr
    assert float((err <= update[1] * lr).double().mean()) >= 0.97
    for k, v in want["state"].items():
        if "running" in k:
            torch.testing.assert_close(got["state"][k].double(), v.double(), rtol=bn_rtol,
                                       atol=bn_rtol * 1e-2, msg=k)


# the one-rank port step's float32 error against the JAX step, measured here:
# loss and terms 1.9e-6 relative, the worst gradient leaf 3.0e-2 relative L2
# (a BN bias deep in the backbone: the port's float64 step lands as far from
# JAX, where a float32 ReLU or OHEM element falls on the other side of its
# kink), every parameter within 2 lr and 97% within 7.5e-6 lr (Adam's
# normalised step: a gradient within rounding of 0 moves +-lr), BN statistics
# 1.2e-4 (|diff| / (|v| + 1e-2))
F32 = dict(loss_rtol=5e-6, grad_rtol=6e-2, bn_rtol=1e-3, update=(2.0, 1e-3))
# the port's float64 step at world 2 against world 1 (the DB head's sigmoids
# stay float32), measured: loss 2e-16, gradients 2e-13, the parameters 3.5e-8
# lr apart at most and 1.7e-15 lr at the 97th percentile, BN statistics 2e-13
F64 = dict(loss_rtol=1e-12, grad_rtol=1e-10, bn_rtol=1e-10, update=(1e-6, 1e-12))


@pytest.mark.parametrize("run, ref, bounds", [
    ("f32", "jax", F32), ("one_32", "jax", F32), ("f64", "jax", F32), ("f64", "one_64", F64)],
    ids=["world2-f32-vs-jax", "world1-f32-vs-jax", "world2-f64-vs-jax", "world2-vs-world1-f64"])
def test_db_step_at_world_2_is_the_step_on_the_global_batch(db, run, ref, bounds):
    runs = db["runs"]
    _held(runs[run], runs[ref], db["state"], db["lr"], **bounds)
    if run + "_ranks" in runs:
        ranks = runs[run + "_ranks"]
        assert [r["data_rank"] for r in ranks] == [0, 1]
        _assert_ranks_identical(ranks)


def test_per_rank_loss_control_misses_the_global_step(db):
    """A per-rank loss (each shard's OHEM k, threshold, dice and L1, then
    the average) is another function: it fails the float64 bound of the
    world-2 step by orders of magnitude, and its loss misses JAX's far
    outside the float32 bound."""
    runs = db["runs"]
    _assert_ranks_identical(runs["control_ranks"])  # the gradient average keeps them equal
    with pytest.raises(AssertionError):
        _held(runs["control"], runs["one_64"], db["state"], db["lr"], **F64)
    got, want = runs["control"]["losses"]["loss"], runs["one_64"]["losses"]["loss"]
    assert abs(got - want) > 5e-4 * abs(want)  # 9.5e-4 measured
    assert abs(got - runs["jax"]["losses"]["loss"]) > 20 * F32["loss_rtol"] * abs(want)
    worst = max(_rel(g, runs["one_64"]["grads"][k]) for k, g in runs["control"]["grads"].items()
                if not k.endswith("deconv1.bias"))
    assert worst > 1e8 * F64["grad_rtol"]  # 0.26 measured


# ---------------------------------------------------------------- (c) CRNN dp x tp

CRNN_ARCH = {
    "model_type": "rec", "algorithm": "CRNN", "in_channels": 1, "Transform": None,
    "Backbone": {"name": "VGG", "model_name": "v1", "scale": 0.5},
    "Neck": {"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 32},
    "Head": {"name": "CTCHead", "out_channels": 64},
}
CRNN_OPT = {"base_lr": 1e-3, "optim": {"name": "Adam"}}


def _crnn_batch(n=4):
    """`_dryrun_crnn_dp_tp`'s batch."""
    rng = np.random.RandomState(0)
    images = rng.rand(n, 32, 64, 1).astype(np.float32)
    labels = np.zeros((n, 25), np.int64)
    labels[:, :3] = rng.randint(1, 60, size=(n, 3))
    return [images, labels, np.full((n,), 3, np.int64)]


@pytest.fixture(scope="module")
def crnn(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer

    tmp = tmp_path_factory.mktemp("parallel_crnn")
    batch = _crnn_batch()
    jmodel = jax_build_model(copy.deepcopy(CRNN_ARCH))
    variables = shaped_variables(jmodel, batch[0])
    model = build_model(copy.deepcopy(CRNN_ARCH))
    load_flax_variables(model, variables)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = {"Architecture": CRNN_ARCH, "Loss": {"name": "CTCLoss"}, "Optimizer": CRNN_OPT}
    job = dict(kind="tp", cfg=cfg, state=state, batch=batch, epochs=1, steps_per_epoch=10,
               model_parallel=2)
    worlds = {"f32": World(tmp, "crnn_f32", job, 4),
              "f64": World(tmp, "crnn_f64", dict(job, dtype=torch.float64), 4)}

    loss_fn = jax_build_loss({"name": "CTCLoss"})
    tx, _ = jax_build_optimizer(CRNN_OPT, epochs=1, step_each_epoch=10)
    jbatch = tuple(jnp.asarray(b) for b in batch)
    params, batch_stats = variables["params"], variables.get("batch_stats", {})

    @jax.jit
    def step(params, batch_stats, opt_state):
        def loss_inner(p):
            preds, mut = jmodel.apply({"params": p, "batch_stats": batch_stats}, jbatch[0],
                                      data=jbatch, train=True, mutable=["batch_stats"])
            return loss_fn(preds, jbatch)["loss"], mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_inner, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, loss, grads

    new_params, new_bs, loss, grads = jax.device_get(step(params, batch_stats,
                                                          tx.init(params)))
    runs = {"jax": dict(
        loss=float(loss),
        grads=flax_to_state_dict(model, {"params": grads, "batch_stats": batch_stats}),
        state=flax_to_state_dict(model, {"params": new_params, "batch_stats": new_bs}))}
    for dtype in (torch.float32, torch.float64):
        one, _, losses = _steps_in_one_process(cfg, state, batch, steps=10, dtype=dtype)
        runs["one_" + str(dtype)[-2:]] = dict(
            loss=losses["loss"], state=one.state_dict(),
            grads={k: p.grad for k, p in one.named_parameters() if p.grad is not None})
    for name, world in worlds.items():
        runs[name + "_ranks"] = world.results()
    return dict(runs=runs, state=state,
                trained=[k for k, p in model.named_parameters() if p.requires_grad])


def _gathered(ranks, field, data_rank=0):
    """A data rank's tensors with the head's split leaves put back together
    from its model ranks, in model-rank order."""
    row = sorted((r for r in ranks if r["data_rank"] == data_rank), key=lambda r: r["model_rank"])
    out = dict(row[0][field])
    for k in row[0]["split"]:
        if k in out:
            out[k] = torch.cat([r[field][k] for r in row])
    return out


# the one-rank port CRNN step against JAX's, measured here: loss 2e-7
# relative, the worst gradient leaf 2.9e-3 relative L2 (VGG's first conv),
# every parameter within 2e-3 of JAX's (Adam at lr 1e-3 moves each by up to
# lr) and 97% within 1e-5; the float64 2x2 step against the float64 one-rank
# step: the reductions' order alone
CRNN_F32 = dict(loss=1e-6, grad=1e-2, update=(2e-3, 1e-5))
CRNN_F64 = dict(loss=1e-12, grad=1e-10, update=(1e-9, 1e-12))


@pytest.mark.parametrize("run, ref, bounds", [
    ("f32", "jax", CRNN_F32), ("one_32", "jax", CRNN_F32), ("f64", "one_64", CRNN_F64)],
    ids=["2x2-f32-vs-jax", "world1-f32-vs-jax", "2x2-vs-world1-f64"])
def test_crnn_dp_tp_step_at_2x2_is_the_step_on_the_global_batch(crnn, run, ref, bounds):
    runs, want = crnn["runs"], crnn["runs"][ref]
    if run == "one_32":
        rows = [(runs[run]["loss"], runs[run]["grads"], runs[run]["state"])]
    else:
        ranks = runs[run + "_ranks"]
        assert sorted((r["data_rank"], r["model_rank"]) for r in ranks) == [
            (0, 0), (0, 1), (1, 0), (1, 1)]
        for r in ranks:  # the head really is split: half the 64 columns on each model rank
            assert r["split"] == ["head.fc.weight", "head.fc.bias"]
            assert r["state"]["head.fc.weight"].shape == (32, 64)
            assert r["state"]["head.fc.bias"].shape == (32,)
        # the data ranks hold the same shards, the model ranks of a row the
        # same replicated leaves: bit for bit
        by_place = {(r["data_rank"], r["model_rank"]): r for r in ranks}
        for (d, m), r in by_place.items():
            for k, v in r["state"].items():
                assert torch.equal(v, by_place[(0, m)]["state"][k]), (d, m, k)
                if k not in r["split"]:
                    assert torch.equal(v, by_place[(d, 0)]["state"][k]), (d, m, k)
        rows = [(float(by_place[(d, 0)]["losses"]["loss"]), _gathered(ranks, "grads", d),
                 _gathered(ranks, "state", d)) for d in (0, 1)]
    for loss, grads, state in rows:
        assert loss == pytest.approx(want["loss"], rel=bounds["loss"])
        assert set(grads) == set(crnn["trained"])
        for k, g in grads.items():
            if float(want["grads"][k].norm()) < 1e-5:  # a conv bias before a train-mode BN
                assert float(g.norm()) < 1e-5, k
                continue
            assert _rel(g, want["grads"][k]) < bounds["grad"], (k, _rel(g, want["grads"][k]))
        moved = torch.cat([(state[k] - crnn["state"][k]).double().flatten() for k in grads])
        wmoved = torch.cat([(want["state"][k] - crnn["state"][k]).double().flatten()
                            for k in grads])
        err = (moved - wmoved).abs()
        assert float(err.max()) <= bounds["update"][0]
        assert float((err <= bounds["update"][1]).double().mean()) >= 0.97


# ---------------------------------------------------------------- (d) loader shards


@pytest.mark.parametrize("n, world", [(8, 2), (7, 2), (8, 3), (10, 3)])
def test_loader_shards_match_the_jax_loader(n, world):
    from pytorchocr_tpu.data.loader import OCRDataLoader as JaxLoader

    dataset = list(range(n))
    for epoch in (0, 3):
        shards = []
        for rank in range(world):
            ours = OCRDataLoader(dataset, 2, shuffle=True, seed=11, shard_index=rank,
                                 num_shards=world)
            theirs = JaxLoader(dataset, 2, shuffle=True, seed=11, shard_index=rank,
                               num_shards=world)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = ours._epoch_indices()
            np.testing.assert_array_equal(got, theirs._epoch_indices())
            assert len(ours) == len(theirs)
            shards.append(got)
        # every sample is seen, each shard as long as the others (padded by wrap-around)
        assert len({len(s) for s in shards}) == 1
        assert set(np.concatenate(shards)) == set(range(n))


def test_build_dataloader_takes_the_mesh_shard(tmp_path, monkeypatch):
    import synth
    from pytorchocr_tpu import data as jax_data
    from pytorchocr_tpu_torch import data as port_data

    label = synth.make_det_dataset(str(tmp_path / "data"), n=5, size=160, seed=1)
    cfg = load_config(tiny_det_config(tmp_path / "cfg.yml", "configs/det/det_r18_db_synth.yml",
                                      label, label, tmp_path / "out"))
    for rank in range(2):
        monkeypatch.setattr(port_data, "data_shard", lambda r=rank: (r, 2))
        monkeypatch.setattr(jax_data, "_process_info", lambda r=rank: (r, 2))
        ours, _ = port_data.build_dataloader(cfg, "Train", get_logger())
        theirs, _ = jax_data.build_dataloader(cfg, "Train", get_logger())
        np.testing.assert_array_equal(ours._epoch_indices(), theirs._epoch_indices())
        assert (ours.shard_index, ours.num_shards) == (rank, 2)
        evals, _ = port_data.build_dataloader(cfg, "Eval", get_logger())
        assert (evals.shard_index, evals.num_shards) == (0, 1)  # eval is not sharded


# ---------------------------------------------------------------- (e) SLANet

MAX_LEN, SIZE, N_CLS, TD = 12, 64, 50, 48


def _table_batch(n=4, seed=0):
    """A seeded batch as tests/test_torch_train_table.py draws them."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)
    structure = np.zeros((n, MAX_LEN + 2), np.int64)
    masks = np.zeros((n, MAX_LEN + 2, 1), np.float32)
    for i in range(n):
        k = rng.randint(3, MAX_LEN)
        structure[i, 1:k + 1] = np.where(rng.rand(k) < 0.5, TD, rng.randint(1, N_CLS - 1, k))
        structure[i, k + 1] = N_CLS - 1
        masks[i, 1:k + 1, 0] = rng.rand(k) > 0.5
    bboxes = (rng.rand(n, MAX_LEN + 2, 8) * masks).astype(np.float32)
    counts = [rng.randint(1, 6, n).astype(np.int32) for _ in range(2)]
    shape = np.tile(np.array([SIZE, SIZE, 1.0, 1.0, SIZE, SIZE]), (n, 1))
    return [images, structure, bboxes, masks, *counts, shape]


# SLANet world 2 against world 1, measured: float32 loss terms 1.2e-5
# relative, gradients 4.3e-3 relative L2 (BN over 2 and 4 64x64 tables); float64
# (the head's logits and locs still float32) 2.1e-16 and 1.1e-11
TABLE_BOUNDS = {torch.float32: (1e-4, 2e-2), torch.float64: (1e-12, 1e-9)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_table_step_at_world_2_equals_world_1(tmp_path, dtype):
    """SLANet with scheduled sampling 0.25: each rank draws the coins of the
    global batch and keeps its rows, and the loc loss is a global sum over
    a global count, so world 2 is world 1 up to rounding. The control (in
    float64): each rank drawing its own (N, steps) coins, rank 1 then takes
    rank 0's, is another step."""
    import synth

    label = synth.make_pubtab_dataset(str(tmp_path / "data"), n=4, size=SIZE)
    cfg = program.preprocess(argv=["-c", tiny_table_config(tmp_path / "t.yml", label,
                                                           tmp_path / "out", 0.25, MAX_LEN,
                                                           SIZE)])[0]
    cfg["Architecture"]["Head"]["out_channels"] = N_CLS
    model = build_model(cfg["Architecture"])
    seeded_init_(model, torch.Generator().manual_seed(3))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    job = dict(kind="step", cfg=cfg, state=state, batch=_table_batch(), epochs=1,
               steps_per_epoch=4, dtype=dtype)
    worlds = [World(tmp_path, "table", job, 2)]
    if dtype == torch.float64:
        worlds.append(World(tmp_path, "table_own", dict(job, kind="own_coins"), 2))
    one, _, losses = _steps_in_one_process(cfg, state, job["batch"], dtype=dtype)
    loss_rtol, grad_rtol = TABLE_BOUNDS[dtype]
    for i, world in enumerate(worlds):
        ranks = world.results()
        _assert_ranks_identical(ranks)
        assert {"loss", "structure_loss", "loc_loss"} <= set(losses)
        worst_loss = max(abs(float(ranks[0]["losses"][k]) - v) / abs(v)
                         for k, v in losses.items())
        worst_grad = max(_rel(ranks[0]["grads"][k], p.grad) for k, p in one.named_parameters()
                         if p.grad is not None)
        if i == 0:
            assert worst_loss < loss_rtol and worst_grad < grad_rtol, (worst_loss, worst_grad)
        else:
            assert worst_loss > 1e6 * loss_rtol and worst_grad > 1e6 * grad_rtol


# ---------------------------------------------------------------- (f) torchrun CLI


def test_torchrun_trains_on_two_ranks_and_rank_0_writes(tmp_path):
    import synth

    label = synth.make_det_dataset(str(tmp_path / "data"), n=8, size=160, seed=3)
    eval_label = tmp_path / "eval.txt"
    eval_label.write_text("".join(open(label).readlines()[:2]))
    cfg = tiny_det_config(tmp_path / "cfg.yml", "configs/det/det_r18_db_synth.yml", label,
                          eval_label, tmp_path / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "pytorchocr_tpu_torch.tools.train", "-c", cfg, "-o", "Global.use_gpu=False",
         "Global.seed=5"], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = tmp_path / "out"
    log = (out / "train.log").read_text()
    # rank 0 alone logs: one start line, naming the world; 2 steps of 2 a rank
    assert log.count("train with torch") == 1 and "rank 0 of 2 (gloo)" in log
    assert "rank 0 of 2 (gloo, data world 2): 2 steps" in log
    assert "without the torchrun environment" not in log
    for prefix in ("latest", "best_accuracy"):
        assert (out / prefix / "state.pt").is_file()
        assert json.loads((out / prefix / "global_state.json").read_text())["global_step"] == 2
    assert not [p for p in os.listdir(out) if p.endswith((".staging", ".old"))]
    state = torch.load(out / "latest" / "state.pt", weights_only=True)
    assert not any(k.startswith("module.") for k in state["model"])
    line = re.findall(r"cur metric, (.*)", log)[-1]
    best = {k: float(v) for k, v in (kv.split(": ") for kv in line.split(", "))}
    # the checkpoint loads in one process, to the run's metric
    got = subprocess.run(
        [sys.executable, "-c", "import json, sys; from pytorchocr_tpu_torch.tools import eval; "
         "print('RESULT ' + json.dumps(eval.run(sys.argv[1:])))", "-c", cfg, "-o",
         "Global.use_gpu=False", "Global.checkpoints=%s" % (out / "best_accuracy")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    metric = json.loads([ln for ln in got.stdout.splitlines() if ln.startswith("RESULT ")][-1][7:])
    for k in ("precision", "recall", "hmean"):
        assert metric[k] == pytest.approx(best[k], abs=1e-12), k
