"""DB++'s loss plateau, held against the JAX package on the CPU.

At det_r18_dbpp_synth.yml's LR the port's ASF attention scores collapsed
within ~25 steps on the card (chip_dbpp_plateau.py, PERF.md). Here both
packages train the same model from one JAX init, bridged into the port, at
a small width (ResNet-18, FPN 32 with the ASF attention
scale_channel_spatial, DBHead k=50; 64x64 crops of drawn 160x160 pages
through the config's train chain, bs 2): STEPS float32 steps on the same
batches with the config's amsgrad + WarmupPolyLR at its base LR, the
schedule counted in steps as the trainer counts it (warmup_epoch 3 x the
loader's 2 steps an epoch). After every step each package reads, on one
fixed probe batch in train mode (no update; the port's BN statistics put
back): the loss and its three terms, and the mean and the largest of the
ASF scores. flax runs with its stable batch variance, as in
test_torch_train_step.py.

The tolerance is measured, not chosen. A float64 copy of the port's model
takes the same steps beside it (the DB head's sigmoids stay float32, as the
module computes them); S_k, the largest relative distance of the port's
float32 readings from that copy's after steps 1..k, is the float32 error of
one step compounded through k steps of Adam (whose early updates are lr
times a gradient's sign: an element whose gradient lies within rounding of
0 moves either way, and the runs part further each step until S levels
off). Every reading of the port must lie within 2 S_K of the JAX one
(relative): two float32 runs, each up to the whole run's compounded error
from float64. The bound is that one value at every step: a package's early
steps may carry more float32 error than the port's float64 copy shows (the
JAX run lay 4.2 S_2 from the port after step 2, 1.1 S_k or less from step 6
on), so a bound that widened step by step with S_k would flag rounding.
Measured on this CPU (K = STEPS = 24): S_1 1.5e-4, S_6 1.2e-2, S_K 1.7e-2;
the packages at most 1.8e-2 apart (the score mean); a second float32 run of
the port in channels_last layout drifted as far (1.9e-2 by step 18) from
the first.

Finding: the scores move alike in both packages (their mean 0.49 to 0.54
over these steps in both, neither collapsing at this width): the port follows the JAX
model step for step within float32 rounding, so the plateau the card showed
at full width is the model's own at that width, not a port fault (ROADMAP.md
C, closed by this test).
"""

import random

import numpy as np
import torch

from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.trainer import batch_to_device, float_preds, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.weights import load_flax_variables
from torch_port_util import same_native_path, shaped_train_state, tiny_det_config

CPU = torch.device("cpu")
STEPS = 24
KEYS = ("loss", "loss_shrink_maps", "loss_threshold_maps", "loss_binary_maps", "score_mean",
        "score_max")


class PortReader:
    """The port's readings on the probe batch: the loss terms and the ASF
    scores of a train-mode forward, its BN statistics put back."""

    def __init__(self, model, loss_fn, probe, dtype):
        self.model, self.loss_fn, self.dtype = model, loss_fn, dtype
        self.probe = tuple(x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
                           for x in batch_to_device(probe, CPU))
        self.seen = {}
        model.neck.concat_attention.att.register_forward_hook(
            lambda m, i, o: self.seen.__setitem__("score", o.detach()))

    def __call__(self):
        saved = {k: v.clone() for k, v in self.model.state_dict().items()
                 if "running" in k or "num_batches" in k}
        self.model.train()
        with torch.no_grad():
            x = self.probe[0].permute(0, 3, 1, 2)
            losses = self.loss_fn(float_preds(self.model(x, data=self.probe), self.dtype),
                                  self.probe)
            for k, v in self.model.state_dict().items():
                if k in saved:
                    v.copy_(saved[k])
        score = self.seen["score"]
        out = {k: float(v) for k, v in losses.items()}
        out.update(score_mean=float(score.mean()), score_max=float(score.max()))
        return out


def test_dbpp_asf_scores_follow_jax_step_for_step(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    import synth
    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    label = synth.make_det_dataset(str(tmp_path / "data"), n=4, size=160, seed=0)
    cfg = load_config(tiny_det_config(tmp_path / "cfg.yml", "configs/det/det_r18_dbpp_synth.yml",
                                      label, label, tmp_path / "out"))
    same_native_path()
    loader, _ = build_dataloader(cfg, "Train", get_logger())
    random.seed(1)
    np.random.seed(1)
    batches = []
    while len(batches) < STEPS + 1:
        batches += list(loader)
    probe, batches = batches[STEPS], batches[:STEPS]
    schedule = dict(epochs=STEPS // len(loader), step_each_epoch=len(loader))

    jmodel, jloss = jax_build_model(cfg["Architecture"]), jax_build_loss(cfg["Loss"])
    tx, _ = jax_build_optimizer(cfg["Optimizer"], **schedule)
    jstate = shaped_train_state(jmodel, tx, np.asarray(batches[0][0], np.float32))
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    jstep = jax_make_train_step(jmodel, jloss, tx, create_mesh(devices=jax.devices()[:1]),
                                donate=False)
    jprobe = tuple(jnp.asarray(b) for b in probe)

    @jax.jit
    def jax_reading(params, batch_stats):
        preds, inter = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, jprobe[0], train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "att")
        score = jax.tree.leaves(inter["intermediates"])[0]
        return dict(jloss(preds, jprobe), score_mean=score.mean(), score_max=score.max())

    loss_fn = build_loss(cfg["Loss"])
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = build_model(cfg["Architecture"])
        load_flax_variables(model, variables)
        model.to(dtype)
        opt, _ = build_optimizer(cfg["Optimizer"], parameters=model.parameters(), **schedule)
        runs[dtype] = (make_train_step(model, loss_fn, opt),
                       PortReader(model, loss_fn, probe, dtype))

    def rel(a, b):
        return max(abs(a[k] - b[k]) / abs(b[k]) for k in KEYS)

    shadow, rows = 0.0, []
    for k, batch in enumerate(batches, 1):
        jstate, _ = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
        want = {key: float(v) for key, v in jax_reading(jstate.params, jstate.batch_stats).items()}
        read = {}
        for dtype, (step, reader) in runs.items():
            step(tuple(x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
                       for x in batch_to_device(batch, CPU)))
            read[dtype] = reader()
        shadow = max(shadow, rel(read[torch.float32], read[torch.float64]))
        rows.append((k, shadow, rel(read[torch.float32], want), read[torch.float32]["score_mean"],
                     want["score_mean"], read[torch.float32]["score_max"], want["score_max"]))
    for k, s_k, apart, *_ in rows:
        assert apart <= 2 * shadow, (
            "step %d: the port's readings lie %.3g from the JAX ones, past twice the float32 "
            "error compounded over the run (%.3g); (step, S_k, apart, port and JAX score mean "
            "and max): %s" % (k, apart, shadow, rows))
