"""DB++ and STAR-Net training in the port against the JAX package, on the
CPU: two train steps of a small DB++ (det_r18_dbpp_synth.yml: ResNet-18,
FPN 32 with ASF scale_channel_spatial, 64x64 crops, batch 2) and of a small
STAR-Net (rec_vgg_tps_bilstm_ctc_synth.yml: TPS small, VGG v1 x0.5, BiLSTM
48, 1x32x64 lines, batch 4) against the JAX `make_train_step`, from the
same weights bridged into the port (DB++: random, in the JAX layout,
torch_port_util.shaped_train_state; STAR-Net: the JAX init) and the same
batches, with each config's optimizer (amsgrad + WarmupPolyLR). The
STAR-Net's TPS is RARE's init perturbed so that its grid moves with the
input but stays inside [-1, 1]: beyond the edge the JAX sampler makes the
rows past it equal within rounding, and the max-pools' near-ties among them
route VGG's gradient by rounding (3% off a float64 step, on both sides);
the sampler's values and gradients there are held by
tests/test_torch_star_net.py, and the card's step by chip_smoke.py's
float64 step on the card's pieces. The STAR-Net steps cross the unfreeze:
the transform is frozen for step 1 (`frozen=(("transform", 1),)`, as
`Global.freeze_transform_epochs` sets it), its parameters stay bit for bit
while its BN statistics move, and step 2 moves it from the moments the
zero gradients left. (STAR-Net's steps run in tests/test_torch_star_net.py,
which also holds its train -> eval -> serve round.) Then a small DB++
through train -> eval -> serve.

flax runs with its stable batch variance, as in test_torch_train_step.py
(and for the reason given there). Tolerances, as there and in
test_torch_train_rec_cls.py: the loss rtol 1e-5 at step 1 (DB++'s attention
puts it 2e-6 off, past the 1e-6 of DB) and 1e-4 at step 2; every gradient of
step 1, the transform's included, within 5e-4 relative L2 of its JAX leaf;
where the two float32 gradients differ by more (DB++: backbone leaves, where
the port's float32 gradient on the CPU lies 0.2-0.4% from float64 and JAX's
~5e-5; STAR-Net: the TPS, whose solve turns float32 rounding into 10-17% on
both sides, and VGG behind it), the port's leaf is held to the JAX gradient
in float64 (`_jax_float64_grads`: it equals the port's float64 gradient
within 1e-7, so either side's fault shows): within 2e-2 relative L2 of it
(chip_smoke.py's limit for a float32 step on the card) or no further from it
than twice the JAX float32 leaf, a limit that JAX alone sets;
the parameters after step 1 within 2 x lr_1 everywhere, within 0.1 x lr_1
on >= 97% of them, the updates correlated > 0.999 (STAR-Net 0.998: the
rounding of its TPS output, below); after step 2 within 2 x
(lr_1 + lr_2) everywhere. Step 2's own update is not held elementwise: its
gradient depends on which pixels lie at OHEM's cut after step 1 (DB++;
10% on most leaves from a few pixels) and on VGG inputs that differ by
rounding (STAR-Net: its TPS outputs differ in the last bits, where the
CRNN test feeds both sides the same bits), and Adam turns such differences
into +-lr moves. The unfreeze is held by its arithmetic instead: from the
zero moments of the frozen step, the transform's first update is -0.744 x
lr_2 x sign(g) where |g| >> Adam's eps and smaller elsewhere: on both sides
no element moves more, most move that much, and the two sides' magnitudes
agree within 1e-2 x lr_2 on >= 97% of the elements. The BN running
statistics rtol 2e-2 / atol 2e-3. STAR-Net's batches are drawn lines
(tests/synth.py)."""

import os
import random
import sys

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.deploy import infer_det
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.tools import eval as eval_cli
from pytorchocr_tpu_torch.trainer import batch_to_device, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import (perturbed_tps_params, same_native_path, shaped_train_state,
                             tiny_det_config, tiny_rec_cls_config, train_cli)

CPU = torch.device("cpu")
GRAD_LIMIT = 2e-2  # chip_smoke.py's relative-L2 limit of a float32 leaf against float64


def _rec_batches(tmp, rng, n_batches=2, bs=4):
    """(image, label, length) batches as the rec loader gives them: drawn
    lines (tests/synth.py) through RecResizeImg to 1x32x64, and seeded
    labels of 1-8 characters of 1..36."""
    import cv2

    import synth
    from pytorchocr_tpu_torch.data import create_operators, transform

    label = synth.make_rec_dataset(str(tmp / "lines"), n=n_batches * bs,
                                   charset="0123456789abc")
    ops = create_operators([{"RecResizeImg": {"image_shape": [1, 32, 64]}},
                            {"KeepKeys": {"keep_keys": ["image"]}}])
    paths = [ln.split("\t")[0] for ln in open(label).read().splitlines()]
    images = np.stack([transform({"image": cv2.imread(p, cv2.IMREAD_GRAYSCALE)}, ops)[0]
                       for p in paths]).astype(np.float32)
    out = []
    for b in range(n_batches):
        lengths = rng.randint(1, 9, bs).astype(np.int64)
        labels = np.zeros((bs, 25), np.int64)
        for i, k in enumerate(lengths):
            labels[i, :k] = rng.randint(1, 37, k)
        out.append((images[b * bs : (b + 1) * bs], labels, lengths))
    return out


def setup_steps(kind, tmp):
    import jax

    import synth
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.trainer import create_train_state

    if kind == "dbpp":
        label = synth.make_det_dataset(str(tmp / "data"), n=4, size=160, seed=0)
        cfg_path = tiny_det_config(tmp / "cfg.yml", "configs/det/det_r18_dbpp_synth.yml",
                                   label, label, tmp / "out")
        cfg = load_config(cfg_path)
        cfg["Global"]["distributed"] = False
        same_native_path()
        loader, _ = build_dataloader(cfg, "Train", get_logger())
        random.seed(1)
        np.random.seed(1)
        batches = list(loader)[:2]
    else:
        cfg_path = tiny_rec_cls_config(tmp / "cfg.yml", "starnet", "unused", "unused",
                                       tmp / "out")
        cfg = load_config(cfg_path)
        cfg["Global"]["distributed"] = False
        cfg["Architecture"]["Head"]["out_channels"] = 37
        batches = _rec_batches(tmp, np.random.RandomState(0))
    jmodel = jax_build_model(cfg["Architecture"])
    tx, jsched = jax_build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=2)
    if kind == "dbpp":  # no jitted flax init of the ResNet-18 (8 s on the CPU)
        state = shaped_train_state(jmodel, tx, np.asarray(batches[0][0], np.float32))
    else:
        state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), batches[0])
    params = jax.device_get(state.params)
    if kind == "starnet":  # a TPS whose grid moves with the input, inside [-1, 1]
        params = dict(params, transform=perturbed_tps_params(
            jax.tree.map(np.array, params["transform"]), np.random.RandomState(1), 0.95,
            rare=False))
        state = state.replace(params=params)
    variables = {"params": params, "batch_stats": jax.device_get(state.batch_stats)}
    return dict(kind=kind, cfg=cfg, batches=batches, jmodel=jmodel, tx=tx, jsched=jsched,
                state=state, variables=variables)


def test_dbpp_two_train_steps_match_jax_make_train_step(tmp_path, monkeypatch):
    check_two_steps(setup_steps("dbpp", tmp_path), monkeypatch)


def check_two_steps(s, monkeypatch):
    """The two steps and their checks (module docstring); STAR-Net's run in
    tests/test_torch_star_net.py."""
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    frozen = (("transform", 1),) if s["kind"] == "starnet" else ()
    jloss = jax_build_loss(s["cfg"]["Loss"])
    jstate = s["state"]

    def loss_at(params, batch):
        preds, _ = s["jmodel"].apply({"params": params, "batch_stats": jstate.batch_stats},
                                     jnp.asarray(batch[0]), train=True, mutable=["batch_stats"])
        return jloss(preds, tuple(jnp.asarray(b) for b in batch))["loss"]

    jgrad = jax.device_get(jax.jit(jax.grad(loss_at))(jstate.params, tuple(s["batches"][0])))
    jstep = jax_make_train_step(s["jmodel"], jloss, s["tx"],
                                create_mesh(devices=jax.devices()[:1]), donate=False,
                                frozen=frozen)

    model = build_model(s["cfg"]["Architecture"])
    load_flax_variables(model, s["variables"])
    loss_fn = build_loss(s["cfg"]["Loss"])
    # step 1's gradient without the freeze: the transform's gradients too
    model.train()
    batch0 = batch_to_device(s["batches"][0], CPU)
    loss_fn(model(batch0[0].permute(0, 3, 1, 2), data=batch0), batch0)["loss"].backward()
    want = flax_to_state_dict(model, {"params": jgrad,
                                      "batch_stats": s["variables"]["batch_stats"]})
    f64 = None
    n_tps = 0
    for k, p in model.named_parameters():
        if p.grad is None:
            assert "bias_hh" in k, k
            continue
        if float(want[k].norm()) < 1e-5:  # a bias before a train-mode BN: 0 + rounding
            assert float(p.grad.norm()) < 1e-5, k
            continue
        rel = float((p.grad - want[k]).norm() / want[k].norm())
        if rel >= 5e-4:  # then held to JAX's float64 gradient (module docstring)
            if f64 is None:
                f64 = flax_to_state_dict(model, {"params": _jax_float64_grads(s),
                                                 "batch_stats": s["variables"]["batch_stats"]})
            port_err = float((p.grad.double() - f64[k].double()).norm())
            jax_err = float((want[k].double() - f64[k].double()).norm())
            limit = max(2 * jax_err, GRAD_LIMIT * float(f64[k].norm()))
            assert port_err <= limit, (k, rel, port_err, jax_err, float(f64[k].norm()))
        n_tps += k.startswith("transform.")
    assert n_tps >= (10 if frozen else 0)

    load_flax_variables(model, s["variables"])  # the BN statistics back to the start
    opt, _ = build_optimizer(s["cfg"]["Optimizer"], epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    step = make_train_step(model, loss_fn, opt, frozen=frozen)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    bn0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    named = dict(model.named_parameters())
    lrs = []
    for i, batch in enumerate(s["batches"]):
        lrs.append(opt.current_lr())
        assert lrs[-1] == pytest.approx(float(s["jsched"](i)), rel=1e-6)
        jstate, jl = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
        tl = step(batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-4 if i else 1e-5)
        after = flax_to_state_dict(model, {"params": jax.device_get(jstate.params),
                                           "batch_stats": jax.device_get(jstate.batch_stats)})
        dt = {k: (named[k].detach() - p0[k]).flatten() for k in named}
        dj = {k: (after[k] - p0[k]).flatten() for k in named}
        err = torch.cat([(dt[k] - dj[k]).abs() for k in named])
        assert float(err.max()) <= 2 * sum(lrs), i
        if i == 0:  # step 1's update: the train-step test's limits
            corr = float(torch.corrcoef(torch.stack([torch.cat(list(dt.values())),
                                                     torch.cat(list(dj.values()))]))[0, 1])
            assert float((err <= 0.1 * lrs[0]).float().mean()) >= 0.97
            assert corr > (0.998 if frozen else 0.999), corr
        if frozen and i == 0:  # the transform frozen for step 1 on both sides
            sd = model.state_dict()
            for k in named:
                if k.startswith("transform."):
                    assert torch.equal(named[k].detach(), p0[k]) and torch.equal(after[k], p0[k]), k
            moved = [k for k in bn0 if k.startswith("transform.")
                     and not torch.equal(sd[k], bn0[k])]
            assert len(moved) == 8, moved  # the loc_net's 4 BNs, mean and var
        if frozen and i == 1:
            # the unfreeze: the moments of the frozen step's zero gradients are 0, so
            # the transform's first update is -lr_2 * (0.1 g / (1 - 0.9^2)) /
            # (sqrt(0.001 g^2 / (1 - 0.999^2)) + eps) = -0.744 lr_2 sign(g) where |g|
            # >> eps, less where it is not, on both sides (stale moments would scale
            # it otherwise)
            first = 0.1 / (1 - 0.9 ** 2) / (0.001 / (1 - 0.999 ** 2)) ** 0.5
            mags = [torch.cat([side[k].abs() for k in named if k.startswith("transform.")])
                    for side in (dt, dj)]
            for mag in mags:
                assert float(mag.max()) <= first * lrs[1] * (1 + 1e-3)
                assert float(((mag - first * lrs[1]).abs() <= 1e-3 * lrs[1]).float().mean()) > 0.5
            same = (mags[0] - mags[1]).abs() <= 1e-2 * lrs[1]
            assert float(same.float().mean()) >= 0.97, float(same.float().mean())
    sd = model.state_dict()
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=k)


class _Float64Numpy:
    """jax.numpy with float64 in place of float32, for the JAX package's
    modules to read while `_jax_float64_grads` traces them."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_float64_grads(s):
    """The JAX model's step-1 gradients (flax params tree) in float64, from
    the same weights and batch: x64 on, the model built with float64 and
    every float32 that the JAX package's modules name read as float64, but
    the TPS's system matrices rounded to float32 as the JAX function casts
    them (their rounding moves the TPS's gradients by 20-40%: the solve is
    ill-conditioned)."""
    import jax
    import jax.numpy as jnp

    import pytorchocr_tpu.modeling.transforms.tps as jax_tps
    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.modeling import build_model as jax_build_model

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)

    def rounded(build):
        return lambda *a: build(*a).astype(np.float32).astype(np.float64)

    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("pytorchocr_tpu.") and getattr(m, "jnp", None) is jnp]
    builders = jax_tps._build_inv_delta_C, jax_tps._build_P_hat
    with jax.enable_x64(True):
        try:
            for m in patched:
                m.jnp = _Float64Numpy()
            jax_tps._build_inv_delta_C, jax_tps._build_P_hat = map(rounded, builders)
            jmodel = jax_build_model(s["cfg"]["Architecture"], dtype=jnp.float64)
            jloss = jax_build_loss(s["cfg"]["Loss"])
            batch = tuple(jnp.asarray(np.asarray(b, np.float64)) if np.asarray(b).dtype.kind == "f"
                          else jnp.asarray(b) for b in s["batches"][0])
            batch_stats = f64(s["variables"]["batch_stats"])

            def loss_at(params):
                preds, _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, batch[0],
                                        train=True, mutable=["batch_stats"])
                return jloss(preds, batch)["loss"]

            return jax.device_get(jax.jit(jax.grad(loss_at))(f64(s["variables"]["params"])))
        finally:
            for m in patched:
                m.jnp = jnp
            jax_tps._build_inv_delta_C, jax_tps._build_P_hat = builders


def test_dbpp_train_eval_and_serve_from_the_checkpoint(tmp_path, monkeypatch):
    """`python -m pytorchocr_tpu_torch.tools.train` on a small DB++ config
    in a subprocess that loads no module of jax, flax or the JAX package;
    tools.eval.run on best_accuracy gives the train run's hmean; infer_det's
    main serves best_accuracy and writes a res_*.txt a page."""
    import synth

    label = synth.make_det_dataset(str(tmp_path / "data"), n=4, size=160, seed=3)
    cfg = tiny_det_config(tmp_path / "cfg.yml", "configs/det/det_r18_dbpp_synth.yml", label,
                          label, tmp_path / "out")
    report = train_cli(cfg, "Global.seed=5")
    assert report["steps"] == 2
    ckpt = str(tmp_path / "out" / "best_accuracy")
    metric = eval_cli.run(["-c", cfg, "-o", "Global.use_gpu=False",
                           "Global.checkpoints=%s" % ckpt])
    assert metric["hmean"] == report["best"]["hmean"]
    out = tmp_path / "res"
    monkeypatch.setattr(sys, "argv", ["infer_det", "--config", cfg, "--model_path", ckpt,
                                      "--img_path", os.path.dirname(label), "--out_dir",
                                      str(out), "--device", "cpu"])
    infer_det.main()
    assert len(list(out.glob("res_*.txt"))) == 4
