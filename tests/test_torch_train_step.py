"""The port's train step, evaluate, metric and checkpoints against the JAX
package's, on the CPU: a small DB model (ResNet-18 at 64x64 input, FPN 32,
batch 2, float32) bridged from the JAX init, fed the same two loader
batches.

flax's BatchNorm computes the batch variance as E[x^2] - E[x]^2 in float32
(use_fast_variance), which loses digits wherever |mean| >> std
(test_torch_train_loss_optim.py::test_flax_fast_batch_variance_loses_digits_the_port_keeps);
the port's F.batch_norm computes it stably. Left as it is, that rounding
moves the early layers' gradients, through the 20 train-mode BNs, well past
the bound below. The train-step test therefore runs flax with its stable
variance
(`_compute_stats(use_fast_variance=False)`, a rounding choice, not another
function); then every gradient agrees to a relative L2 of 5e-4. Adam
normalises each update to about the LR, so a gradient within rounding of 0
may move its parameter +-lr on one side and -+lr on the other: the
parameters after 2 steps must agree within 2 x (lr_1 + lr_2) everywhere,
within 0.1 x lr_1 on >= 97% of them, with the updates correlated > 0.999.
The losses to rtol 1e-6 at step 1 and 1e-4 at step 2 (after those +-lr
moves), the BN running statistics (the port blends in the stable variance
its normalisation used, as flax's stable mode does) to rtol 2e-2 / atol
2e-3 after 2 steps."""

import copy
import os
import random
import sys

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.metrics import build_metric
from pytorchocr_tpu_torch.metrics.eval_det_iou import DetectionIoUEvaluator
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import program
from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.save_load import load_model, save_model
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import same_native_path, tiny_det_config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    import synth
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.trainer import create_train_state

    tmp = tmp_path_factory.mktemp("train_step")
    label = synth.make_det_dataset(str(tmp / "data"), n=6, size=160, seed=0)
    eval_label = tmp / "eval_label.txt"
    eval_label.write_text("".join(open(label).readlines()[:3]))
    cfg = load_config(tiny_det_config(tmp / "cfg.yml", "configs/det/det_r18_db_synth.yml",
                                      label, eval_label, tmp / "out"))
    cfg["Global"]["distributed"] = False
    loader, _ = build_dataloader(cfg, "Train", get_logger())
    random.seed(1)
    np.random.seed(1)
    batches = list(loader)[:2]
    jmodel = jax_build_model(cfg["Architecture"])
    tx, jsched = jax_build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=len(loader))
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), batches[0])
    variables = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    return dict(cfg=cfg, tmp=tmp, batches=batches, jmodel=jmodel, tx=tx, jsched=jsched,
                state=state, variables=variables, steps_per_epoch=len(loader))


def _port(s):
    model = build_model(s["cfg"]["Architecture"])
    load_flax_variables(model, s["variables"])
    opt, _ = build_optimizer(s["cfg"]["Optimizer"], epochs=1,
                             step_each_epoch=s["steps_per_epoch"], parameters=model.parameters())
    return model, opt, make_train_step(model, build_loss(s["cfg"]["Loss"]), opt)


def test_two_train_steps_match_jax_make_train_step(setup, monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    s = setup
    jloss = jax_build_loss(s["cfg"]["Loss"])
    jstate = s["state"]

    def loss_at(params, batch):
        preds, _ = s["jmodel"].apply({"params": params, "batch_stats": jstate.batch_stats},
                                     jnp.asarray(batch[0]), train=True, mutable=["batch_stats"])
        return jloss(preds, tuple(jnp.asarray(b) for b in batch))["loss"]

    jgrad = jax.jit(jax.grad(loss_at))(jstate.params, tuple(s["batches"][0]))
    jstep = jax_make_train_step(s["jmodel"], jloss, s["tx"],
                                create_mesh(devices=jax.devices()[:1]), donate=False)
    model, opt, step = _port(s)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    lrs = []
    for i, batch in enumerate(s["batches"]):
        lrs.append(opt.current_lr())
        assert lrs[-1] == pytest.approx(float(s["jsched"](i)), rel=1e-6)
        jstate, jl = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
        tl = step(batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-4 if i else 1e-6)
        if i == 0:
            want = flax_to_state_dict(model, {"params": jax.device_get(jgrad),
                                              "batch_stats": s["variables"]["batch_stats"]})
            for k, p in model.named_parameters():
                if k.endswith("deconv1.bias"):  # a bias before a train-mode BN: 0 + rounding
                    assert float(want[k].norm()) < 1e-5 and float(p.grad.norm()) < 1e-5
                    continue
                rel = float((p.grad - want[k]).norm() / want[k].norm())
                assert rel < 5e-4, (k, rel)

    after = flax_to_state_dict(model, {"params": jax.device_get(jstate.params),
                                       "batch_stats": jax.device_get(jstate.batch_stats)})
    dt = torch.cat([(p.detach() - p0[k]).flatten() for k, p in model.named_parameters()])
    dj = torch.cat([(after[k] - p0[k]).flatten() for k, _ in model.named_parameters()])
    err = (dt - dj).abs()
    assert float(err.max()) <= 2 * (lrs[0] + lrs[1])
    assert float((err <= 0.1 * lrs[0]).float().mean()) >= 0.97
    assert float(torch.corrcoef(torch.stack([dt, dj]))[0, 1]) > 0.999
    sd = model.state_dict()
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=k)


def _self_labelled_eval(s, tmp):
    """The eval loader over 3 pages at their 160x160 size, relabelled with
    the boxes the JAX model (the bridged init weights) and the JAX DB
    postprocess find on them: the JAX evaluate scores hmean 1 there, and the
    port's scores the same only if its boxes are the JAX ones."""
    import json

    import jax

    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.postprocess import build_post_process as jax_build_post_process
    from pytorchocr_tpu.trainer import make_eval_step as jax_make_eval_step

    cfg = copy.deepcopy(s["cfg"])
    cfg["Eval"]["dataset"]["transforms"][2]["DetResizeForTest"]["limit_side_len"] = 160
    loader, _ = build_dataloader(cfg, "Eval", get_logger())
    jstep = jax_make_eval_step(s["jmodel"], create_mesh(devices=jax.devices()[:1]))
    post = jax_build_post_process(cfg["PostProcess"], cfg["Global"])
    lines = []
    for line, batch in zip(loader.dataset.data_lines, loader):
        preds = jstep(s["variables"]["params"], s["variables"]["batch_stats"], batch[0])
        boxes = post(preds, batch[1])[0]["points"]
        label = [{"transcription": "x", "points": np.asarray(b).tolist()} for b in boxes]
        lines.append("%s\t%s" % (line.decode().split("\t")[0], json.dumps(label)))
    (tmp / "self_label.txt").write_text("\n".join(lines) + "\n")
    cfg["Eval"]["dataset"]["label_file_list"] = [str(tmp / "self_label.txt")]
    return cfg, build_dataloader(cfg, "Eval", get_logger())[0], sum(len(json.loads(
        ln.split("\t")[1])) for ln in lines)


def test_evaluate_matches_jax_evaluate(setup):
    """program.evaluate (shape buckets, padded-pow2 batches, the postprocess
    behind the next forward) against the JAX evaluate with the same weights
    on 3 pages labelled with the JAX run's own boxes: the same precision,
    recall and hmean, 1.0 on both."""
    import jax
    from program import evaluate as jax_evaluate

    from pytorchocr_tpu.metrics import build_metric as jax_build_metric
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.postprocess import build_post_process as jax_build_post_process
    from pytorchocr_tpu.trainer import make_eval_step as jax_make_eval_step

    s = setup
    same_native_path()
    cfg, loader, n_boxes = _self_labelled_eval(s, s["tmp"])
    assert n_boxes >= 3
    model = build_model(cfg["Architecture"])
    load_flax_variables(model, s["variables"])
    got = program.evaluate(make_eval_step(model), loader,
                           build_post_process(cfg["PostProcess"], cfg["Global"]),
                           build_metric(cfg["Metric"]), "det", CPU)
    mesh = create_mesh(devices=jax.devices()[:1])
    want = jax_evaluate(s["state"], jax_make_eval_step(s["jmodel"], mesh), mesh, loader,
                        jax_build_post_process(cfg["PostProcess"], cfg["Global"]),
                        jax_build_metric(cfg["Metric"]), "det")
    for k in ("precision", "recall", "hmean"):
        assert got[k] == want[k], k
    assert want["hmean"] == 1.0


def _polys(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.choice([4, 4, 6]))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        c = rng.uniform(20, 100, 2)
        r = rng.uniform(5, 30, k)
        out.append(np.stack([c[0] + r * np.cos(ang), c[1] + 0.6 * r * np.sin(ang)], 1))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_det_metric_matches_jax(seed):
    """DetMetric and DetectionIoUEvaluator on seeded quads and hexagons, with
    ignored ground truth and near-duplicate detections, exactly."""
    from pytorchocr_tpu.metrics import build_metric as jax_build_metric
    from pytorchocr_tpu.metrics.eval_det_iou import DetectionIoUEvaluator as JaxEvaluator

    same_native_path()
    rng = np.random.RandomState(seed)
    got_m, want_m = build_metric({"name": "DetMetric"}), jax_build_metric({"name": "DetMetric"})
    for page in range(4):
        gt = _polys(rng, 5)
        dets = [p + rng.uniform(-3, 3, p.shape) for p in gt[:4]] + _polys(rng, 2)
        quad = [d for d in dets if len(d) == 4]
        tags = rng.rand(len(gt)) < 0.25
        batch = [None, None, [gt], [tags]]
        preds = [{"points": quad if page % 2 else dets}]
        got_m(copy.deepcopy(preds), batch)
        want_m(copy.deepcopy(preds), batch)
        g = [{"points": p, "text": "", "ignore": bool(t)} for p, t in zip(gt, tags)]
        d = [{"points": p, "text": ""} for p in dets]
        assert DetectionIoUEvaluator().evaluate_image(g, d) == JaxEvaluator().evaluate_image(g, d)
    assert got_m.get_metric() == want_m.get_metric()


def test_checkpoint_resume_equals_the_uninterrupted_step(setup):
    """Save `latest` after step 1, load it into a fresh model and optimizer,
    take step 2: the parameters, BN statistics and optimizer state equal the
    uninterrupted run's exactly; global_state comes back."""
    s = setup
    out = str(s["tmp"] / "ckpt")
    model, opt, step = _port(s)
    step(batch_to_device(s["batches"][0], CPU))
    save_model(model, opt, {"start_epoch": 0, "global_step": 1, "best_model": {}}, out,
               prefix="latest")
    step(batch_to_device(s["batches"][1], CPU))

    fresh, fresh_opt, fresh_step = _port(s)
    cfg = copy.deepcopy(s["cfg"])
    cfg["Global"]["checkpoints"] = os.path.join(out, "latest")
    assert load_model(cfg, fresh, fresh_opt)["global_step"] == 1
    assert fresh_opt.param_groups[0]["count"] == 1
    fresh_step(batch_to_device(s["batches"][1], CPU))
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(model.parameters(), fresh.parameters()):
        for key in ("mu", "nu", "nu_max"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])
    assert not os.path.exists(os.path.join(out, "latest.staging"))


def test_frozen_subtree_gets_neither_moments_nor_updates():
    """make_train_step's `frozen` (the JAX _mask_frozen_updates,
    trainer.py:110): while the step count is below `until`, the named
    top-level submodule's gradients are zeroed before the update (its
    moments see zeros) and its parameters are put back after it; from
    `until` on it trains."""
    from torch import nn

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.transform = nn.Linear(3, 3)
            self.head = nn.Linear(3, 1)

        def forward(self, x, data=None):
            return {"out": self.head(self.transform(x.flatten(1)))}

    torch.manual_seed(0)
    net = Net()
    opt, _ = build_optimizer({"base_lr": 0.01, "optim": {"name": "Adam", "amsgrad": True}},
                             epochs=1, step_each_epoch=4, parameters=net.parameters())
    step = make_train_step(net, lambda preds, batch: {"loss": preds["out"].pow(2).sum()}, opt,
                           frozen=(("transform", 2),))
    before = [p.detach().clone() for p in net.transform.parameters()]
    head = [p.detach().clone() for p in net.head.parameters()]
    x = torch.randn(4, 1, 1, 3)  # NHWC: the step permutes to (4, 3, 1, 1)
    for _ in range(2):
        step((x,))
    for p, b in zip(net.transform.parameters(), before):
        assert torch.equal(p, b) and not opt.state[p]["mu"].any()
    assert not all(torch.equal(p, h) for p, h in zip(net.head.parameters(), head))
    step((x,))
    assert not all(torch.equal(p, b) for p, b in zip(net.transform.parameters(), before))


def test_pretrained_loads_by_name_and_shape(setup, tmp_path):
    """Architecture.Backbone.{pretrained, ckpt_path} (det_r18_db.yml's
    ImageNet init): a missing path is skipped, as in JAX; a .pt of the
    backbone loads into the backbone. Global.pretrained_model: the
    parameters of a port checkpoint, matched by name and shape."""
    from pytorchocr_tpu_torch.utils.save_load import (load_backbone_pretrained,
                                                      load_pretrained_params)

    s = setup
    src, opt, _ = _port(s)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(1.0)
    dst = build_model(s["cfg"]["Architecture"])
    arch = {"Backbone": {"pretrained": True, "ckpt_path": str(tmp_path / "missing.pt")}}
    before = copy.deepcopy(dst.state_dict())
    load_backbone_pretrained(dst, arch)
    assert all(torch.equal(before[k], v) for k, v in dst.state_dict().items())
    torch.save(src.backbone.state_dict(), tmp_path / "backbone.pt")
    arch["Backbone"]["ckpt_path"] = str(tmp_path / "backbone.pt")
    load_backbone_pretrained(dst, arch)
    assert all(torch.equal(v, dst.backbone.state_dict()[k])
               for k, v in src.backbone.state_dict().items())
    assert torch.equal(dst.head.binarize.deconv2.weight, before["head.binarize.deconv2.weight"])
    save_model(src, opt, {}, str(tmp_path), prefix="best_accuracy")
    load_pretrained_params(dst, str(tmp_path / "best_accuracy"))
    assert all(torch.equal(v, dst.state_dict()[k]) for k, v in src.state_dict().items())
