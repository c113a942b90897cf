"""PSE and PAN training in the port against the JAX package, on the CPU:
small models (ResNet-18 at full depth, FPN / FPEM_FFM and the head at
width 32, 64x64 crops, batch 2, float32) bridged from the JAX init and fed
the same two loader batches of the synth configs' train chains.

As in tests/test_torch_train_step.py (its docstring says why), flax runs
with its stable batch variance. Tolerances: the losses to rtol 1e-5 from
the same parameters (step 1; step 2 from the bridged JAX state) and 5e-4
at step 2 of the two runs (their parameters up to 2 lr apart by then);
every gradient of step 1 to a relative L2 of 5e-4; the parameters after 2
steps within 2 x (lr_1 + lr_2) everywhere (Adam moves a gradient within
rounding of 0 by +-lr), within 0.1 x lr_1 on >= 97% of them, updates
correlated > 0.999; BN running statistics to rtol 2e-2 / atol 2e-3.

The losses threshold on the predictions (OHEM, the kernel-sample mask, the
IoU logs). The pixels that the two forwards put on different sides are
counted and named in every failure message. OHEM's cut is the k-th largest
negative score, a data value: where two negatives' logits lie within
rounding of each other at the cut, the runs keep different ones (the PAN
case keeps 16 other pixels at step 1, one 1/4-resolution logit upsampled
x4; the others flip none). A pixel swapped there moves the text dice by
the difference of two nearly equal sigmoids: the PAN step holds the 1e-5
with its 16.

Then the checkpoint resume (bit for bit), the bucketed evaluate against
the JAX evaluate on 3 pages labelled with the port's boxes (the padding row of
the pow2 batch never reaches the post process), the flax -> torch bridge of
the amsgrad state, and one train -> eval -> infer_det round through the
CLIs."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.losses.det_pse_loss import flipped_pixels
from pytorchocr_tpu_torch.metrics import build_metric
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import program
from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.save_load import load_model, save_model
from pytorchocr_tpu_torch.utils.weights import (flax_to_state_dict, load_flax_variables,
                                                load_optax_adam_state)
from torch_port_util import jax_selections, same_native_path, tiny_det_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
CPU = torch.device("cpu")
# PSE: ResNet-50 cut to ResNet-18 for the CPU. The post processes' thresholds
# are lowered to where the untrained maps of the JAX init make boxes on the
# eval pages (PSE 5-17 a page; PAN 2-4, whose text logits lie near -28)
MODELS = {
    "pse": dict(base="configs/det/det_r50_pse_synth.yml", layers=18, post={"box_thresh": 0.6}),
    "pan": dict(base="configs/det/det_r18_pan_synth.yml", layers=None,
                post={"thresh": -40.0, "box_thresh": 0.0}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request, tmp_path_factory):
    import jax

    import synth
    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.trainer import create_train_state

    name = request.param
    spec = MODELS[name]
    tmp = tmp_path_factory.mktemp("train_" + name)
    label = synth.make_det_dataset(str(tmp / "data"), n=6, size=160, seed=0)
    eval_label = tmp / "eval_label.txt"
    eval_label.write_text("".join(open(label).readlines()[:3]))
    cfg_path = tiny_det_config(tmp / "cfg.yml", spec["base"], label, eval_label, tmp / "out",
                               layers=spec["layers"], post=spec["post"])
    cfg = load_config(cfg_path)
    cfg["Global"]["distributed"] = False
    loader, _ = build_dataloader(cfg, "Train", get_logger())
    batches = _seeded_batches(loader, 1)
    jmodel = jax_build_model(cfg["Architecture"])
    tx, jsched = jax_build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=len(loader))
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), batches[0])
    variables = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    return dict(name=name, cfg=cfg, cfg_path=cfg_path, tmp=tmp, batches=batches, jmodel=jmodel,
                tx=tx, jsched=jsched, state=state, variables=variables,
                steps_per_epoch=len(loader))


def _seeded_batches(loader, seed):
    import random

    random.seed(seed)
    np.random.seed(seed)
    return list(loader)[:2]


def _port(s):
    model = build_model(s["cfg"]["Architecture"])
    load_flax_variables(model, s["variables"])
    opt, _ = build_optimizer(s["cfg"]["Optimizer"], epochs=1,
                             step_each_epoch=s["steps_per_epoch"], parameters=model.parameters())
    return model, opt, make_train_step(model, build_loss(s["cfg"]["Loss"]), opt)


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX side, once per model: the train-mode maps of batch 1, and
    the states after make_train_step's steps 1 and 2 with their losses
    (flax with its stable batch variance)."""
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    s = setup
    stats = normalization._compute_stats
    normalization._compute_stats = lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False})
    try:
        state = s["state"]
        forward = jax.jit(lambda st, b: s["jmodel"].apply(
            {"params": st.params, "batch_stats": st.batch_stats}, b[0], data=b, train=True,
            mutable=["batch_stats"])[0]["maps"])
        jstep = jax_make_train_step(s["jmodel"], jax_build_loss(s["cfg"]["Loss"]), s["tx"],
                                    create_mesh(devices=jax.devices()[:1]), donate=False)
        states, losses, maps = [], [], []
        for b in s["batches"]:
            b = tuple(jnp.asarray(x) for x in b)
            maps.append(np.asarray(forward(state, b)))
            state, jl = jstep(state, b)
            states.append(state)
            losses.append({k: float(v) for k, v in jl.items()})
    finally:
        normalization._compute_stats = stats
    return dict(maps=maps, states=states, losses=losses)


def _state_dict(model, state):
    import jax

    return flax_to_state_dict(model, {"params": jax.device_get(state.params),
                                      "batch_stats": jax.device_get(state.batch_stats)})


def _flips(s, model, batch, jax_maps):
    """The pixels that the port's train-mode forward of `model` and the JAX
    one (`jax_maps`) put on different sides of the loss's thresholds."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        maps = probe(batch[0].permute(0, 3, 1, 2), data=batch)["maps"]
    name = s["cfg"]["Loss"]["name"]
    return flipped_pixels(build_loss(s["cfg"]["Loss"]).selections({"maps": maps}, batch),
                          jax_selections(name, jax_maps, [t.numpy() if torch.is_tensor(t) else t
                                                          for t in batch]))


def test_two_train_steps_match_jax_make_train_step(setup, jax_run):
    """Step 1's gradient is read from the JAX amsgrad state: mu = (1 - b1) g
    after one step, so g = mu / 0.1 to a float32 rounding. Step 2 starts
    from parameters up to 2 lr apart (Adam's moves of gradients within
    rounding of 0), which puts its maps up to ~1e-2 apart: its losses are
    held to rtol 5e-4 here, and to 1e-5 from one state in
    test_optax_amsgrad_state_bridges_into_the_port."""
    import jax

    s, j = setup, jax_run
    model, opt, step = _port(s)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    lrs = []
    for i, batch in enumerate(s["batches"]):
        lrs.append(opt.current_lr())
        assert lrs[-1] == pytest.approx(float(s["jsched"](i)), rel=1e-6)
        b = batch_to_device(batch, CPU)
        flips = _flips(s, model, b, j["maps"][i])
        tl = step(b)
        for k, v in j["losses"][i].items():
            np.testing.assert_allclose(float(tl[k]), v, rtol=5e-4 if i else 1e-5,
                                       err_msg="step %d %s; flipped pixels %s" % (i, k, flips))
        if i == 0:
            mu = {"params": jax.device_get(j["states"][0].opt_state[0].mu),
                  "batch_stats": s["variables"]["batch_stats"]}
            want = {k: v.double() / (1 - 0.9) for k, v in flax_to_state_dict(model, mu).items()}
            for k, p in model.named_parameters():
                g = p.grad.double()
                weight = k[:-4] + "weight"
                if k.endswith(".bias") and float(want[k].norm()) < 1e-4 * float(
                        want[weight].norm()):  # a bias before a train-mode BN: 0 + rounding
                    assert float(g.norm()) < 1e-4 * float(want[weight].norm()), k
                    continue
                rel = float((g - want[k]).norm() / want[k].norm())
                assert rel < 5e-4, (k, rel, flips)

    after = _state_dict(model, j["states"][1])
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


def test_checkpoint_resume_equals_the_uninterrupted_step(setup):
    """Save `latest` after step 1, load it into a fresh model and optimizer,
    take step 2: the state and the amsgrad moments equal the uninterrupted
    run's exactly."""
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
    fresh_step(batch_to_device(s["batches"][1], CPU))
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(model.parameters(), fresh.parameters()):
        for key in ("mu", "nu", "nu_max"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])


def test_optax_amsgrad_state_bridges_into_the_port(setup, jax_run):
    """The JAX train state after one amsgrad step (params, BN statistics,
    mu, nu, nu_max, count) carried into the port by load_flax_variables and
    load_optax_adam_state: the port's step 2 from it gives the JAX step 2's
    losses (rtol 1e-5) and lands where it does (parameters within 0.1 lr on
    >= 97%, 2 lr everywhere)."""
    import jax

    s, st1 = setup, jax_run["states"][0]
    model, opt, step = _port(s)
    variables = {"params": jax.device_get(st1.params),
                 "batch_stats": jax.device_get(st1.batch_stats)}
    load_flax_variables(model, variables)
    ams = st1.opt_state[0]
    load_optax_adam_state(opt, model, {"count": ams.count, "mu": jax.device_get(ams.mu),
                                       "nu": jax.device_get(ams.nu),
                                       "nu_max": jax.device_get(ams.nu_max)},
                          variables["batch_stats"])
    assert opt.param_groups[0]["count"] == 1
    lr = opt.current_lr()
    b = batch_to_device(s["batches"][1], CPU)
    flips = _flips(s, model, b, jax_run["maps"][1])
    tl = step(b)
    for k, v in jax_run["losses"][1].items():
        np.testing.assert_allclose(float(tl[k]), v, rtol=1e-5,
                                   err_msg="%s; flipped pixels %s" % (k, flips))
    after = _state_dict(model, jax_run["states"][1])
    err = torch.cat([(p.detach() - after[k]).abs().flatten()
                     for k, p in model.named_parameters()])
    assert float(err.max()) <= 2 * lr and float((err <= 0.1 * lr).float().mean()) >= 0.97


def _self_labelled_eval(s, model):
    """The eval loader over 3 pages at their 160x160 size, relabelled with
    the boxes that `model` (the bridged JAX init) and the port's post
    process find on each page alone: the port's evaluate then scores hmean
    1, and the JAX evaluate scores the same only if its boxes are these."""
    cfg = copy.deepcopy(s["cfg"])
    cfg["Eval"]["dataset"]["transforms"][2]["DetResizeForTest"]["limit_side_len"] = 160
    loader, _ = build_dataloader(cfg, "Eval", get_logger())
    eval_step = make_eval_step(model)
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    lines = []
    for line, batch in zip(loader.dataset.data_lines, loader):
        boxes = post(eval_step(torch.from_numpy(batch[0])), batch[1])[0]["points"]
        label = [{"transcription": "x", "points": np.asarray(b).tolist()} for b in boxes]
        lines.append("%s\t%s" % (line.decode().split("\t")[0], json.dumps(label)))
    (s["tmp"] / "self_label.txt").write_text("\n".join(lines) + "\n")
    cfg["Eval"]["dataset"]["label_file_list"] = [str(s["tmp"] / "self_label.txt")]
    return cfg, build_dataloader(cfg, "Eval", get_logger())[0], [
        len(json.loads(ln.split("\t")[1])) for ln in lines]


def test_evaluate_matches_jax_evaluate(setup, monkeypatch):
    """program.evaluate (one shape bucket of 3 pages padded to 4, the post
    process behind the next forward) against the JAX evaluate with the same
    weights on pages labelled with the port's boxes of each page alone: the
    same precision, recall and hmean, 1.0 on both; the post
    process's front half runs on the 3 pages only (PSE: K1 and K2 through
    pse_expand_device; PAN: K1 through pa_aggregate_device)."""
    from program import evaluate as jax_evaluate

    import jax

    from pytorchocr_tpu.metrics import build_metric as jax_build_metric
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.postprocess import build_post_process as jax_build_post_process
    from pytorchocr_tpu.trainer import make_eval_step as jax_make_eval_step
    from pytorchocr_tpu_torch.postprocess import pan_postprocess, pse_postprocess

    s = setup
    same_native_path()
    model = build_model(s["cfg"]["Architecture"])
    load_flax_variables(model, s["variables"])
    cfg, loader, n_boxes = _self_labelled_eval(s, model)
    assert min(n_boxes) >= 1 and sum(n_boxes) >= 3, n_boxes
    mod, fn = ((pse_postprocess, "pse_expand_device") if s["name"] == "pse"
               else (pan_postprocess, "pa_aggregate_device"))
    wrapped, pages = getattr(mod, fn), []
    monkeypatch.setattr(mod, fn, lambda *a: pages.append(1) or wrapped(*a))
    got = program.evaluate(make_eval_step(model), loader,
                           build_post_process(cfg["PostProcess"], cfg["Global"]),
                           build_metric(cfg["Metric"]), "det", CPU)
    assert len(pages) == 3
    mesh = create_mesh(devices=jax.devices()[:1])
    want = jax_evaluate(s["state"], jax_make_eval_step(s["jmodel"], mesh), mesh, loader,
                        jax_build_post_process(cfg["PostProcess"], cfg["Global"]),
                        jax_build_metric(cfg["Metric"]), "det")
    for k in ("precision", "recall", "hmean"):
        assert got[k] == want[k], k
    assert got["hmean"] == want["hmean"] == 1.0


def test_pse_train_eval_and_infer_det_through_the_clis(tmp_path, monkeypatch):
    """The CLIs' entry points in this process on the small PSE config:
    tools.train (2 steps, an eval, `latest` and `best_accuracy`), tools.eval
    on `best_accuracy` equal to the train run's metric, and deploy.infer_det
    (its `main`, as `python -m pytorchocr_tpu_torch.deploy.infer_det` runs
    it) on that directory writing the eval post process's boxes for every
    page. (tests/test_torch_train_cli.py runs the train CLI in a subprocess
    that loads no module of jax, flax or the JAX package.)"""
    import synth
    from pytorchocr_tpu_torch.deploy import infer_det
    from pytorchocr_tpu_torch.tools import eval as eval_cli
    from pytorchocr_tpu_torch.tools import train as train_cli
    from pytorchocr_tpu_torch.tools.train import build_train_model
    from pytorchocr_tpu_torch.trainer import build_input_transform
    from pytorchocr_tpu_torch.utils.utility import sort_boxes

    label = synth.make_det_dataset(str(tmp_path / "data"), n=4, size=160, seed=2)
    spec = MODELS["pse"]
    cfg_path = tiny_det_config(tmp_path / "cfg.yml", spec["base"], label, label,
                               tmp_path / "out", layers=spec["layers"], post=spec["post"])
    report = train_cli.run(["-c", cfg_path, "-o", "Global.use_gpu=False"])
    assert report["steps"] == 2
    assert "cur metric, precision:" in (tmp_path / "out" / "train.log").read_text()
    for prefix in ("latest", "best_accuracy"):
        assert (tmp_path / "out" / prefix / "state.pt").is_file()
    ckpt = tmp_path / "out" / "best_accuracy"
    metric = eval_cli.run(["-c", cfg_path, "-o", "Global.use_gpu=False",
                           "Global.checkpoints=%s" % ckpt])
    for k in ("precision", "recall", "hmean"):
        assert metric[k] == report["best"][k], k

    cfg = load_config(cfg_path)
    cfg["Global"]["checkpoints"] = str(ckpt)
    program.extract_device_normalize(cfg)
    loader, _ = build_dataloader(cfg, "Eval", get_logger())
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    model = build_train_model(cfg, CPU)
    load_model(cfg, model)
    eval_step = make_eval_step(model, build_input_transform(
        cfg["Global"]["_device_normalize_spec"]["Eval"]))
    want = {}
    for line, batch in zip(loader.dataset.data_lines, loader):
        boxes = post(eval_step(torch.from_numpy(np.asarray(batch[0]))), batch[1])[0]["points"]
        stem = os.path.splitext(os.path.basename(line.decode().split("\t")[0]))[0]
        want[stem] = [",".join(str(v) for v in np.asarray(b).reshape(-1).tolist())
                      for b in sort_boxes(boxes)]
    assert sum(map(len, want.values())) > 0
    res = tmp_path / "res"
    monkeypatch.setattr(sys, "argv", [
        "infer_det", "--config", cfg_path, "--model_path", str(ckpt), "--img_path",
        str(tmp_path / "data"), "--out_dir", str(res), "--device", "cpu"])
    infer_det.main()
    got = {f.name[len("res_"):-len(".txt")]: f.read_text().splitlines()
           for f in res.glob("res_*.txt")}
    assert got == want
