"""The port's CRNN and direction-classifier training against the JAX
package's, on the CPU: two train steps of a small CRNN (VGG v1 at scale 0.5,
BiLSTM hidden 48, 1x32x64 lines, the 36-character table and blank) and of
the classifier (MobileNetV3 small 0.35, 3x24x96) against the JAX
`make_train_step`, from the JAX init bridged into the port and the same
seeded numpy batches, with each config's optimizer (amsgrad +
WarmupPolyLR); the BiLSTM's fixed `bias_hh`; the per-batch evaluate and
`cal_metric_during_train` against the JAX evaluate and the JAX loop's
per-step metric.

flax runs with its stable batch variance, as in test_torch_train_step.py
(and for the reason given there). Tolerances, float32: the loss rtol 1e-5
at step 1 and 1e-4 at step 2; every gradient of step 1 within 5e-4
relative L2 of its JAX leaf; the parameters after 2 steps within 2 x (lr_1
+ lr_2) everywhere (Adam moves a gradient within rounding of 0 by about
+-lr), within 0.1 x lr_1 on >= 97% of them, the updates correlated >
0.999; the BN running statistics rtol 2e-2 / atol 2e-3. Metrics equal."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.data import build_dataloader
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.metrics import build_metric
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.modeling.necks.rnn import BiLSTM
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import program
from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step, make_train_step
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import jax_train_state, randomize, tiny_rec_cls_config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
CPU = torch.device("cpu")
SHAPE = {"rec": (4, 32, 64, 1), "cls": (4, 24, 96, 3)}


def _batches(kind, n_batches=2, seed=0):
    """Seeded numpy batches of the shape the config's loader gives:
    (image, label, length) for rec (labels of 1-8 characters of 1..36),
    (image, label) for cls."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        images = rng.uniform(-1, 1, SHAPE[kind]).astype(np.float32)
        n = SHAPE[kind][0]
        if kind == "cls":
            out.append((images, rng.randint(0, 2, n).astype(np.int64)))
            continue
        lengths = rng.randint(1, 9, n).astype(np.int64)
        labels = np.zeros((n, 25), np.int64)
        for i, k in enumerate(lengths):
            labels[i, :k] = rng.randint(1, 37, k)
        out.append((images, labels, lengths))
    return out


def _setup(kind, tmp):
    cfg_path = tiny_rec_cls_config(tmp / ("%s.yml" % kind), kind, "unused", "unused",
                                   tmp / ("%s_out" % kind))
    cfg = load_config(cfg_path)
    cfg["Global"]["distributed"] = False
    if kind == "rec":
        cfg["Architecture"]["Head"]["out_channels"] = 37
    state, jmodel, tx, jsched = jax_train_state(
        cfg_path, SHAPE[kind], char_num=37 if kind == "rec" else None,
        optimizer=cfg["Optimizer"], steps=2)
    return dict(kind=kind, cfg=cfg, cfg_path=cfg_path, state=state, jmodel=jmodel, tx=tx,
                jsched=jsched, batches=_batches(kind), tmp=tmp)


_SETUPS = {}


def _cached_setup(kind, tmp_path_factory):
    import jax

    if kind not in _SETUPS:
        s = _setup(kind, tmp_path_factory.mktemp(kind))
        s["variables"] = {"params": jax.device_get(s["state"].params),
                          "batch_stats": jax.device_get(s["state"].batch_stats)}
        _SETUPS[kind] = s
    return _SETUPS[kind]


@pytest.fixture(scope="module", params=["rec", "cls"])
def setup(request, tmp_path_factory):
    return _cached_setup(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def rec_setup(tmp_path_factory):
    return _cached_setup("rec", tmp_path_factory)


def _port(s, train_bias_hh=False):
    model = build_model(s["cfg"]["Architecture"])
    load_flax_variables(model, s["variables"])
    if train_bias_hh:  # the port without repair 2: nn.LSTM's two biases both trained
        for m in model.modules():
            if isinstance(m, BiLSTM):
                for name, b in m.rnn.named_parameters():
                    if name.startswith("bias_hh"):
                        b.requires_grad_(True)
    opt, _ = build_optimizer(s["cfg"]["Optimizer"], epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    return model, opt, make_train_step(model, build_loss(s["cfg"]["Loss"]), opt)


def _jax_run(s):
    """The JAX side: the step-1 gradient, then two make_train_step steps,
    with flax's stable batch variance (module docstring). Computed once a
    setup."""
    if "jax_run" not in s:
        s["jax_run"] = _jax_steps(s)
    return s["jax_run"]


def _jax_steps(s):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    normalization._compute_stats = lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False})
    try:
        jloss = jax_build_loss(s["cfg"]["Loss"])
        jstate = s["state"]

        def loss_at(params, batch):
            preds, _ = s["jmodel"].apply({"params": params, "batch_stats": jstate.batch_stats},
                                         batch[0], train=True, mutable=["batch_stats"])
            return jloss(preds, batch)["loss"]

        first = tuple(jnp.asarray(x) for x in s["batches"][0])
        grad = jax.device_get(jax.jit(jax.grad(loss_at))(jstate.params, first))
        jstep = jax_make_train_step(s["jmodel"], jloss, s["tx"],
                                    create_mesh(devices=jax.devices()[:1]), donate=False)
        states, losses = [], []
        for batch in s["batches"]:
            jstate, jl = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
            states.append({"params": jax.device_get(jstate.params),
                           "batch_stats": jax.device_get(jstate.batch_stats)})
            losses.append(float(jl["loss"]))
    finally:
        normalization._compute_stats = stats
    return dict(grad=grad, states=states, losses=losses)


def test_two_train_steps_match_jax_make_train_step(setup):
    """Loss, every gradient, every parameter (the LSTM's weights and biases
    included) and the BN statistics after 2 steps; the BiLSTM's bias_hh
    stays 0 and has no optimizer state."""
    s, j = setup, _jax_run(setup)
    model, opt, step = _port(s)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    lrs = []
    for i, batch in enumerate(s["batches"]):
        lrs.append(opt.current_lr())
        assert lrs[-1] == pytest.approx(float(s["jsched"](i)), rel=1e-6)
        tl = step(batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(tl["loss"]), j["losses"][i], rtol=1e-4 if i else 1e-5)
        if i == 0:
            want = flax_to_state_dict(model, {"params": j["grad"],
                                              "batch_stats": s["variables"]["batch_stats"]})
            for k, p in model.named_parameters():
                if p.grad is None:
                    assert "bias_hh" in k, k
                    continue
                if float(want[k].norm()) < 1e-5:  # a bias before a train-mode BN: 0 + rounding
                    assert float(p.grad.norm()) < 1e-5, k
                    continue
                rel = float((p.grad - want[k]).norm() / want[k].norm())
                assert rel < 5e-4, (k, rel)

    after = flax_to_state_dict(model, j["states"][-1])
    named = dict(model.named_parameters())
    dt = torch.cat([(p.detach() - p0[k]).flatten() for k, p in named.items()])
    dj = torch.cat([(after[k] - p0[k]).flatten() for k in named])
    err = (dt - dj).abs()
    assert float(err.max()) <= 2 * (lrs[0] + lrs[1])
    assert float((err <= 0.1 * lrs[0]).float().mean()) >= 0.97
    assert float(torch.corrcoef(torch.stack([dt, dj]))[0, 1]) > 0.999
    sd = model.state_dict()
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=k)
    hh = [p for k, p in named.items() if "bias_hh" in k]
    assert len(hh) == (4 if s["kind"] == "rec" else 0)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    for p in hh:
        assert not p.requires_grad and not p.any() and id(p) not in in_opt
        assert p not in opt.state


def test_bias_hh_trained_doubles_the_jax_bias_step(rec_setup):
    """Without repair 2 (both nn.LSTM biases trained), bias_ih and bias_hh
    get the JAX bias's gradient each, and Adam moves each by about lr: their
    sum, the gate bias, moves twice the JAX step. With the repair it moves
    the JAX step."""
    s, j = rec_setup, _jax_run(rec_setup)
    batch = batch_to_device(s["batches"][0], CPU)
    after = flax_to_state_dict(build_model(s["cfg"]["Architecture"]), j["states"][0])
    ratios = {}
    for broken in (False, True):
        model, opt, step = _port(s, train_bias_hh=broken)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step(batch)
        sd = model.state_dict()
        got, want = [], []
        for k in sd:
            if "bias_ih" in k:
                hh = k.replace("bias_ih", "bias_hh")
                got.append((sd[k] + sd[hh] - before[k] - before[hh]).flatten())
                want.append((after[k] - before[k]).flatten())
        got, want = torch.cat(got), torch.cat(want)
        big = want.abs() > 0.5 * opt.lr_schedule(0)  # Adam's step where |g| is clear of 0
        assert int(big.sum()) > 100
        ratios[broken] = float((got[big] / want[big]).median())
    assert ratios[False] == pytest.approx(1.0, abs=1e-3)
    assert ratios[True] == pytest.approx(2.0, abs=1e-3)


class _Batches:
    """A fixed list of numpy batches with the loader's interface."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _jax_eval_parts(s, cfg):
    """The JAX mesh, jitted eval step (one a setup, so its compiles are
    shared), post process and a fresh metric."""
    import jax

    from pytorchocr_tpu.metrics import build_metric as jax_build_metric
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.postprocess import build_post_process as jax_build_post_process
    from pytorchocr_tpu.trainer import make_eval_step as jax_make_eval_step

    if "jax_eval" not in s:
        mesh = create_mesh(devices=jax.devices()[:1])
        s["jax_eval"] = mesh, jax_make_eval_step(s["jmodel"], mesh)
    return s["jax_eval"] + (jax_build_post_process(cfg["PostProcess"], cfg["Global"]),
                            jax_build_metric(cfg["Metric"]))


def _eval_loader(s, variables):
    """The config's eval loader over drawn lines (rec: half of them
    relabelled with the JAX model's own reading, so that acc is neither 0
    nor 1), the eval batch 4, and the last batch short."""
    import synth

    cfg = copy.deepcopy(s["cfg"])
    data = s["tmp"] / "eval_data"
    if s["kind"] == "cls":
        label = synth.make_cls_dataset(str(data), n=10, seed=4)
    else:
        label = synth.make_rec_dataset(str(data), n=10, charset="0123456789abcdef", seed=4)
    cfg["Eval"]["dataset"]["label_file_list"] = [label]
    loader, _ = build_dataloader(cfg, "Eval", get_logger())
    if s["kind"] == "rec":
        _, jstep, jpost, _ = _jax_eval_parts(s, cfg)
        lines = open(label).read().splitlines()
        read = []
        for b in loader:
            read += [t for t, _ in jpost(jstep(variables["params"], variables["batch_stats"],
                                               b[0]))]
        relabelled = [ln.split("\t")[0] + "\t" + t if i % 2 == 0 and 0 < len(t) <= 25 else ln
                      for i, (ln, t) in enumerate(zip(lines, read))]
        assert len(relabelled) == len(read) == 10
        (data / "self_label.txt").write_text("\n".join(relabelled) + "\n")
        cfg["Eval"]["dataset"]["label_file_list"] = [str(data / "self_label.txt")]
        loader, _ = build_dataloader(cfg, "Eval", get_logger())
    return cfg, loader


def test_per_batch_evaluate_matches_jax_evaluate(setup):
    """program.evaluate's per-batch path (pre-batched rec/cls loaders)
    against the JAX evaluate with the same (randomised) weights: the same
    metrics, acc strictly between 0 and 1 for the CRNN."""
    from program import evaluate as jax_evaluate

    s = setup
    variables = randomize(s["variables"], np.random.RandomState(5))
    cfg, loader = _eval_loader(s, variables)
    model = build_model(cfg["Architecture"])
    load_flax_variables(model, variables)
    got = program.evaluate(make_eval_step(model), loader,
                           build_post_process(cfg["PostProcess"], cfg["Global"]),
                           build_metric(cfg["Metric"]), s["kind"], CPU)
    mesh, jstep, jpost, jmetric = _jax_eval_parts(s, cfg)
    state = s["state"].replace(params=variables["params"], batch_stats=variables["batch_stats"])
    want = jax_evaluate(state, jstep, mesh, loader, jpost, jmetric, s["kind"])
    assert got.keys() == want.keys()
    for k in want:
        if k != "fps":
            assert got[k] == want[k], k
    if s["kind"] == "rec":
        assert 0 < want["acc"] < 1 and 0 < want["norm_edit_dis"] < 1


def test_cal_metric_during_train_matches_the_jax_loop(setup, monkeypatch):
    """program.train with Global.cal_metric_during_train: after each step
    the eval forward on the train batch, the post process with its labels and
    the metric, every step, as the JAX loop does (tools/program.py:605-613),
    which the JAX side runs here on the JAX state after the same step. The LR
    is 0 so that both sides read with the same weights (the BN statistics
    still move) and a prediction near a tie cannot flip; the JAX state after
    such a step is its parameters and the batch statistics of the train-mode
    forward, which the JAX side computes alone. For the CRNN, half of each
    batch is relabelled with what the JAX model reads after that step (which
    the labels do not change at LR 0), so acc moves off 0."""
    import jax
    import jax.numpy as jnp

    s = setup
    variables = randomize(s["variables"], np.random.RandomState(6))
    cfg = copy.deepcopy(s["cfg"])
    cfg["Optimizer"]["base_lr"] = 0.0
    cfg["Global"].update(cal_metric_during_train=True, eval_epoch_step=[5, 1],
                         save_model_dir=str(s["tmp"] / "cal_metric_out"))
    mesh, jeval, jpost, jmetric = _jax_eval_parts(s, cfg)
    new_stats = jax.jit(lambda v, x: s["jmodel"].apply(v, x, train=True,
                                                       mutable=["batch_stats"])[1])

    def jax_loop(batches):
        stats = variables["batch_stats"]
        out = []
        for batch_np in batches:
            x = jnp.asarray(batch_np[0])
            stats = new_stats({"params": variables["params"], "batch_stats": stats},
                              x)["batch_stats"]
            out.append(jeval(variables["params"], stats, x))
        return out

    batches = copy.deepcopy(s["batches"])
    if s["kind"] == "rec":
        table = {c: i for i, c in enumerate(jpost.character)}
        for batch_np, preds in zip(batches, jax_loop(batches)):
            for i, (text, _) in enumerate(jpost(preds)):
                if i % 2 == 0 and 0 < len(text) <= 25:
                    batch_np[1][i] = 0
                    batch_np[1][i, : len(text)] = [table[c] for c in text]
                    batch_np[2][i] = len(text)
    want = []
    for batch_np, preds in zip(batches, jax_loop(batches)):
        jmetric(jpost(preds, batch_np[1]), batch_np)
        want.append(jmetric.get_metric())

    recorded = []

    class Recording(program.TrainingStats):
        def update(self, stats):
            if "acc" in stats:
                recorded.append(dict(stats))
            super().update(stats)

    monkeypatch.setattr(program, "TrainingStats", Recording)
    model = build_model(cfg["Architecture"])
    load_flax_variables(model, variables)
    opt, _ = build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    report = program.train(cfg, CPU, _Batches(batches), None, model, build_loss(cfg["Loss"]),
                           opt, {}, build_post_process(cfg["PostProcess"], cfg["Global"]),
                           build_metric(cfg["Metric"]), get_logger())
    assert report["steps"] == 2 and report["metric_s"] > 0
    assert recorded == want
    if s["kind"] == "rec":
        assert 0 < want[0]["acc"] < 1
