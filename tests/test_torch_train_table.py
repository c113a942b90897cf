"""The port's SLANet training against the JAX package's, on the CPU: two
train steps of a small SLANet (table_sla_synth.yml at PPLCNet x0.5, CSPPAN
24, SLAHead hidden 32, max_text_length 12, aux_count, label smoothing,
amsgrad + WarmupPolyLR, 64x64 tables, bs 2) against the JAX
`make_train_step`, from the same random weights and seeded numpy batches,
at scheduled-sampling p = 0 (teacher forcing) and p = 1 (every step feeds
the model's own prediction: the coins are all 1 on both sides); the
per-batch evaluate and `cal_metric_during_train` against the JAX evaluate
and the JAX loop's per-step metric (the table post process takes the whole
batch). The train -> eval CLI round is in test_torch_table.py.

Each step starts from the same state on both sides: step 2 from the JAX
state after step 1, carried across by the bridge. flax runs with its
stable batch variance, as in test_torch_train_step.py. This small net (BN
over the 8 values a channel of a 2x2 map in its last stage, hardswish's
kinks through 13 blocks) is ill-conditioned after a first Adam step: from
the JAX state after step 1 (p = 0) JAX's float32 gradient lies 2.7%
(relative L2 over all parameters) from a float64 step, up to 9.3% in a
leaf, against 8e-4 at step 1. So each step's gradient is held to the
port's float64 step from the same state: JAX's within 5e-3 of it at step 1
and 5e-2 at step 2, which ties the reference to JAX (a fault of the port's
arithmetic moves its float64 step too; the losses, the parameters after
each step and the moments hold the port to JAX directly as well), the
port's within 2e-3 of it or no further than twice JAX's (measured: 3.3e-4
at step 1, 3.4% at p = 0's step 2).

Tolerances, float32, after each step: the loss and its terms rtol 1e-4 (the
count loss reads the neck's 2x2 map: 2.1e-5 measured at step 1); the
parameters within 2 lr everywhere (Adam moves a gradient within rounding of
0 by about +-lr; plus 1e-6 |p|, the float32 rounding of p +- lr), within
0.1 lr on >= 97% of them, the updates correlated > 0.998 (STAR-Net's limit
in test_torch_train_zoo.py); the amsgrad moments mu, nu and nu_max within
5e-2 relative L2 over all parameters (the gradients' spread above; 2.4%
measured); the BN running statistics rtol 2e-2 / atol 2e-3. Metrics
equal."""

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
from pytorchocr_tpu_torch.optimizer import build_optimizer
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools import program
from pytorchocr_tpu_torch.trainer import batch_to_device, make_eval_step, make_train_step
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import randomize, shaped_variables, tiny_table_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
CPU = torch.device("cpu")
MAX_LEN, SIZE, BS, N_CLS = 12, 64, 2, 50
TD = 48  # "<td></td>" in the merged table: sos, the dictionary without "<td>", it, eos


def _batches(n_batches=2, seed=0):
    """Seeded batches as the train loader gives them: uint8 images (the
    config normalizes on the device), structures of sos, 3-11 tokens (half of
    them "<td></td>"), eos and sos padding, boxes and masks, row / column counts, shapes."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        images = rng.randint(0, 256, (BS, SIZE, SIZE, 3)).astype(np.uint8)
        structure = np.zeros((BS, MAX_LEN + 2), np.int64)
        masks = np.zeros((BS, MAX_LEN + 2, 1), np.float32)
        for i in range(BS):
            k = rng.randint(3, MAX_LEN)
            structure[i, 1:k + 1] = np.where(rng.rand(k) < 0.5, TD, rng.randint(1, N_CLS - 1, k))
            structure[i, k + 1] = N_CLS - 1
            masks[i, 1:k + 1, 0] = rng.rand(k) > 0.5
        bboxes = (rng.rand(BS, MAX_LEN + 2, 8) * masks).astype(np.float32)
        counts = [rng.randint(1, 6, BS).astype(np.int32) for _ in range(2)]
        shape = np.tile(np.array([SIZE, SIZE, 1.0, 1.0, SIZE, SIZE]), (BS, 1))
        out.append((images, structure, bboxes, masks, *counts, shape))
    return out


def _jax_state(cfg, batch, like=None):
    """A JAX TrainState of the config's model with shaped_variables (random
    kernels; no jitted init of the 13-step decode), or `like`'s variables,
    and the config's optimizer over one epoch of 2 steps."""
    import jax.numpy as jnp

    from pytorchocr_tpu.modeling import build_model as jax_build_model
    from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
    from pytorchocr_tpu.trainer import TrainState

    jmodel = jax_build_model(cfg["Architecture"])
    tx, schedule = jax_build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=2)
    if like is None:
        x = batch[0].astype(np.float32) / 255.0
        variables = shaped_variables(jmodel, x, 0, data=tuple(jnp.asarray(b) for b in batch))
    else:
        variables = {"params": like.params, "batch_stats": like.batch_stats}
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    return state, jmodel, tx, schedule


_SETUPS = {}


def _setups(tmp_path_factory):
    """Both setups (p = 0 and p = 1), built once; their JAX steps are traced
    and compiled in two threads at once (XLA compiles without the GIL)."""
    import threading

    import jax

    if not _SETUPS:
        import synth

        state = None
        for p in (0.0, 1.0):
            tmp = tmp_path_factory.mktemp("table_p%d" % p)
            label = synth.make_pubtab_dataset(str(tmp / "data"), n=4, size=SIZE)
            cfg_path = tiny_table_config(tmp / "t.yml", label, tmp / "out", p, MAX_LEN, SIZE)
            cfg = program.preprocess(argv=["-c", cfg_path])[0]
            cfg["Architecture"]["Head"]["out_channels"] = N_CLS
            batches = _batches()
            # p = 1 starts from p = 0's state: the trees are the same
            state, jmodel, tx, jsched = _jax_state(cfg, batches[0], state)
            variables = {"params": jax.device_get(state.params),
                         "batch_stats": jax.device_get(state.batch_stats)}
            _SETUPS[p] = dict(p=p, cfg=cfg, cfg_path=cfg_path, state=state, jmodel=jmodel,
                              tx=tx, jsched=jsched, variables=variables, batches=batches,
                              tmp=tmp, label=label)
        errors = []

        def run(s):
            try:
                s["jax_steps"] = _jax_steps(s)
            except Exception as e:  # re-raised below, in the test's thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(s,)) for s in _SETUPS.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    return _SETUPS


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["p0", "p1"])
def setup(request, tmp_path_factory):
    return _setups(tmp_path_factory)[request.param]


@pytest.fixture(scope="module")
def setup_p0(tmp_path_factory):
    return _setups(tmp_path_factory)[0.0]


def _jax_steps(s):
    """Two JAX make_train_step steps (flax's stable batch variance); the
    losses and states after each."""
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from pytorchocr_tpu.losses import build_loss as jax_build_loss
    from pytorchocr_tpu.parallel.mesh import create_mesh, replicated_sharding
    from pytorchocr_tpu.trainer import build_input_transform
    from pytorchocr_tpu.trainer import make_train_step as jax_make_train_step

    stats = normalization._compute_stats
    normalization._compute_stats = lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False})
    try:
        spec = s["cfg"]["Global"]["_device_normalize_spec"]["Train"]
        mesh = create_mesh(devices=jax.devices()[:1])
        jstep = jax_make_train_step(s["jmodel"], jax_build_loss(s["cfg"]["Loss"]), s["tx"],
                                    mesh, donate=False,
                                    input_transform=build_input_transform(spec))
        # placed as the step's output is, so that step 2 reuses step 1's compile
        jstate = jax.device_put(s["state"], replicated_sharding(mesh))
        states, losses = [], []
        for batch in s["batches"]:
            jstate, jl = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
            states.append(jstate)
            losses.append({k: float(v) for k, v in jl.items()})
    finally:
        normalization._compute_stats = stats
    return states, losses


def _port(s):
    from pytorchocr_tpu_torch.trainer import build_input_transform

    model = build_model(s["cfg"]["Architecture"])
    load_flax_variables(model, s["variables"])
    opt, _ = build_optimizer(s["cfg"]["Optimizer"], epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    spec = s["cfg"]["Global"]["_device_normalize_spec"]["Train"]
    return model, opt, make_train_step(model, build_loss(s["cfg"]["Loss"]), opt,
                                       input_transform=build_input_transform(spec))


def test_two_train_steps_match_jax_make_train_step(setup):
    """Two steps, each from the same state on both sides: step 1 from the
    bridged init, step 2 from the JAX state after step 1 (parameters, BN
    statistics and the amsgrad moments carried across by the bridge). After
    each, at p = 0 and p = 1: every loss term, the gradients (_held_grads),
    the parameters, the moments and the BN statistics."""
    import jax

    from pytorchocr_tpu_torch.utils.weights import load_optax_adam_state

    s = setup
    states, jlosses = s["jax_steps"]
    model, opt, step = _port(s)
    for i, batch in enumerate(s["batches"]):
        start = s["variables"]
        if i:
            prev = states[i - 1]
            start = {"params": jax.device_get(prev.params),
                     "batch_stats": jax.device_get(prev.batch_stats)}
            load_flax_variables(model, start)
            ams = prev.opt_state[0]
            load_optax_adam_state(opt, model, {k: jax.device_get(getattr(ams, k)) for k in
                                               ("count", "mu", "nu", "nu_max")},
                                  start["batch_stats"])
        lr = opt.current_lr()
        assert lr == pytest.approx(float(s["jsched"](i)), rel=1e-6)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        tl = step(batch_to_device(batch, CPU))
        assert set(tl) == set(jlosses[i]) and "count_loss" in tl
        for k, v in jlosses[i].items():
            np.testing.assert_allclose(float(tl[k]), v, rtol=1e-4, err_msg="step %d %s" % (i, k))
        _held_grads(s, model, states, i, start, batch)
        _assert_state_matches(model, opt, states[i], p0, lr)


def _held_grads(s, model, states, i, start, batch):
    """Step i's gradient over all parameters against the port's float64 step
    from the same state (module docstring): the JAX float32 gradient (from
    its first moment: mu_i - 0.9 mu_(i-1) = 0.1 g_i) within 5e-3 relative L2
    of it at step 1 and 5e-2 at step 2, and the port's within 2e-3 of it or
    no further than twice JAX's."""
    import jax

    from pytorchocr_tpu_torch.trainer import build_input_transform, float_preds

    stats = start["batch_stats"]
    mu = jax.device_get(states[i].opt_state[0].mu)
    g = flax_to_state_dict(model, {"params": mu, "batch_stats": stats})
    if i:
        prev = flax_to_state_dict(model, {"params": jax.device_get(
            states[i - 1].opt_state[0].mu), "batch_stats": stats})
        g = {k: v - 0.9 * prev[k] for k, v in g.items()}
    ref = build_model(s["cfg"]["Architecture"])
    load_flax_variables(ref, start)
    ref.double().train()
    b = tuple(t.double() if t.is_floating_point() else t for t in batch_to_device(batch, CPU))
    norm = build_input_transform(s["cfg"]["Global"]["_device_normalize_spec"]["Train"])
    preds = ref(norm(b[0]).double().permute(0, 3, 1, 2), data=b,
                generator=torch.Generator().manual_seed(i))  # p = 1: every coin is 1
    build_loss(s["cfg"]["Loss"])(float_preds(preds, torch.float64), b)["loss"].backward()
    ref_grads = dict(ref.named_parameters())
    names = [k for k, _ in model.named_parameters()]
    g64 = torch.cat([ref_grads[k].grad.flatten() for k in names])
    g_jax = torch.cat([10.0 * g[k].double().flatten() for k in names])
    g_port = torch.cat([p.grad.double().flatten() for _, p in model.named_parameters()])
    jax_err = float((g_jax - g64).norm() / g64.norm())
    port_err = float((g_port - g64).norm() / g64.norm())
    assert jax_err <= (5e-2 if i else 5e-3), jax_err
    assert port_err <= max(2 * jax_err, 2e-3), (port_err, jax_err)


def _assert_state_matches(model, opt, jstate, p0, lr):
    import jax

    stats = jax.device_get(jstate.batch_stats)
    after = flax_to_state_dict(model, {"params": jax.device_get(jstate.params),
                                       "batch_stats": stats})
    named = dict(model.named_parameters())
    dt = torch.cat([(p.detach() - p0[k]).flatten() for k, p in named.items()])
    dj = torch.cat([(after[k] - p0[k]).flatten() for k in named])
    err = (dt - dj).abs()
    p_abs = torch.cat([p0[k].abs().flatten() for k in named])
    assert bool((err <= 2 * lr + 1e-6 * p_abs).all())  # +-lr, and p +- lr's float32 rounding
    assert float((err <= 0.1 * lr).float().mean()) >= 0.97
    assert float(torch.corrcoef(torch.stack([dt, dj]))[0, 1]) > 0.998
    ams = jstate.opt_state[0]
    assert opt.param_groups[0]["count"] == int(ams.count)
    for key in ("mu", "nu", "nu_max"):
        want = flax_to_state_dict(model, {"params": jax.device_get(getattr(ams, key)),
                                          "batch_stats": stats})
        got = torch.cat([opt.state[p][key].flatten() for p in named.values()])
        ref = torch.cat([want[k].flatten() for k in named])
        assert float((got - ref).norm() / ref.norm()) < 5e-2, key
    sd = model.state_dict()
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=k)


def _jax_eval_parts(s, cfg):
    import jax

    from pytorchocr_tpu.metrics import build_metric as jax_build_metric
    from pytorchocr_tpu.parallel.mesh import create_mesh
    from pytorchocr_tpu.postprocess import build_post_process as jax_build_post_process
    from pytorchocr_tpu.trainer import build_input_transform
    from pytorchocr_tpu.trainer import make_eval_step as jax_make_eval_step

    if "jax_eval" not in s:
        mesh = create_mesh(devices=jax.devices()[:1])
        spec = s["cfg"]["Global"]["_device_normalize_spec"]["Eval"]
        s["jax_eval"] = mesh, jax_make_eval_step(s["jmodel"], mesh,
                                                 input_transform=build_input_transform(spec))
    return s["jax_eval"] + (jax_build_post_process(cfg["PostProcess"], cfg["Global"]),
                            jax_build_metric(cfg["Metric"]))


def _decided(s, seed, images):
    """A port model and JAX variables with the same randomised weights, the
    decode made long and decided by utils.seeded.decisive_sla_head_ on
    `images` (NHWC uint8), "<td></td>" raised to a quarter of its steps so
    that token_acc leaves 0; structure_fc2 carried back into the JAX
    variables."""
    from pytorchocr_tpu_torch.trainer import build_input_transform
    from pytorchocr_tpu_torch.utils.seeded import decisive_sla_head_

    cfg = s["cfg"]
    variables = randomize(s["variables"], np.random.RandomState(seed))
    model = build_model(cfg["Architecture"])
    load_flax_variables(model, variables)
    norm = build_input_transform(cfg["Global"]["_device_normalize_spec"]["Eval"])
    decisive_sla_head_(model, norm(torch.from_numpy(images)).permute(0, 3, 1, 2), N_CLS - 1,
                       boxes=[TD], min_tokens=4)
    fc2 = model.head.decode.structure_fc2
    variables["params"]["head"]["decode"]["structure_fc2"] = {
        "kernel": fc2.weight.detach().numpy().T.copy(), "bias": fc2.bias.detach().numpy().copy()}
    return model, variables, norm


def test_per_batch_evaluate_matches_jax_evaluate(setup_p0):
    """program.evaluate on a table loader (the per-batch path, the post
    process and the metric given the whole batch) against the JAX evaluate
    with the same weights (_decided): the same acc and token_acc, token_acc
    above 0."""
    from program import evaluate as jax_evaluate

    s = setup_p0
    cfg = s["cfg"]
    loader, _ = build_dataloader(cfg, "Eval", get_logger())
    model, variables, norm = _decided(s, 5, np.concatenate([b[0] for b in loader]))
    got = program.evaluate(make_eval_step(model, input_transform=norm), loader,
                           build_post_process(cfg["PostProcess"], cfg["Global"]),
                           build_metric(cfg["Metric"]), "table", CPU)
    mesh, jstep, jpost, jmetric = _jax_eval_parts(s, cfg)
    state = s["state"].replace(params=variables["params"], batch_stats=variables["batch_stats"])
    want = jax_evaluate(state, jstep, mesh, loader, jpost, jmetric, "table")
    assert got.keys() == want.keys()
    for k in want:
        if k != "fps":
            assert got[k] == want[k], k
    assert want["token_acc"] > 0


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _flax_stats(model, like):
    """The port's BN running statistics as a flax batch_stats tree shaped as
    `like`."""
    sd = model.state_dict()

    def walk(tree, path):
        if "mean" in tree and not isinstance(tree["mean"], dict):
            name = ".".join(path)
            return {"mean": sd[name + ".running_mean"].numpy().copy(),
                    "var": sd[name + ".running_var"].numpy().copy()}
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(like, ())


def test_cal_metric_during_train_matches_the_jax_loop(setup_p0, monkeypatch):
    """program.train with Global.cal_metric_during_train on a table model
    at LR 0 (_decided weights): after each step the eval forward on the
    train batch, the table post process with the whole batch and the metric
    (tools/program.py:605-613), against the JAX eval, post process and
    metric on the same batch with the same parameters and the BN statistics
    the port's step left (the two-step test holds those to the JAX step's)."""
    s = setup_p0
    cfg = copy.deepcopy(s["cfg"])
    cfg["Optimizer"]["base_lr"] = 0.0
    cfg["Global"].update(cal_metric_during_train=True, eval_epoch_step=[5, 1],
                         save_model_dir=str(s["tmp"] / "cal_metric_out"))
    batches = copy.deepcopy(s["batches"])
    model, variables, _ = _decided(s, 6, batches[0][0])
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    stats = []

    def post_and_keep(preds, batch):
        stats.append(_flax_stats(model, variables["batch_stats"]))
        return post(preds, batch)

    recorded = []

    class Recording(program.TrainingStats):
        def update(self, stats):
            if "acc" in stats:
                recorded.append(dict(stats))
            super().update(stats)

    monkeypatch.setattr(program, "TrainingStats", Recording)
    opt, _ = build_optimizer(cfg["Optimizer"], epochs=1, step_each_epoch=2,
                             parameters=model.parameters())
    report = program.train(cfg, CPU, _Batches(batches), None, model, build_loss(cfg["Loss"]),
                           opt, {}, post_and_keep, build_metric(cfg["Metric"]), get_logger())
    assert report["steps"] == 2 and report["metric_s"] > 0
    mesh, jeval, jpost, jmetric = _jax_eval_parts(s, cfg)
    want = []
    for batch_np, st in zip(batches, stats):
        jmetric(jpost(jeval(variables["params"], st, batch_np[0]), list(batch_np)), batch_np)
        want.append(jmetric.get_metric())
    assert recorded == want
    assert want[0]["token_acc"] > 0
