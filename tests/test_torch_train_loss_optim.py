"""The port's DB loss, optimizer, LR schedules and train-mode BN statistics
against the JAX package's, on seeded numpy inputs, CPU float32.

Tolerances: loss values rtol 1e-5 and gradients rtol 1e-4 / atol 1e-7
(float32 sums over a map in another order: XLA's against ATen's); the
OHEM bisection's threshold, its count above and so its tie handling are
exact, since both sides bisect with the same float32 arithmetic. The
optimizer's parameters rtol 1e-6 / atol 1e-9 over 5 steps, LRs rtol 1e-6,
the BN running statistics rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from pytorchocr_tpu.losses import basic as jbasic
from pytorchocr_tpu.losses.det_db_loss import DBLoss as JaxDBLoss
from pytorchocr_tpu.modeling.heads.det_db_head import DBHead as JaxDBHead
from pytorchocr_tpu.optimizer import build_optimizer as jax_build_optimizer
from pytorchocr_tpu.optimizer import lr_scheduler as jlr
from pytorchocr_tpu_torch.losses import basic
from pytorchocr_tpu_torch.losses.det_db_loss import DBLoss
from pytorchocr_tpu_torch.modeling.common import BatchNorm2d
from pytorchocr_tpu_torch.modeling.heads.det_db_head import DBHead
from pytorchocr_tpu_torch.optimizer import OptaxAdam, build_optimizer
from pytorchocr_tpu_torch.optimizer import lr_scheduler
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_optax_adam_state
from torch_port_util import init_pair, nchw

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-7)


def _maps(seed, n=2, h=24, w=20, ties=False):
    """DB maps (N, H, W, 3) in (0, 1) and the four label maps. With `ties`
    the shrink map takes 4 levels, so the negative losses tie in blocks."""
    rng = np.random.RandomState(seed)
    maps = rng.uniform(0.02, 0.98, (n, h, w, 3)).astype(np.float32)
    if ties:
        maps[..., 0] = rng.choice([0.1, 0.35, 0.6, 0.85], (n, h, w)).astype(np.float32)
    shrink = (rng.rand(n, h, w) < 0.2).astype(np.float32)
    shrink_mask = (rng.rand(n, h, w) < 0.9).astype(np.float32)
    thresh = rng.uniform(0.3, 0.7, (n, h, w)).astype(np.float32)
    thresh_mask = (rng.rand(n, h, w) < 0.5).astype(np.float32)
    return maps, [None, thresh, thresh_mask, shrink, shrink_mask]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_db_loss_and_gradient_match_jax(seed, ties):
    maps, labels = _maps(seed, ties=ties)

    def jloss(m):
        out = JaxDBLoss()({"maps": m}, [None] + [jnp.asarray(x) for x in labels[1:]])
        return out["loss"], out

    (jval, jparts), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(maps))
    t = torch.from_numpy(maps).requires_grad_(True)
    parts = DBLoss()({"maps": t}, [None] + [torch.from_numpy(x) for x in labels[1:]])
    parts["loss"].backward()
    for k in ("loss", "loss_shrink_maps", "loss_threshold_maps", "loss_binary_maps"):
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]), **LOSS, err_msg=k)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **GRAD)


@pytest.mark.parametrize("ties", [False, True])
def test_ohem_bisection_threshold_and_its_gradient_match_jax(ties):
    """_kth_largest_threshold and _topk_sum: the threshold and count are
    equal; the top-k sum's gradient reaches the map's max (and min) through
    the differentiable threshold, as jax.grad through the fori_loop does."""
    rng = np.random.RandomState(3)
    v = rng.rand(500).astype(np.float32)
    if ties:
        v = np.round(v * 6) / 6  # 7 levels
    k = np.float32(37.5)
    jt = jbasic._kth_largest_threshold(jnp.asarray(v), k)
    tt = basic._kth_largest_threshold(torch.from_numpy(v), torch.tensor(k))
    assert float(tt) == float(jt)
    jg = jax.grad(lambda x: jbasic._topk_sum(x, k))(jnp.asarray(v))
    x = torch.from_numpy(v).requires_grad_(True)
    got = basic._topk_sum(x, torch.tensor(k))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(jbasic._topk_sum(jnp.asarray(v), k)),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    assert x.grad[int(np.argmax(v))] != 0 or ties  # the threshold's share of the max


@pytest.mark.parametrize("fn", ["balance", "dice", "mask_l1"])
def test_basic_losses_match_jax(fn):
    maps, labels = _maps(5)
    pred, gt, mask = maps[..., 0], labels[3], labels[4]
    jf = {"balance": lambda p: jbasic.balance_loss(p, gt, mask),
          "dice": lambda p: jbasic.dice_loss(p, gt, mask),
          "mask_l1": lambda p: jbasic.mask_l1_loss(p, gt, mask)}[fn]
    tf = {"balance": basic.balance_loss, "dice": basic.dice_loss,
          "mask_l1": basic.mask_l1_loss}[fn]
    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    val = tf(p, torch.from_numpy(gt), torch.from_numpy(mask))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), **LOSS)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), **GRAD)


def test_bce_clamps_before_the_log():
    """bce clamps probabilities to [1e-6, 1 - 1e-6], finite at 0 and 1;
    F.binary_cross_entropy clamps the log at -100, another value."""
    p = np.array([0.0, 1e-8, 0.5, 1.0], np.float32)
    g = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    got = basic.bce(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbasic.bce(p, g)), rtol=1e-6)
    assert np.isfinite(got).all()
    ref = torch.nn.functional.binary_cross_entropy(torch.from_numpy(p), torch.from_numpy(g),
                                                   reduction="none").numpy()
    assert not np.allclose(ref, got)


SCHEDULES = [
    ("WarmupPolyLR", dict(warmup_iters=3, max_iters=10, power=0.9)),
    ("WarmupPolyLR", dict(warmup_iters=0, max_iters=7, power=0.9)),
    ("WarmupMultiStepLR", dict(milestones=[4, 7], warmup_iters=3)),
    ("WarmupCosineLR", dict(T_max_iters=5, warmup_iters=3)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_lr_schedules_match_jax(name, kw):
    got = getattr(lr_scheduler, name)(1e-3, **kw)
    want = getattr(jlr, name)(1e-3, **kw)
    for step in range(12):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))


def _opt_cfg(amsgrad=True):
    return {"base_lr": 0.01, "optim": {"name": "Adam", "betas": (0.9, 0.999),
                                       "weight_decay": 0, "amsgrad": amsgrad},
            "lr_decay": {"name": "WarmupPolyLR", "warmup_epoch": 3, "power": 0.9}}


def _grads(rng, shapes, step):
    # large early gradients, then small: nu_hat falls, amsgrad's max bites
    scale = 1.0 if step < 2 else 0.05
    return [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("amsgrad", [True, False])
def test_adam_and_warmup_poly_match_optax_across_warmup(amsgrad):
    """5 updates with 3 warmup steps (step_each_epoch 1, warmup_epoch 3):
    the LR of each update is the schedule at the count before it, and the
    parameters follow optax's amsgrad / adam."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 3, 3, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx, jsched = jax_build_optimizer(_opt_cfg(amsgrad), epochs=8, step_each_epoch=1)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, sched = build_optimizer(_opt_cfg(amsgrad), epochs=8, step_each_epoch=1, parameters=tp)
    for step in range(5):
        grads = _grads(rng, shapes, step)
        assert opt.current_lr() == pytest.approx(float(jsched(step)), rel=1e-6)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    assert opt.param_groups[0]["count"] == 5


def test_torch_builtin_amsgrad_diverges_from_optax():
    """torch.optim.Adam(amsgrad=True) keeps the max of the raw second moment
    and bias-corrects it after; optax the max of the corrected one. From the
    second step on the two move parameters differently, so the port has its
    own optimizer (OptaxAdam)."""
    rng = np.random.RandomState(1)
    p0 = rng.randn(64).astype(np.float32)
    ours = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    builtin = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = OptaxAdam([ours], lambda step: np.float32(0.01), amsgrad=True)
    ref = torch.optim.Adam([builtin], lr=0.01, amsgrad=True)
    tx = optax.amsgrad(0.01)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    diff = []
    for step in range(4):
        g = _grads(rng, [(64,)], step)[0]
        ours.grad, builtin.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        opt.step()
        ref.step()
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)
        diff.append(float(np.abs(builtin.detach().numpy() - np.asarray(jp)).max()))
    assert diff[0] < 1e-6 and max(diff[1:]) > 1e-4


def test_optax_state_bridge_resumes_past_warmup():
    """A DBHead pair starts from the same mid-training amsgrad state (8
    steps, warmup 3: past the boundary, with nu_max above nu_hat); one more
    update with the same gradients moves the bridged torch parameters as
    optax moves the flax ones (conv kernels transposed, deconvs flipped)."""
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    jmod, tmod = JaxDBHead(32), DBHead(32)
    variables, _ = init_pair(jmod, tmod, x)
    params = variables["params"]
    tx, jsched = jax_build_optimizer(_opt_cfg(), epochs=20, step_each_epoch=1)
    state = tx.init(params)
    rng = np.random.RandomState(3)

    def grads_like(tree, step):
        return jax.tree.map(lambda a: _grads(rng, [a.shape], step)[0], tree)

    for step in range(8):
        updates, state = tx.update(grads_like(params, step), state, params)
        params = optax.apply_updates(params, updates)
    params = jax.device_get(params)
    ams = state[0]
    assert any(np.any(np.asarray(m) > np.asarray(n) / (1 - 0.999 ** 8))
               for m, n in zip(jax.tree.leaves(ams.nu_max), jax.tree.leaves(ams.nu)))
    stats = variables["batch_stats"]
    tmod.load_state_dict(flax_to_state_dict(tmod, {"params": params, "batch_stats": stats}))
    opt, _ = build_optimizer(_opt_cfg(), epochs=20, step_each_epoch=1,
                             parameters=tmod.parameters())
    load_optax_adam_state(opt, tmod, {"count": ams.count, "mu": jax.device_get(ams.mu),
                                      "nu": jax.device_get(ams.nu),
                                      "nu_max": jax.device_get(ams.nu_max)}, stats)
    g = jax.device_get(grads_like(params, 8))
    tg = flax_to_state_dict(tmod, {"params": g, "batch_stats": stats})
    for name, p in tmod.named_parameters():
        p.grad = tg[name]
    assert opt.current_lr() == pytest.approx(float(jsched(8)), rel=1e-6)
    opt.step()
    updates, state = tx.update(g, state, params)
    want = flax_to_state_dict(tmod, {"params": optax.apply_updates(params, updates),
                                     "batch_stats": stats})
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_train_mode_bn_running_stats_match_flax():
    """BatchNorm2d in train mode: output as flax's, running mean and the
    biased running variance as flax's (momentum 0.9); torch's own
    nn.BatchNorm2d updates the variance with the unbiased estimate, n/(n-1)
    times the biased one, so its running variance drifts apart."""
    rng = np.random.RandomState(4)
    x = (2.0 + 3.0 * rng.randn(2, 3, 3, 5)).astype(np.float32)  # n = 18 per channel
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    stats = {"mean": 0.1 * rng.randn(5).astype(np.float32),
             "var": (0.5 + rng.rand(5)).astype(np.float32)}
    y, mutated = bn.apply({"params": variables["params"], "batch_stats": stats}, x,
                          mutable=["batch_stats"])
    ours, plain = BatchNorm2d(5, momentum=0.1), torch.nn.BatchNorm2d(5, momentum=0.1)
    for m in (ours, plain):
        m.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.running_var.copy_(torch.from_numpy(stats["var"]))
        m.train()
    out = ours(nchw(x))
    plain(nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    want = mutated["batch_stats"]
    np.testing.assert_allclose(ours.running_mean.numpy(), want["mean"], rtol=1e-5)
    np.testing.assert_allclose(ours.running_var.numpy(), want["var"], rtol=1e-5)
    batch_var = x.reshape(-1, 5).var(0)
    np.testing.assert_allclose(plain.running_var.numpy(),
                               0.9 * stats["var"] + 0.1 * batch_var * 18 / 17, rtol=1e-5)
    assert np.abs(plain.running_var.numpy() - np.asarray(want["var"])).max() > 1e-3


def test_flax_fast_batch_variance_loses_digits_the_port_keeps():
    """flax's train-mode BN takes the batch variance as E[x^2] - E[x]^2 in
    float32 (use_fast_variance), which loses digits where |mean| >> std; the
    port normalises with F.batch_norm's stable variance, which agrees with
    flax's stable mode (use_fast_variance=False) and with float64, and blends
    the same variance into its running statistics. This is why the
    train-step test runs flax with its stable variance."""
    rng = np.random.RandomState(6)
    x = (300.0 + 0.05 * rng.randn(2, 8, 8, 4)).astype(np.float32)  # |mean| / std = 6000
    exact = x.astype(np.float64).reshape(-1, 4)
    exact_var = 0.9 + 0.1 * exact.var(0)  # the running variance after one step from 1
    exact = (exact - exact.mean(0)) / np.sqrt(exact.var(0) + 1e-5)
    outs, run_var = {}, {}
    for fast in (True, False):
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                          use_fast_variance=fast)
        v = bn.init(jax.random.PRNGKey(0), x)
        y, mutated = bn.apply(v, x, mutable=["batch_stats"])
        outs[fast] = np.abs(np.asarray(y).reshape(-1, 4) - exact).max()
        run_var[fast] = np.abs(np.asarray(mutated["batch_stats"]["var"]) - exact_var).max()
    bn = BatchNorm2d(4).train()
    ours = bn(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    ours = np.abs(ours.reshape(-1, 4) - exact).max()
    assert ours < 1e-2 and outs[False] < 1e-2 and outs[True] > 10 * max(ours, outs[False])
    ours_var = np.abs(bn.running_var.numpy() - exact_var).max()
    assert ours_var < 1e-6 and run_var[False] < 1e-6
    assert run_var[True] > 10 * max(ours_var, run_var[False])
