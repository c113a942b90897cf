"""Distillation in the port against the JAX package, on the CPU: the losses
(KLJSLoss, DMLLoss, DistanceLoss, the five distillation losses and
CombinedLoss) on the same numpy inputs, with every option the configs and
the JAX classes take (`maps_name`, `key`, `act`, `use_log`, `dilate`) and
the loss-dict keys; DistillationModel's outputs in eval and train mode from
one JAX init bridged into the port (the CML model of
tests/test_distillation.py: a ResNet-18 teacher and two MobileNetV3-small
x0.5 students, FPN 32, 64x64; and two CRNNs at VGG x0.5, BiLSTM 48); both
distillation post processes; DistillationMetric's best-of-keys selection.

Tolerances: the losses rtol 1e-5 (float32 reductions in another order; the
OHEM bisection of the teach loss agrees to its last bits); the models'
outputs atol 1e-4 (maps, softmax, the BN statistics rtol 1e-4) and 2e-4
(features and logits): XLA:CPU against oneDNN through 20-30 float32
layers, measured at most 1.2e-7 in eval mode and 3.1e-5 in train mode (the
binary map, where k = 50 scales the differences), CRNN features 3.4e-5;
post-processed boxes and texts exactly (scores rtol 4e-6,
test_torch_cc_label.py's); metrics rtol 1e-9.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.losses import basic_loss as jax_basic_loss
from pytorchocr_tpu.losses import build_loss as jax_build_loss
from pytorchocr_tpu.losses import distillation_loss as jax_distillation_loss
from pytorchocr_tpu.metrics import build_metric as jax_build_metric
from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.postprocess import build_post_process as jax_build_post_process
from pytorchocr_tpu_torch.losses import basic_loss, build_loss, distillation_loss
from pytorchocr_tpu_torch.metrics import build_metric
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from test_distillation import LOSS_CFG, _arch
from torch_port_util import nchw, same_native_path, shaped_variables

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


def _t(tree):
    """numpy leaves -> torch tensors (nested dicts and tuples)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return torch.from_numpy(np.asarray(tree)) if tree is not None else None


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_j(v) for v in tree)
    return jnp.asarray(tree) if tree is not None else None


def _assert_losses(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **LOSS_TOL)


def det_preds(rng, n=2, hw=32, names=("Student", "Student2"), teacher=True):
    """Map dicts as the DB heads give them: students' (N, H, W, 3) in train
    mode, the frozen teacher's (N, H, W, 1) (eval mode)."""
    preds = {name: {"maps": rng.rand(n, hw, hw, 3).astype(np.float32)} for name in names}
    if teacher:
        preds["Teacher"] = {"maps": rng.rand(n, hw, hw, 1).astype(np.float32)}
    return preds


def det_batch(rng, n=2, hw=32):
    return (rng.rand(n, hw, hw, 3).astype(np.float32),
            (rng.rand(n, hw, hw) * 0.4 + 0.3).astype(np.float32),
            (rng.rand(n, hw, hw) > 0.5).astype(np.float32),
            (rng.rand(n, hw, hw) > 0.7).astype(np.float32),
            (rng.rand(n, hw, hw) > 0.1).astype(np.float32))


def rec_preds(rng, n=3, t=10, c=37):
    return {name: {"head_out": (3 * rng.randn(n, t, c)).astype(np.float32),
                   "backbone_out": rng.randn(n, 1, t, 8).astype(np.float32)}
            for name in ("Student", "Student2")}


def rec_batch(rng, n=3, t=10):
    lengths = rng.randint(1, 6, n).astype(np.int64)
    labels = np.zeros((n, 25), np.int64)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.randint(1, 37, k)
    lengths[0] = t  # a label that cannot fit in T (optax's rule: tests of rec_ctc_loss)
    labels[0, :t] = rng.randint(1, 37, t)
    return (None, labels, lengths)


@pytest.mark.parametrize("mode", ["kl", "js"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_kljs_loss_matches_jax(mode, reduction):
    rng = np.random.RandomState(0)
    p1, p2 = rng.rand(2, 3, 5, 7).astype(np.float32)
    got = basic_loss.KLJSLoss(mode, reduction)(torch.from_numpy(p1), torch.from_numpy(p2))
    want = jax_basic_loss.KLJSLoss(mode, reduction)(jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("act", [None, "softmax", "sigmoid"])
@pytest.mark.parametrize("use_log", [False, True])
def test_dml_loss_matches_jax(act, use_log):
    rng = np.random.RandomState(1)
    # probabilities where no activation makes them so; logits otherwise
    x1, x2 = (rng.rand(2, 3, 6, 11) if act is None else 3 * rng.randn(2, 3, 6, 11)).astype(
        np.float32)
    got = basic_loss.DMLLoss(act, use_log)(torch.from_numpy(x1), torch.from_numpy(x2))
    want = jax_basic_loss.DMLLoss(act, use_log)(jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("mode", ["l1", "l2", "smooth_l1"])
def test_distance_loss_matches_jax(mode):
    rng = np.random.RandomState(2)
    x, y = (2 * rng.randn(2, 4, 9)).astype(np.float32)  # |x - y| on both sides of 1
    got = basic_loss.DistanceLoss(mode)(torch.from_numpy(x), torch.from_numpy(y))
    want = jax_basic_loss.DistanceLoss(mode)(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("kw", [
    dict(model_name_pairs=[["Student", "Student2"]], maps_name="shrink_maps", key="maps"),
    dict(model_name_pairs=[["Student", "Student2"]], key="maps",
         maps_name=["shrink_maps", "threshold_maps", "binary_maps"]),
    dict(model_name_pairs=["Student", "Student2"], key="maps", maps_name="binary_maps",
         act="sigmoid", name="dml_det"),
], ids=["shrink", "three-maps", "one-pair-sigmoid"])
def test_distillation_dml_loss_det_maps_match_jax(kw):
    rng = np.random.RandomState(3)
    preds, batch = det_preds(rng), det_batch(rng)
    got = distillation_loss.DistillationDMLLoss(**kw)(_t(preds), _t(batch))
    want = jax_distillation_loss.DistillationDMLLoss(**kw)(_j(preds), _j(batch))
    _assert_losses(got, want)


def test_distillation_rec_losses_match_jax():
    """The rec DML config's losses (CTC per student on `head_out`, the
    symmetric KL over their softmax) and the feature distance, one label
    that cannot fit in T included."""
    rng = np.random.RandomState(4)
    preds, batch = rec_preds(rng), rec_batch(rng)
    for cls, kw in (
        ("DistillationCTCLoss", dict(model_name_list=["Student", "Student2"], key="head_out")),
        ("DistillationDMLLoss", dict(model_name_pairs=[["Student", "Student2"]], act="softmax",
                                     use_log=True, key="head_out")),
        ("DistillationDMLLoss", dict(model_name_pairs=[["Student", "Student2"]], key="head_out",
                                     act="softmax")),
        ("DistillationDistanceLoss", dict(mode="l2", model_name_pairs=[["Student", "Student2"]],
                                          key="backbone_out")),
        ("DistillationDistanceLoss", dict(mode="smooth_l1", key="head_out",
                                          model_name_pairs=[["Student", "Student2"],
                                                            ["Student2", "Student"]])),
    ):
        got = getattr(distillation_loss, cls)(**kw)(_t(preds), _t(batch))
        want = getattr(jax_distillation_loss, cls)(**kw)(_j(preds), _j(batch))
        _assert_losses(got, want)


@pytest.mark.parametrize("dilate", [False, True])
def test_distillation_db_losses_match_jax(dilate):
    """DistillationDBLoss per student and DistillationTeachDBLoss (with and
    without `dilate`) on the CML config's pairs. Both run DBLoss's defaults,
    not the config's: DistillationTeachDBLoss's main loss is BCELoss though
    the config says DiceLoss, as in JAX (ROADMAP.md C's records)."""
    rng = np.random.RandomState(5)
    preds, batch = det_preds(rng), det_batch(rng)
    cfg = copy.deepcopy(LOSS_CFG["loss_config_list"])
    teach = dict(cfg[0]["DistillationTeachDBLoss"], dilate=dilate)
    teach.pop("weight")
    db = dict(cfg[2]["DistillationDBLoss"], main_loss_type="DiceLoss", alpha=5, beta=1)
    db.pop("weight")
    for cls, kw in (("DistillationTeachDBLoss", teach), ("DistillationDBLoss", db)):
        port = getattr(distillation_loss, cls)(**kw)
        jax_loss = getattr(jax_distillation_loss, cls)(**kw)
        for obj in (port, jax_loss):
            assert (obj.main_loss_type, obj.alpha, obj.beta, obj.ohem_ratio, obj.balance) == (
                "BCELoss", 1, 10, 3, True)
        _assert_losses(port(_t(preds), _t(batch)), jax_loss(_j(preds), _j(batch)))


def test_dilate_is_the_jax_reduce_window():
    """The 2x2 max window padded at the bottom and the right only, against
    the JAX `reduce_window`, exactly, on odd and even sizes."""
    rng = np.random.RandomState(6)
    for shape in ((2, 9, 13), (1, 16, 16), (3, 1, 5)):
        binary = (rng.rand(*shape) > 0.8).astype(np.float32)
        want = jax.lax.reduce_window(jnp.asarray(binary), -jnp.inf, jax.lax.max,
                                     window_dimensions=(1, 2, 2), window_strides=(1, 1, 1),
                                     padding=((0, 0), (0, 1), (0, 1)))
        got = distillation_loss.dilate_2x2(torch.from_numpy(binary))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["cml", "rec_dml"])
def test_combined_loss_matches_jax(which):
    """CombinedLoss with its per-entry weights (changed from the configs' 1.0
    so that each shows) over the CML and the rec DML configs' lists."""
    rng = np.random.RandomState(7)
    if which == "cml":
        cfg = copy.deepcopy(LOSS_CFG)
        preds, batch = det_preds(rng), det_batch(rng)
    else:
        cfg = {"name": "CombinedLoss", "loss_config_list": [
            {"DistillationCTCLoss": {"weight": 1.0, "model_name_list": ["Student", "Student2"],
                                     "key": "head_out"}},
            {"DistillationDMLLoss": {"weight": 1.0, "act": "softmax", "use_log": True,
                                     "model_name_pairs": [["Student", "Student2"]],
                                     "key": "head_out"}}]}
        preds, batch = rec_preds(rng), rec_batch(rng)
    for i, entry in enumerate(cfg["loss_config_list"]):
        next(iter(entry.values()))["weight"] = 0.5 + i
    got = build_loss(cfg)(_t(preds), _t(batch))
    want = jax_build_loss(cfg)(_j(preds), _j(batch))
    _assert_losses(got, want)
    assert "loss" in got and len(got) > 3


def rec_arch():
    """Two CRNNs of rec_dml_ctc_synth.yml at VGG x0.5, BiLSTM 48, 37
    classes, return_all_feats (the losses and the decode read head_out)."""
    student = {"in_channels": 1, "pretrained": None, "freeze_params": False,
               "return_all_feats": True, "model_type": "rec", "algorithm": "CRNN",
               "Transform": None,
               "Backbone": {"name": "VGG", "model_name": "v1", "scale": 0.5},
               "Neck": {"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 48},
               "Head": {"name": "CTCHead", "out_channels": 37}}
    return {"name": "DistillationModel", "algorithm": "Distillation", "model_type": "rec",
            "Models": {"Student": copy.deepcopy(student), "Student2": copy.deepcopy(student)}}


@pytest.fixture(scope="module")
def cml_pair():
    """The CML model of tests/test_distillation.py from one random JAX init
    (shaped_variables: the init's tree, in which the frozen teacher has no
    threshold tower), bridged strictly into the port."""
    jmodel = jax_build_model(_arch())
    x = np.random.RandomState(8).rand(2, 64, 64, 3).astype(np.float32)
    variables = shaped_variables(jmodel, x, seed=3)
    model = build_model(_arch())
    load_flax_variables(model, variables)
    return jmodel, model, variables, x


def _assert_tree_close(got, want, what, **tol):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], "%s/%s" % (what, k), **tol)
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       err_msg="%s/%s" % (what, k), **tol)


def test_cml_model_matches_jax_in_eval_and_train_mode(cml_pair, monkeypatch):
    """Every model's maps in eval mode (each (N, H, W, 1)) and in train mode
    (the students' three maps; the frozen teacher's shrink map alone, from
    its running statistics), and the BN statistics after the train-mode
    forward: the students' moved as the JAX ones, the teacher's not at all."""
    from flax.linen import normalization

    stats = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",  # as test_torch_train_step.py
                        lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    jmodel, model, variables, x = cml_pair
    load_flax_variables(model, variables)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(nchw(x))
    _assert_tree_close(got, want, "eval", atol=1e-4, rtol=0)
    assert {k: tuple(v["maps"].shape) for k, v in got.items()} == {
        k: (2, 64, 64, 1) for k in ("Teacher", "Student", "Student2")}

    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    teacher_before = {k: v.clone() for k, v in model.models_0.state_dict().items()}
    with torch.no_grad():
        got = model.train()(nchw(x))
    _assert_tree_close(got, want, "train", atol=1e-4, rtol=0)
    assert tuple(got["Teacher"]["maps"].shape) == (2, 64, 64, 1)
    assert tuple(got["Student"]["maps"].shape) == (2, 64, 64, 3)
    assert not model.models_0.training and model.models_1.training
    for k, v in model.models_0.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    bridged = flax_to_state_dict(model, {"params": variables["params"],
                                         "batch_stats": jax.device_get(mutated["batch_stats"])})
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), bridged[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_bridge_maps_a_jax_cml_init_with_the_teacher_built_without_its_threshold_tower(cml_pair):
    """The JAX CML init holds no threshold tower for the frozen teacher
    (it is initialised in eval mode). The port builds a frozen model without
    its head's train-only modules, so the strict bridge maps one onto the
    other whole; a teacher built with the tower is refused by name."""
    _, model, variables, _ = cml_pair
    assert model.models_0.head.thresh is None and model.models_1.head.thresh is not None
    assert not any(k.startswith("models_0.head.thresh") for k in model.state_dict())
    assert "thresh" not in variables["params"]["models_0"]["head"]
    assert all(not p.requires_grad for p in model.models_0.parameters())
    arch = _arch()
    arch["Models"]["Teacher"]["freeze_params"] = False
    with pytest.raises(KeyError, match="models_0.head.thresh"):
        flax_to_state_dict(build_model(arch), variables)


def test_rec_dml_model_matches_jax_in_eval_and_train_mode():
    """backbone_out (the port's NCHW against JAX's NHWC), neck_out and
    head_out of both CRNNs: the softmax in eval mode, the CTC logits in
    train mode."""
    jmodel = jax_build_model(rec_arch())
    x = np.random.RandomState(9).rand(2, 32, 64, 1).astype(np.float32)
    variables = shaped_variables(jmodel, x, seed=4)
    model = build_model(rec_arch())
    load_flax_variables(model, variables)
    for train in (False, True):
        want = jmodel.apply(variables, jnp.asarray(x), train=train,
                            **({"mutable": ["batch_stats"]} if train else {}))
        want = want[0] if train else want
        with torch.no_grad():
            got = model.train(train)(nchw(x))
        for name in ("Student", "Student2"):
            g, w = got[name], want[name]
            np.testing.assert_allclose(g["backbone_out"].permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w["backbone_out"]), rtol=0, atol=2e-4)
            np.testing.assert_allclose(g["neck_out"].numpy(), np.asarray(w["neck_out"]),
                                       rtol=0, atol=2e-4)
            np.testing.assert_allclose(g["head_out"].numpy(), np.asarray(w["head_out"]), rtol=0,
                                       atol=2e-4 if train else 1e-4)
        if not train:
            assert np.allclose(got["Student"]["head_out"].sum(-1).numpy(), 1.0, atol=1e-5)


def _prob_maps(rng, n, h, w, boxes):
    prob = 0.2 * rng.rand(n, h, w, 1).astype(np.float32)
    for i in range(n):
        for _ in range(boxes):
            y, x = rng.randint(0, h - 12), rng.randint(0, w - 30)
            prob[i, y : y + rng.randint(5, 12), x : x + rng.randint(10, 30), 0] = \
                0.6 + 0.39 * rng.rand()
    return prob


def test_distillation_db_post_process_matches_jax():
    """DistillationDBPostProcess per named model (the device path: K1's
    plain version here) against the JAX class on the same maps: every box
    and score of each model."""
    rng = np.random.RandomState(10)
    maps = {"Student": _prob_maps(rng, 2, 96, 160, 8), "Student2": _prob_maps(rng, 2, 96, 160, 5),
            "Teacher": _prob_maps(rng, 2, 96, 160, 3)}
    shape_list = np.array([[192, 320, 2.0, 2.0], [96, 160, 1.0, 1.0]])
    cfg = {"name": "DistillationDBPostProcess", "model_name": ["Student", "Student2"],
           "thresh": 0.3, "box_thresh": 0.5, "max_candidates": 1000, "unclip_ratio": 1.7,
           "score_mode": "poly"}
    got = build_post_process(cfg)({k: {"maps": torch.from_numpy(v)} for k, v in maps.items()},
                                  shape_list)
    want = jax_build_post_process(cfg)({k: {"maps": jnp.asarray(v)} for k, v in maps.items()},
                                       shape_list)
    assert list(got) == list(want) == ["Student", "Student2"]
    for name in want:
        assert sum(len(r["points"]) for r in want[name]) >= 6
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g["points"], w["points"])
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=4e-6)


def test_distillation_ctc_label_decode_matches_jax():
    rng = np.random.RandomState(11)
    logits = 4 * rng.randn(2, 5, 40, 37).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    preds = {name: {"head_out": probs[i]} for i, name in enumerate(("Student", "Student2"))}
    labels = rec_batch(rng, n=5)[1]
    cfg = {"name": "DistillationCTCLabelDecode", "model_name": ["Student", "Student2"],
           "key": "head_out"}
    glob = {"character_dict_path": None, "use_space_char": False}
    got = build_post_process(cfg, glob)(_t(preds), labels)
    want = jax_build_post_process(cfg, glob)(_j(preds), labels)
    assert list(got) == list(want)
    for name in want:
        (gt, gl), (wt, wl) = got[name], want[name]
        assert [t for t, _ in gt] == [t for t, _ in wt] and gl == wl
        np.testing.assert_allclose([c for _, c in gt], [c for _, c in wt], rtol=1e-6)


def _det_samples(rng, n):
    """(post results of two students, the eval batches) for the det metric:
    Student2 finds every ground-truth box, Student only the first half."""
    results = {"Student": [], "Student2": []}
    batches = []
    for i in range(n):
        gts = []
        for _ in range(4):
            x, y = rng.randint(0, 200), rng.randint(0, 100)
            gts.append(np.array([[x, y], [x + 40, y], [x + 40, y + 12], [x, y + 12]], np.float32))
        gts = np.stack(gts)
        batches.append((None, None, gts[None], np.zeros((1, 4), bool)))
        results["Student2"].append([{"points": gts + rng.rand(*gts.shape).astype(np.float32)}])
        results["Student"].append([{"points": gts[: 2 + (i % 2)]}])
    return results, batches


def test_distillation_metric_picks_the_best_student_as_jax():
    """DetMetric per model through DistillationMetric: the main entries
    are the better student's (Student2, listed second), every model's under
    `<name>_<metric>`; and RecMetric alike on the acc indicator."""
    same_native_path()
    rng = np.random.RandomState(12)
    results, batches = _det_samples(rng, 4)
    cfg = {"name": "DistillationMetric", "base_metric_name": "DetMetric",
           "main_indicator": "hmean", "keys": ["Student", "Student2"]}
    got, want = build_metric(cfg), jax_build_metric(cfg)
    for i, b in enumerate(batches):
        for metric in (got, want):
            metric({k: v[i] for k, v in results.items()}, b)
    g, w = got.get_metric(), want.get_metric()
    assert list(g) == list(w) and g["hmean"] == g["Student2_hmean"] == 1.0
    assert g["Student_hmean"] < 1.0
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-9, err_msg=k)

    cfg = dict(cfg, base_metric_name="RecMetric", main_indicator="acc")
    got, want = build_metric(cfg), jax_build_metric(cfg)
    labels = [("abc", 1.0), ("12x", 1.0), ("q", 1.0)]
    preds = {"Student": ([("abd", 0.9), ("12x", 0.8), ("", 0.1)], labels),
             "Student2": ([("abc", 0.9), ("12x", 0.8), ("q", 0.7)], labels)}
    for metric in (got, want):
        metric(preds, None)
    g, w = got.get_metric(), want.get_metric()
    assert list(g) == list(w) and g["acc"] == g["Student2_acc"] > g["Student_acc"]
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-9, err_msg=k)
