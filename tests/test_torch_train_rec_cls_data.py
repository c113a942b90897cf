"""The port's CRNN and classifier training pieces against the JAX package's,
on the CPU from seeded numpy inputs: the CTC and cls losses, the rec and cls
label encoders, RecAug with and without TIA, the TIA warps, RandAugment,
RecMetric (with the port's edit distance) and ClsMetric.

Tolerances. The data ops, label encoders and metrics run the same numpy,
cv2 and PIL calls with the same `random` / `np.random` draws on both sides,
so their outputs must be equal, and so must the generators' states after
them. The losses in float32: values rtol 1e-6; gradients with respect to
the logits atol 1e-6 on rows whose label fits in T frames (F.ctc_loss
against optax's scan). On a row that cannot fit, optax's value is near 1e5,
where a float32 ulp is 7.8e-3, so each side's gradient carries its own
rounding: there atol 3e-4 between them, and the port within 1e-4 of the
same recursion in float64."""

import random
import string

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchocr_tpu.data import create_operators as jax_create_operators
from pytorchocr_tpu.data.imaug import text_image_aug as jax_tia
from pytorchocr_tpu.losses.cls_loss import ClsLoss as JaxClsLoss
from pytorchocr_tpu.losses.rec_ctc_loss import CTCLoss as JaxCTCLoss
from pytorchocr_tpu.metrics import build_metric as jax_build_metric
from pytorchocr_tpu_torch.data import create_operators
from pytorchocr_tpu_torch.data.imaug import text_image_aug as tia
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.losses.rec_ctc_loss import ctc_infeasible, optax_ctc_forward
from pytorchocr_tpu_torch.metrics import build_metric
from pytorchocr_tpu_torch.metrics.rec_metric import edit_distance

GLOBAL = {"max_text_length": 25, "character_dict_path": None, "use_space_char": False,
          "cn2en": False, "label_list": ["0", "180"]}


def _ctc_case(case, seed):
    """(logits (N, T, C), labels (N, S), lengths, rows that cannot fit)."""
    rng = np.random.RandomState(seed)
    if case == "short":  # N=3, T=6, C=5: lengths 3, "1111" (4 + 3 repeats), 7
        t, c, s = 6, 5, 7
        rows = [[1, 2, 3], [1, 1, 1, 1], [1, 2, 3, 4, 1, 2, 3]]
    else:  # empty, full length, repeats, random, and two that cannot fit
        t, c, s = 12, 7, 8
        rows = [[], list(rng.randint(1, c, s)), [2, 2, 3, 3, 3], list(rng.randint(1, c, 5)),
                [4] * 7, [1, 2, 1, 1, 2, 2, 3, 3]]
        rows[1] = [int(v) for v in rows[1]]
        while len(rows[1]) + sum(a == b for a, b in zip(rows[1], rows[1][1:])) > t:
            rows[1] = [int(v) for v in rng.randint(1, c, s)]
    labels = np.zeros((len(rows), s), np.int64)
    lengths = np.array([len(r) for r in rows], np.int64)
    for i, r in enumerate(rows):
        labels[i, : len(r)] = r
    logits = (2 * rng.randn(len(rows), t, c)).astype(np.float32)
    bad = np.array([len(r) + sum(a == b for a, b in zip(r, r[1:])) > t for r in rows])
    return logits, labels, lengths, bad


@pytest.mark.parametrize("zero_infinity", [False, True])
@pytest.mark.parametrize("case,seed", [("short", 0), ("mixed", 0), ("mixed", 1)])
def test_ctc_loss_and_gradient_match_optax(case, seed, zero_infinity):
    logits, labels, lengths, bad = _ctc_case(case, seed)
    assert bad.any() and not bad.all()
    jloss = JaxCTCLoss(zero_infinity=zero_infinity)
    jval, jgrad = jax.value_and_grad(
        lambda x: jloss(x, (None, jnp.asarray(labels), jnp.asarray(lengths)))["loss"]
    )(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl, tlen = torch.from_numpy(labels), torch.from_numpy(lengths)
    val = build_loss({"name": "CTCLoss", "zero_infinity": zero_infinity})(x, (None, tl, tlen))
    val["loss"].backward()
    np.testing.assert_allclose(float(val["loss"].detach()), float(jval), rtol=1e-6)
    assert torch.equal(ctc_infeasible(tl, tlen, logits.shape[1]), torch.from_numpy(bad))
    jgrad, grad = np.asarray(jgrad), x.grad.numpy()
    np.testing.assert_allclose(grad[~bad], jgrad[~bad], rtol=0, atol=1e-6)
    np.testing.assert_allclose(grad[bad], jgrad[bad], rtol=0, atol=3e-4)
    assert np.isfinite(grad).all()
    # the port's float32 against its recursion in float64 on the rows that cannot fit
    x64 = torch.tensor(logits.astype(np.float64), requires_grad=True)
    per_seq = optax_ctc_forward(x64, tl, tlen)
    (per_seq / tlen.clamp(min=1)).mean().backward()
    np.testing.assert_allclose(grad[bad], x64.grad.numpy()[bad], rtol=0, atol=1e-4)
    # optax's finite values on such rows: 1e5 from each log_epsilon taken
    assert ((per_seq.detach()[bad] > 1e5) & (per_seq.detach()[bad] < 1e6)).all()


def test_optax_ctc_forward_equals_f_ctc_loss_where_labels_fit():
    """The plain recursion is optax's: on rows that fit it gives F.ctc_loss's
    value (float64, rtol 1e-10)."""
    logits, labels, lengths, bad = _ctc_case("mixed", 2)
    x = torch.tensor(logits.astype(np.float64))
    tl, tlen = torch.from_numpy(labels), torch.from_numpy(lengths)
    want = torch.nn.functional.ctc_loss(torch.log_softmax(x, 2).transpose(0, 1), tl,
                                        torch.full((len(tl),), x.shape[1]), tlen,
                                        reduction="none")
    got = optax_ctc_forward(x, tl, tlen)
    np.testing.assert_allclose(got.numpy()[~bad], want.numpy()[~bad], rtol=1e-10)
    assert torch.isinf(want[torch.from_numpy(bad)]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_cls_loss_and_gradient_match_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(16, 2)).astype(np.float32)
    label = rng.randint(0, 2, 16).astype(np.int64)
    jval, jgrad = jax.value_and_grad(
        lambda x: JaxClsLoss()(x, (None, jnp.asarray(label)))["loss"])(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    val = build_loss({"name": "ClsLoss"})(x, (None, torch.from_numpy(label)))["loss"]
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-7)


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("dict_path", [None, "./pytorchocr_tpu/utils/char_dict_6623.txt"])
def test_ctc_and_cls_label_encode_match_jax(dict_path):
    glob = dict(GLOBAL, character_dict_path=dict_path, use_space_char=dict_path is not None)
    texts = ["hello", "Hello World", "abc123", "", "x" * 25, "y" * 26, "ab-c", "A", "--",
             "aa11bb", "文字", "7 7"]
    for ops in ([{"CTCLabelEncode": None}], [{"ClsLabelEncode": None}]):
        got_op = create_operators(ops, glob)[0]
        want_op = jax_create_operators(ops, glob)[0]
        if "CTCLabelEncode" in ops[0]:
            assert got_op.character == want_op.character
            assert got_op.lower == want_op.lower == (dict_path is None)
            labels = texts
        else:
            labels = ["0", "180", "90", "", "0 "]
        for text in labels:
            _same(got_op({"label": text}), want_op({"label": text}))


def _line(rng, h, w, channels):
    """A drawn text line, (h, w) gray or (h, w, 3) RGB uint8."""
    img = np.full((h, w, 3), int(rng.randint(150, 256)), np.uint8)
    text = "".join(rng.choice(list(string.ascii_lowercase + string.digits), rng.randint(3, 9)))
    ink = tuple(int(v) for v in rng.randint(0, 90, 3))
    cv2.putText(img, text, (2, h - 6), cv2.FONT_HERSHEY_SIMPLEX, h / 40.0, ink, 1, cv2.LINE_AA)
    img = np.clip(img + rng.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
    return img if channels == 3 else cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)


def _run_seeded(op, data, seed):
    """op(data) with `random` and `np.random` seeded; returns the output and
    the next draw of each generator (the draws taken must match too)."""
    random.seed(seed)
    np.random.seed(seed)
    out = op({k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in data.items()})
    return out, (random.random(), np.random.rand())


@pytest.mark.parametrize("chain", [
    [{"RecAug": None}],  # CRNN: gray lines, TIA on
    [{"RecAug": {"use_tia": False}}],  # cls: RGB lines, TIA off
    [{"RecAug": {"use_tia": True, "aug_prob": 0.9}}],
    [{"RandAugment": None}],
    [{"RandAugment": {"prob": 1.0, "num_layers": 3, "magnitude": 7}}],
])
def test_rec_aug_and_rand_augment_match_jax(chain):
    """Each chain on lines of both kinds, 12 seeds each: equal images and
    equal generator states after."""
    got_op = create_operators(chain, GLOBAL)[0]
    want_op = jax_create_operators(chain, GLOBAL)[0]
    rng = np.random.RandomState(7)
    channels = [1, 3] if "RecAug" in chain[0] else [3]
    for ch in channels:
        for seed in range(12):
            shape = (int(rng.choice([32, 48])), int(rng.randint(60, 200)))
            data = {"image": _line(rng, *shape, ch)}
            got, got_next = _run_seeded(got_op, data, seed)
            want, want_next = _run_seeded(want_op, data, seed)
            assert got_next == want_next, (ch, seed)
            assert got["image"].dtype == want["image"].dtype
            np.testing.assert_array_equal(got["image"], want["image"], err_msg=str((ch, seed)))


@pytest.mark.parametrize("fn", ["tia_distort", "tia_stretch", "tia_perspective"])
def test_tia_warps_match_jax(fn):
    rng = np.random.RandomState(3)
    for seed in range(6):
        img = _line(rng, int(rng.choice([32, 48])), int(rng.randint(80, 260)), 3)
        args = () if fn == "tia_perspective" else (int(rng.randint(3, 7)),)
        np.random.seed(seed)
        got = getattr(tia, fn)(img.copy(), *args)
        np.random.seed(seed)
        want = getattr(jax_tia, fn)(img.copy(), *args)
        np.testing.assert_array_equal(got, want)


def test_edit_distance_equals_levenshtein():
    import Levenshtein

    rng = random.Random(0)
    alphabet = "abcde 12AB"
    for _ in range(300):
        a = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        b = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        if rng.random() < 0.3:
            b = a[: rng.randint(0, len(a))] + b[:2]
        assert edit_distance(a, b) == Levenshtein.distance(a, b), (a, b)


@pytest.mark.parametrize("is_filter", [False, True])
def test_rec_and_cls_metrics_match_jax(is_filter):
    """Batches of (pred, conf) / (target, conf) pairs with spaces, case,
    punctuation and exact matches: each call's result and get_metric equal."""
    rng = random.Random(int(is_filter))
    alphabet = "abcXY12 -."
    got, want = build_metric({"name": "RecMetric", "is_filter": is_filter}), \
        jax_build_metric({"name": "RecMetric", "is_filter": is_filter})
    gotc, wantc = build_metric({"name": "ClsMetric"}), jax_build_metric({"name": "ClsMetric"})
    for _ in range(5):
        preds, labels = [], []
        for _ in range(rng.randint(1, 9)):
            t = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 10)))
            p = t if rng.random() < 0.4 else "".join(rng.choice(alphabet)
                                                     for _ in range(rng.randint(0, 10)))
            preds.append((p, rng.random()))
            labels.append((t, 1.0))
        assert got((preds, labels)) == want((preds, labels))
        cls_pred = [(rng.choice(["0", "180"]), 0.9) for _ in labels]
        cls_label = [(rng.choice(["0", "180"]), 1.0) for _ in labels]
        assert gotc((cls_pred, cls_label)) == wantc((cls_pred, cls_label))
    assert got.get_metric() == want.get_metric()
    assert gotc.get_metric() == wantc.get_metric()
    assert got.get_metric() == want.get_metric()  # both reset
