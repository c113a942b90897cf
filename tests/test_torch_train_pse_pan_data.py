"""PSE/PAN training's losses and train-time data in the port against the
JAX package's, on the CPU.

Losses (`PSELoss`, `PANLoss` and their parts in losses/basic.py) on the
same seeded maps and labels: the bisection thresholds and the OHEM
selection exactly (tie-heavy maps included: the same float32 probes give
the same counts); the loss terms to rtol 1e-5 and their gradients
elementwise within 1e-5 of the largest |g| (sums in another order); the
boolean maps the losses take from thresholds on the predictions equal
(their flipped pixels are counted in every failure message). The
embedding loss with 0, 1, 2, a few and more than 64 instances (ids past 63
share bucket 63), v1 and v2. Finite gradients at logits far past exp's
overflow, float32 and bf16.

Data (ColorJitter, MakePseGt, MakePanGt, RandomCropImgMask, the two synth
configs' train chains and their loaders' first batches) from the same seeds:
equal exactly, both sides running the same PIL, numpy and cv2 calls and
drawing from `random` and `np.random` in the same order."""

import copy
import random

import numpy as np
import pytest
import torch

from pytorchocr_tpu_torch.data import build_dataloader, create_operators, transform
from pytorchocr_tpu_torch.losses import basic, build_loss
from pytorchocr_tpu_torch.losses.det_pse_loss import flipped_pixels
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from test_torch_train_data import _page, _seeded
from torch_port_util import jax_selections

GLOBAL = {"distributed": False}
PSE_CFG = "configs/det/det_r50_pse_synth.yml"
PAN_CFG = "configs/det/det_r18_pan_synth.yml"


def _grad_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, "%s: gradient off by %.3g of its largest |g| %.3g" % (
        what, err / scale, scale)


def _instances(rng, n, h, w, count):
    """(n, h, w) int32 instance maps of `count` small rectangles each, a
    training mask with one ignored strip, and kernels inside the texts."""
    inst = np.zeros((n, h, w), np.int32)
    kern = np.zeros((n, h, w), np.float32)
    for b in range(n):
        for i in range(count):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 8)
            inst[b, y : y + 5, x : x + 7] = i + 1
            kern[b, y + 1 : y + 4, x + 2 : x + 5] = 1
    mask = np.ones((n, h, w), np.float32)
    mask[:, : h // 8, : w // 3] = 0
    return inst, kern * (inst > 0), mask


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_kth_largest_threshold_and_ohem_match_jax(seed):
    """The bisection threshold, unmasked (DB's call, unchanged) and masked
    (PSE/PAN's OHEM) on tie-heavy rows, and ohem_batch with images that
    take the fallback (no positives; no negatives): exactly."""
    import jax
    import jax.numpy as jnp

    from pytorchocr_tpu.losses import basic as jbasic

    rng = np.random.RandomState(seed)
    n, h, w = 4, 24, 20
    score = (np.round(rng.randn(n, h, w) * 2) / 2).astype(np.float32)  # 9-ish levels: ties
    gt = (rng.rand(n, h, w) > 0.7).astype(np.float32)
    gt[1] = 0  # no positives
    gt[2] = 1  # no negatives
    mask = (rng.rand(n, h, w) > 0.1).astype(np.float32)
    ks = [0.0, 5.0, 37.0, None]  # None: every valid value
    rows = np.repeat(score.reshape(n, -1), len(ks), 0)
    valid = np.repeat(gt.reshape(n, -1) <= 0.5, len(ks), 0)
    k = np.array([valid[i].sum() if ks[i % len(ks)] is None else ks[i % len(ks)]
                  for i in range(len(rows))], np.float32)
    masked = jax.jit(jax.vmap(jbasic._kth_largest_threshold))(rows, k, valid)
    plain = jax.jit(jax.vmap(jbasic._kth_largest_threshold))(rows, k)
    got = basic._kth_largest_threshold(torch.tensor(rows), torch.tensor(k), torch.tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(masked))
    for i in range(len(rows)):  # DB's unmasked call, one row at a time
        assert float(basic._kth_largest_threshold(torch.tensor(rows[i]), torch.tensor(k[i]))) \
            == float(plain[i])
    want = np.asarray(jbasic.ohem_batch(jnp.asarray(score), jnp.asarray(gt), jnp.asarray(mask)))
    got = basic.ohem_batch(torch.tensor(score), torch.tensor(gt), torch.tensor(mask)).numpy()
    assert (got != want).sum() == 0, "%d pixels selected differently" % (got != want).sum()
    np.testing.assert_array_equal(got[1], mask[1])
    np.testing.assert_array_equal(got[2], mask[2])


@pytest.mark.parametrize("mode", ["v1", "v2"])
@pytest.mark.parametrize("count", [0, 1, 2, 70])
def test_emb_loss_matches_jax(mode, count):
    """emb_loss and its gradient against the JAX function: 0 instances (the
    loss is 0: num_instance counts the background), 1 (l_dis gated off), 2,
    and 70 (ids 64-70 share bucket 63 with id 63)."""
    import jax
    import jax.numpy as jnp

    from pytorchocr_tpu.losses import basic as jbasic

    rng = np.random.RandomState(count)
    n, h, w = 2, 48, 64 if count < 70 else 160
    inst, kern, mask = _instances(rng, n, h, w, count)
    emb = rng.randn(n, h, w, 4).astype(np.float32)
    args = (jnp.asarray(inst), jnp.asarray(kern), jnp.asarray(mask))
    want, want_g = jax.jit(jax.value_and_grad(
        lambda e: jbasic.emb_loss(e, *args, mode=mode)))(jnp.asarray(emb))
    x = torch.tensor(emb, requires_grad=True)
    got = basic.emb_loss(x, torch.tensor(inst), torch.tensor(kern), torch.tensor(mask),
                         mode=mode)
    got.backward()
    got = float(got.detach())
    np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-7)
    _grad_close(x.grad.numpy(), want_g, "emb_loss %s, %d instances" % (mode, count))
    assert (got == 0.0) == (count == 0)
    if count == 70:
        assert inst.max() > 63


def _det_labels(rng, n, h, w, kernels):
    inst, kern, mask = _instances(rng, n, h, w, 6)
    text = (inst > 0).astype(np.float32)
    if kernels:
        kern = np.stack([kern * (rng.rand(h, w) > 0.2 * k) for k in range(kernels)], 1)
    return inst, text, kern.astype(np.float32), mask


def _labels(name, inst, text, kern, mask, lib):
    fields = (text, kern, inst, mask) if name == "PANLoss" else (text, kern, mask)
    return (None,) + tuple(lib(f) for f in fields)


CASES = [("PSELoss", {"alpha": 0.7, "ohem_ratio": 3, "kernel_sample_mask": "pred"}, 7),
         ("PSELoss", {"kernel_sample_mask": "gt", "reduction": "sum"}, 7),
         ("PANLoss", {"mode": "v2"}, 6), ("PANLoss", {"mode": "v1", "reduction": "none"}, 6)]


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_pse_pan_losses_match_jax(case, tie_heavy):
    """Every loss term and the gradient of the loss with respect to the
    head's maps, against the JAX loss on the same maps and labels; the
    thresholded selections equal (0 flipped pixels)."""
    import jax
    import jax.numpy as jnp

    from pytorchocr_tpu.losses import build_loss as jax_build_loss

    name, kw, ch = CASES[case]
    rng = np.random.RandomState(case + 10 * tie_heavy)
    n, h, w = 2, 12, 16
    maps = rng.randn(n, h, w, ch).astype(np.float32)
    if tie_heavy:
        maps = np.round(maps * 2) / 2
    inst, text, kern, mask = _det_labels(rng, n, 4 * h, 4 * w, ch - 1 if ch == 7 else 0)
    cfg = dict(name=name, **kw)
    jloss = jax_build_loss(dict(cfg))
    jlab = _labels(name, inst, text, kern, mask, jnp.asarray)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda m: (lambda o: (jnp.sum(o["loss"]), o))(jloss({"maps": m}, jlab)),
        has_aux=True))(jnp.asarray(maps))
    want = want[1]
    tloss = build_loss(dict(cfg))
    tlab = _labels(name, inst, text, kern, mask, torch.tensor)
    x = torch.tensor(maps, requires_grad=True)
    got = tloss({"maps": x}, tlab)
    got["loss"].sum().backward()

    flips = flipped_pixels(tloss.selections({"maps": x.detach()}, tlab),
                           jax_selections(name, maps, jlab,
                                          kw.get("kernel_sample_mask", "pred")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg="%s %s; flipped pixels %s" % (name, k, flips))
    assert sum(flips.values()) == 0, flips
    _grad_close(x.grad.numpy(), want_g, "%s %s; flipped pixels %s" % (name, kw, flips))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_extreme_logit_gradients_finite(dtype):
    """As tests/test_pse_pan.py::test_extreme_logit_gradients_finite: logits
    at 150 sigma, far past exp(-x)'s overflow; torch.sigmoid's backward
    stays finite for PSE and PAN (v1 and v2), and so does the embedding
    loss with no instance."""
    rng = np.random.RandomState(0)
    n, h, w = 2, 16, 16
    inst = np.zeros((n, h * 4, w * 4), np.int32)
    inst[:, 10:30, 10:50] = 1
    inst[:, 40:55, 5:60] = 2
    text = torch.tensor((inst > 0).astype(np.float32))
    mask = torch.ones(n, h * 4, w * 4)
    base = rng.randn(n, h, w, 7).astype(np.float32) * 150.0
    cases = [("PSELoss", {}, 7, (None, text, text[:, None].repeat(1, 6, 1, 1), mask)),
             ("PANLoss", {"mode": "v2"}, 6, (None, text, text, torch.tensor(inst), mask)),
             ("PANLoss", {"mode": "v1"}, 6, (None, text, text, torch.zeros_like(
                 torch.tensor(inst)), mask))]
    for name, kw, ch, batch in cases:
        x = torch.tensor(base[..., :ch], dtype=dtype, requires_grad=True)
        build_loss(dict(name=name, **kw))({"maps": x}, batch)["loss"].float().backward()
        assert torch.isfinite(x.grad.float()).all(), (name, kw, dtype)


# ---- data ------------------------------------------------------------------

def _decoded(seed):
    data, label = _page(seed)
    ops = [{"DecodeImage": {"img_mode": "RGB", "channel_first": False}},
           {"DetLabelEncode": {"ignore_txt": ["###", "#####"]}}]
    from pytorchocr_tpu.data import create_operators as jco
    from pytorchocr_tpu.data import transform as jt

    return (transform({"image": data, "label": label}, create_operators(ops, GLOBAL)),
            jt({"image": data, "label": label}, jco(ops, GLOBAL)))


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        items = [(k, got[k], want[k]) for k in want]
    else:
        assert len(got) == len(want)
        items = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))]
    for k, g, w in items:
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=str(k))
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), k


def _run_both(ops, seed, data_pair):
    from pytorchocr_tpu.data import create_operators as jco
    from pytorchocr_tpu.data import transform as jt

    got, want = data_pair
    got = _seeded(lambda: transform(got, create_operators(ops, GLOBAL)), seed)
    after = random.getstate(), np.random.get_state()[1].copy()
    want = _seeded(lambda: jt(want, jco(ops, GLOBAL)), seed)
    assert after[0] == random.getstate(), "random drew differently"
    np.testing.assert_array_equal(after[1], np.random.get_state()[1])
    return got, want


@pytest.mark.parametrize("kw", [{"brightness": 0.12549019607843137, "saturation": 0.5},
                                {"brightness": [0.6, 1.3], "contrast": 0.4, "saturation": 0.3,
                                 "hue": 0.1}])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_matches_jax(kw, seed):
    got, want = _run_both([{"ColorJitter": kw}], seed, _decoded(seed))
    _same(got, want)


@pytest.mark.parametrize("size", [120, 240])  # 120: no upscale; 240: short edge 180 -> 240
@pytest.mark.parametrize("op", ["MakePseGt", "MakePanGt"])
def test_pse_pan_gt_makers_match_jax(op, size):
    """The GT maps, the ignore tags (the "###" box, and any polygon whose
    kernel vanishes) and the upscaled image and polygons, exactly."""
    kw = {"kernel_num": 7, "min_shrink_ratio": 0.4} if op == "MakePseGt" else \
        {"min_shrink_ratio": 0.5}
    for seed in (0, 1):
        got, want = _run_both([{op: dict(kw, size=size)}], seed, _decoded(seed))
        _same(got, want)
        assert got["ignore_tags"].tolist()[3] is True and got["mask"].min() == 0
        assert min(got["image"].shape[:2]) == max(size, 180)
        if op == "MakePanGt":
            assert got["gt_instance"].dtype == np.int32 and got["gt_instance"].max() == 5


@pytest.mark.parametrize("seed", range(6))
def test_random_crop_img_mask_matches_jax(seed):
    """Both branches of the p = 3/8 draw, a CHW stack (gt_kernels), the HWC
    image, 2-d maps, a key left out of crop_keys; then a page without text
    and one already at the crop size."""
    gt = [{"MakePseGt": {"kernel_num": 4, "size": 180}}]
    crop = [{"RandomCropImgMask": {"size": [96, 128], "main_key": "gt_text",
                                   "crop_keys": ["image", "gt_text", "gt_kernels"]}}]
    got, want = _run_both(gt, seed, _decoded(seed))
    mask_before = got["mask"].copy()
    got, want = _run_both(crop, seed, (got, want))
    _same(got, want)
    assert got["image"].shape == (96, 128, 3) and got["gt_kernels"].shape == (3, 96, 128)
    np.testing.assert_array_equal(got["mask"], mask_before)  # not a crop key: untouched
    blank = {"image": np.zeros((150, 200, 3), np.uint8), "gt_text": np.zeros((150, 200))}
    got, want = _run_both(crop, seed, (copy.deepcopy(blank), copy.deepcopy(blank)))
    _same(got, want)
    same = {"image": np.zeros((96, 128, 3), np.uint8), "gt_text": np.ones((96, 128))}
    got, want = _run_both(crop, seed, (copy.deepcopy(same), copy.deepcopy(same)))
    _same(got, want)


def _train_ops(cfg_path, crop=None):
    cfg = load_config(cfg_path)
    ops = cfg["Train"]["dataset"]["transforms"]
    if crop:
        for op in ops:
            name = next(iter(op))
            if name == "RandomCropImgMask":
                op[name]["size"] = [crop, crop]
            elif name in ("MakePseGt", "MakePanGt"):
                op[name]["size"] = crop
    return cfg, ops


@pytest.mark.parametrize("cfg_path", [PSE_CFG, PAN_CFG])
def test_synth_train_chains_match_jax(cfg_path):
    """The config's whole train chain as published (DecodeImage ...
    KeepKeys, 640x640 crops) on drawn pages, from the same seeds."""
    from pytorchocr_tpu.data import create_operators as jco
    from pytorchocr_tpu.data import transform as jt

    _, ops = _train_ops(cfg_path)
    for seed in (0, 1):
        data, label = _page(30 + seed)
        got = _seeded(lambda: transform({"image": data, "label": label},
                                        create_operators(ops, GLOBAL)), seed)
        want = _seeded(lambda: jt({"image": data, "label": label}, jco(ops, GLOBAL)), seed)
        _same(got, want)
        assert got[0].shape == (640, 640, 3) and got[0].dtype == np.float32
        assert got[2].shape == ((6, 640, 640) if cfg_path == PSE_CFG else (640, 640))


@pytest.mark.parametrize("cfg_path", [PSE_CFG, PAN_CFG])
def test_loader_first_batch_matches_jax(cfg_path, tmp_path):
    """build_dataloader + OCRDataLoader over 4 drawn pages, bs 2, 128x128
    crops, one thread: the first batch equals the JAX loader's field for
    field, gt_kernels stacked (N, 6, H, W) for PSE, gt_instance int32 for
    PAN."""
    from pytorchocr_tpu.data import build_dataloader as jax_build_dataloader

    lines = []
    for i in range(4):
        data, label = _page(40 + i)
        p = tmp_path / ("page_%d.png" % i)
        p.write_bytes(data)
        lines.append("%s\t%s" % (p, label))
    (tmp_path / "label.txt").write_text("\n".join(lines) + "\n")
    cfg, _ = _train_ops(cfg_path, crop=128)
    cfg["Global"]["distributed"] = False
    cfg["Train"]["dataset"]["label_file_list"] = [str(tmp_path / "label.txt")]
    cfg["Train"]["loader"].update(batch_size_per_card=2, num_workers=1)
    batches = {}
    for name, build in (("port", build_dataloader), ("jax", jax_build_dataloader)):
        loader, _ = build(copy.deepcopy(cfg), "Train", get_logger())
        loader.set_epoch(0)
        random.seed(3)
        np.random.seed(3)
        batches[name] = list(loader)[0]
    _same(batches["port"], batches["jax"])
    if cfg_path == PSE_CFG:
        assert batches["port"][2].shape == (2, 6, 128, 128)
    else:
        assert batches["port"][3].dtype == np.int32 and batches["port"][3].shape == (2, 128, 128)
