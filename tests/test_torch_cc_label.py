"""The port's connected components, DB front half and DBPostProcess against
the JAX package on the fixtures of tests/test_device_postprocess.py and on
random text-like blobs. Labels, num, counts and bboxes: exact. Scores: the
port sums in f64 (index_add_) and rounds once, so it is held to the exact
mean at 1e-7; the JAX sums run in f32 (a one-hot matmul), whose rounding grows
with the component (~sqrt(n) * 6e-8; up to 1.6e-6 on these maps' 2,400-pixel
components), so port and JAX are held to 4e-6 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.ops import cc_label as jcc
from pytorchocr_tpu.postprocess.db_postprocess import DBPostProcess as JaxDB
from pytorchocr_tpu_torch.ops import cc_label
from pytorchocr_tpu_torch.postprocess.db_postprocess import DBPostProcess
from torch_port_util import cuda_device  # noqa: F401  (fixture)

_jax_cc = jax.jit(jcc.connected_components, static_argnums=1)


def _fixture_maps():
    """Binary maps of tests/test_device_postprocess.py plus random blobs."""
    maps = []
    b = np.zeros((32, 32), bool)
    b[2:8, 2:8] = True
    b[20:28, 20:28] = True
    b[15, 15] = True
    maps.append(b)
    u = np.zeros((24, 24), bool)
    u[4:20, 4:7] = True
    u[4:20, 17:20] = True
    u[17:20, 4:20] = True
    maps.append(u)
    s = np.zeros((31, 31), bool)
    top, left, bottom, right = 0, 0, 30, 30
    while top < bottom:  # inward rectangular spiral
        s[top, left : right + 1] = True
        s[top : bottom + 1, right] = True
        s[bottom, left : right + 1] = True
        s[top + 2 : bottom + 1, left] = True
        top, left, bottom, right = top + 4, left + 4, bottom - 4, right - 4
    maps.append(s)
    rng = np.random.RandomState(7)
    maps.append(rng.rand(40, 52) > 0.6)
    return maps


def text_like_prob(rng, h, w, n_boxes):
    """A prob map of noisy text-line rectangles and L shapes on a low
    background, values away from the 0.3 threshold."""
    prob = rng.rand(h, w).astype(np.float32) * 0.2
    for _ in range(n_boxes):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 20)
        bh, bw = rng.randint(3, 10), rng.randint(8, 40)
        prob[y : y + bh, x : x + bw] = 0.55 + 0.44 * rng.rand(*prob[y : y + bh, x : x + bw].shape)
        if rng.rand() < 0.3:  # an L: a vertical stroke below the line
            prob[y : y + 3 * bh, x : x + 3] = 0.8
    return prob


@pytest.mark.parametrize("idx", range(4))
def test_connected_components_matches_jax(idx):
    binary = _fixture_maps()[idx]
    want, want_num = _jax_cc(jnp.asarray(binary), 1024)
    got, num = cc_label.connected_components(torch.from_numpy(binary), 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(num) == int(want_num)


def test_connected_components_overflow_clamps_like_jax():
    binary = np.zeros((24, 24), bool)
    binary[::2, ::2] = True  # 144 isolated pixels, more than max_labels
    want, want_num = _jax_cc(jnp.asarray(binary), 16)
    got, num = cc_label.connected_components(torch.from_numpy(binary), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(num) == int(want_num) == 15


def _assert_front_half_equal(got, want):
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert int(got["num"]) == int(want["num"])
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(want["count"]))
    np.testing.assert_array_equal(got["bbox"].numpy(), np.asarray(want["bbox"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=4e-6)


@pytest.mark.parametrize("case", ["stats", "random"])
def test_db_front_half_matches_jax(case):
    if case == "stats":  # test_db_front_half_stats
        prob = np.zeros((64, 64), np.float32)
        prob[10:20, 10:40] = 0.9
        prob[40:50, 10:30] = 0.6
        max_labels = 16
    else:
        prob = text_like_prob(np.random.RandomState(1), 96, 160, 30)
        max_labels = 64
    want = jcc.db_front_half(jnp.asarray(prob), 0.3, max_labels=max_labels)
    got = cc_label.db_front_half(torch.from_numpy(prob), 0.3, max_labels=max_labels)
    _assert_front_half_equal(got, want)
    flat = got["labels"].numpy().reshape(-1)
    exact = np.bincount(flat, prob.reshape(-1).astype(np.float64), max_labels)
    exact = exact / np.maximum(np.bincount(flat, minlength=max_labels), 1)
    np.testing.assert_allclose(got["score"].numpy(), exact, rtol=1e-7)


@pytest.mark.parametrize("use_dilation", [False, True])
def test_db_postprocess_matches_jax_device_path(use_dilation):
    rng = np.random.RandomState(2)
    prob = np.stack([text_like_prob(rng, 96, 160, 25) for _ in range(2)])[..., None]
    prob[0, 60:90, 40:120, 0] = 0.9  # test_db_device_path_matches_host's boxes
    prob[0, 10:30, 10:60, 0] = 0.7
    shape_list = [[192, 320, 2.0, 2.0], [96, 160, 1.0, 1.0]]
    kw = dict(thresh=0.3, box_thresh=0.5, unclip_ratio=1.5, max_candidates=100,
              use_dilation=use_dilation)
    want = JaxDB(**kw)._call_device(jnp.asarray(prob), shape_list)
    got = DBPostProcess(**kw)({"maps": torch.from_numpy(prob)}, shape_list)
    assert sum(len(r["points"]) for r in want) > 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=4e-6)


def test_db_postprocess_host_path_takes_numpy():
    """score_mode "box" runs the JAX package's host code on numpy."""
    prob = np.zeros((1, 96, 160, 1), np.float32)
    prob[0, 20:40, 20:100] = 0.9
    shape_list = [[96, 160, 1.0, 1.0]]
    got = DBPostProcess(score_mode="box")({"maps": torch.from_numpy(prob)}, shape_list)
    host = JaxDB(score_mode="box")
    want = host.boxes_from_bitmap(prob[0, :, :, 0], prob[0, :, :, 0] > 0.3, 160, 96)
    np.testing.assert_array_equal(got[0]["points"], want[0])


@pytest.mark.cuda
def test_db_front_half_on_card_matches_cpu(cuda_device):
    prob = text_like_prob(np.random.RandomState(3), 736, 1280, 300)
    want = cc_label.db_front_half(torch.from_numpy(prob), 0.3, max_labels=1000)
    got = cc_label.db_front_half(torch.from_numpy(prob).to(cuda_device), 0.3, max_labels=1000)
    got = {k: v.cpu() for k, v in got.items()}
    for k in ("labels", "count", "bbox"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    np.testing.assert_allclose(got["score"].numpy(), want["score"].numpy(), rtol=1e-6)
