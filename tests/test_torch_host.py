"""The port's own copies of the JAX package's host code against their JAX
originals, on the same seeded numpy inputs: config loading, the eval data
ops, geometry, reading order and crops, the DB host path, the CTC character
table, and the host PSE/PAN expansions. Both sides run the same numpy and
cv2 calls in the same order in one process, so every output, float or
integer, must be equal exactly. A subprocess imports every module of the
port and checks that nothing of JAX, flax or the JAX package was loaded."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import pytorchocr_tpu_torch
from pytorchocr_tpu.data import create_operators as jax_create_operators
from pytorchocr_tpu.data import transform as jax_transform
from pytorchocr_tpu.ops import propagate as jax_propagate
from pytorchocr_tpu.postprocess.db_postprocess import DBPostProcess as JaxDB
from pytorchocr_tpu.postprocess.rec_postprocess import CTCLabelDecode as JaxCTC
from pytorchocr_tpu.utils import assets as jax_assets
from pytorchocr_tpu.utils import geometry as jax_geometry
from pytorchocr_tpu.utils import utility as jax_utility
from pytorchocr_tpu.utils.config import load_config as jax_load_config
from pytorchocr_tpu_torch.data import create_operators, transform
from pytorchocr_tpu_torch.postprocess import host_expand
from pytorchocr_tpu_torch.postprocess.db_postprocess import DBPostProcess
from pytorchocr_tpu_torch.postprocess.rec_postprocess import CTCLabelDecode
from pytorchocr_tpu_torch.utils import assets, geometry, utility
from pytorchocr_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["configs/det/det_r18_db.yml", "configs/det/det_r50_pse.yml",
           "configs/det/det_r18_pan.yml", "configs/rec/rec_vgg_bilstm_ctc.yml"]


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("cfg", CONFIGS)
def test_load_config_matches_jax(cfg):
    path = os.path.join(REPO, cfg)
    got, want = load_config(path), jax_load_config(path)
    assert _plain(got) == _plain(want)
    assert got.Global == want.Global  # attribute access, as the JAX AttrDict


DET_OPS = [
    [{"DetResizeForTest": {"limit_side_len": 736, "limit_type": "min"}}],
    [{"DetResizeForTest": {"limit_side_len": 320, "limit_type": "max"}}],
    [{"DetResizeForTest": {"image_shape": [96, 160]}}],
    [{"DetResizeForTest": {"resize_long": 300}}],
    [{"DetResizeForTest": None}],
]


@pytest.mark.parametrize("ops", DET_OPS)
@pytest.mark.parametrize("shape", [(120, 200, 3), (333, 150, 3)])
def test_det_transforms_match_jax(ops, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    ops = ops + [{"KeepKeys": {"keep_keys": ["image", "shape"]}}]
    glob = {"distributed": False}
    got = transform({"image": img.copy()}, create_operators(ops, glob))
    want = jax_transform({"image": img.copy()}, jax_create_operators(ops, glob))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("padding", [True, False])
@pytest.mark.parametrize("shape", [(48, 60), (32, 900), (20, 300, 3)])
def test_rec_transforms_match_jax(padding, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    channels = 3 if len(shape) == 3 else 1
    ops = [{"RecResizeImg": {"image_shape": [channels, 32, 320], "padding": padding}},
           {"KeepKeys": {"keep_keys": ["image"]}}]
    got = transform({"image": img.copy()}, create_operators(ops))[0]
    want = jax_transform({"image": img.copy()}, jax_create_operators(ops))[0]
    assert got.shape == want.shape == (32, 320, channels)
    np.testing.assert_array_equal(got, want)


def test_unported_data_op_names_its_roadmap_item():
    for name, item in (("CopyPaste", "A.15"), ("RecResizeImgForTest", "A.6"),
                       ("ResizeTableImage", "A.13")):
        with pytest.raises(NotImplementedError, match=item):
            create_operators([{name: None}])
    with pytest.raises(NotImplementedError, match="unknown"):
        create_operators([{"NoSuchOp": None}])


def _polygons(seed, n=12):
    """Random convex-ish quads and jagged polygons (float32)."""
    rng = np.random.RandomState(seed)
    polys = []
    for _ in range(n):
        k = rng.randint(4, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(5, 40, k)
        c = rng.uniform(50, 150, 2)
        polys.append((c + np.stack([rad * np.cos(ang), 0.5 * rad * np.sin(ang)], 1))
                     .astype(np.float32))
    return polys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_matches_jax(seed):
    for poly in _polygons(seed):
        box, sside = geometry.min_area_rect_points(poly)
        jbox, jsside = jax_geometry.min_area_rect_points(poly)
        np.testing.assert_array_equal(box, jbox)
        assert sside == jsside
        d = geometry.unclip_distance(box, 1.5)
        assert d == jax_geometry.unclip_distance(jbox, 1.5)
        np.testing.assert_array_equal(geometry.unclip_points(box, d),
                                      jax_geometry.unclip_points(jbox, d))
        got, want = geometry.unclip_polygon(poly, d), jax_geometry.unclip_polygon(poly, d)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(geometry.order_points_clockwise(box),
                                      jax_geometry.order_points_clockwise(jbox))


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_boxes_and_part_img_match_jax(seed):
    rng = np.random.RandomState(seed)
    boxes = []
    for _ in range(15):  # quads on a few lines, some within the 10 px line tolerance
        x, y = rng.randint(0, 300), rng.choice([20, 26, 60, 64, 120]) + rng.randint(0, 5)
        w, h = rng.randint(20, 80), rng.randint(8, 20)
        boxes.append(np.array([[x, y], [x + w, y + 1], [x + w, y + h], [x, y + h - 1]],
                              np.int16))
    got, want = utility.sort_boxes(np.array(boxes)), jax_utility.sort_boxes(np.array(boxes))
    np.testing.assert_array_equal(np.array(got), np.array(want))
    img = rng.randint(0, 256, (200, 400, 3)).astype(np.uint8)
    for box in boxes:
        np.testing.assert_array_equal(utility.get_part_img(img, box),
                                      jax_utility.get_part_img(img, box))
    coords = rng.uniform(0, 200, (4, 2))
    np.testing.assert_array_equal(
        utility.transform_preds(coords, np.array([150.0, 100.0]), 300.0, 256),
        jax_utility.transform_preds(coords, np.array([150.0, 100.0]), 300.0, 256))


def _prob_map(seed, h=96, w=160, blobs=8):
    rng = np.random.RandomState(seed)
    prob = 0.2 * rng.rand(h, w)
    for _ in range(blobs):
        y, x = rng.randint(0, h - 12), rng.randint(0, w - 40)
        prob[y:y + rng.randint(5, 12), x:x + rng.randint(12, 40)] = 0.6 + 0.39 * rng.rand()
    return prob.astype(np.float32)


@pytest.mark.parametrize("kwargs,padding", [
    ({"out_polygon": True}, False),
    ({"score_mode": "box"}, False),
    ({"score_mode": "box", "use_dilation": True}, False),
    ({}, True),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_db_host_path_matches_jax(kwargs, padding, seed):
    """The host path (contours) of the DB postprocess: boxes exact, scores
    equal (cv2.mean on the same map in both). out_polygon gets one blob a
    map: polygons with different vertex counts make both classes raise in
    np.array(boxes, int16) (ROADMAP.md C)."""
    blobs = 1 if kwargs.get("out_polygon") else 8
    maps = np.stack([_prob_map(seed, blobs=blobs), _prob_map(seed + 10, blobs=blobs)])[..., None]
    shapes = np.array([[192, 320, 0.5, 0.5], [180, 330, 96 / 180, 160 / 330]])
    args = dict(thresh=0.3, box_thresh=0.5, unclip_ratio=1.5, **kwargs)
    got = DBPostProcess(**args)({"maps": maps}, shapes, use_padding_resize=padding)
    want = JaxDB(**args)({"maps": maps}, shapes, use_padding_resize=padding)
    assert sum(len(g["points"]) for g in got) > 0
    for g, w in zip(got, want):
        assert len(g["points"]) == len(w["points"])
        for gb, wb in zip(g["points"], w["points"]):
            np.testing.assert_array_equal(gb, wb)
        assert g["scores"] == w["scores"]


def test_ctc_table_and_decode_match_jax():
    path = "./pytorchocr_tpu/utils/char_dict_6623.txt"
    for kwargs in ({}, {"character_dict_path": path},
                   {"character_dict_path": path, "use_space_char": True}):
        got, want = CTCLabelDecode(**kwargs), JaxCTC(**kwargs)
        assert got.character == want.character
    labels = np.random.RandomState(3).randint(0, 40, (6, 25))
    labels[:, 20:] = 0
    assert got.decode(labels) == want.decode(labels)
    prob = np.random.RandomState(4).rand(6, 25)
    assert (got.decode(labels, prob, is_remove_duplicate=True)
            == want.decode(labels, prob, is_remove_duplicate=True))
    missing = "/no/such/dir/char_dict_6623.txt"
    assert assets.resolve_dict_path(missing) == jax_assets.resolve_dict_path(missing)


def _kernels(seed, h=64, w=96, k=4):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    field = np.full((h, w), -1.0)
    for _ in range(6):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry, rx = rng.uniform(3, h / 4), rng.uniform(4, w / 3)
        field = np.maximum(field, 1 - np.maximum(np.abs(yy - cy) / ry, np.abs(xx - cx) / rx))
    field += 0.08 * rng.rand(h, w)
    return np.stack([field > t for t in np.linspace(0.0, 0.6, k)]).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_expansions_match_jax(seed):
    kernels = _kernels(seed)
    np.testing.assert_array_equal(host_expand.pse_np(kernels, 5),
                                  jax_propagate.pse_np(kernels, 5))
    emb = np.random.RandomState(seed).randn(4, *kernels.shape[1:]).astype(np.float32)
    pa = kernels[[0, -1]]
    np.testing.assert_array_equal(host_expand.pa_np(pa, emb, 3),
                                  jax_propagate.pa_np(pa, emb, 3))
    labels, mask = np.zeros(kernels.shape[1:], np.int32), kernels[0] > 0
    labels[np.nonzero(kernels[-1])] = 7
    got, want = labels.copy(), labels.copy()
    host_expand._propagate_np(got, mask)
    jax_propagate._propagate_np(want, mask)
    np.testing.assert_array_equal(got, want)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, loads no
    module of jax, flax or pytorchocr_tpu (pytorchocr_tpu_torch is the
    port itself)."""
    names = [m.name for m in pkgutil.walk_packages(pytorchocr_tpu_torch.__path__,
                                                   "pytorchocr_tpu_torch.")]
    assert "pytorchocr_tpu_torch.data.imaug" in names
    script = (
        "import importlib, sys\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'pytorchocr_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", script, *names], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
