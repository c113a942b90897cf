"""The port's train-time data against the JAX package's, on seeded samples:
the host ops of the DB training chains (DecodeImage, DetLabelEncode,
IaaAugment, EastRandomCropData, FusedDetAugCrop, MakeShrinkMap,
MakeBorderMap on its native and numpy paths, ToTensor, Normalize,
NormalizeImage) and the loader's first batches. Both sides run the same
numpy and cv2 calls, and draw from `random` and `np.random` in the same
order after the same seeds, so every output must be equal exactly, with two
stated exceptions: the native border map against its numpy path (float32
C++ against float64 numpy: atol 2e-5, as tests/test_native.py holds the JAX
pair), and what reads cv2's precise distance transform, which varies from
call to call by an ulp (JAX against JAX as well): the distance field to
rtol 1e-6, and the shrink map on at most 0.1% of its pixels (a pixel at the
shrink distance can flip)."""

import copy
import json
import random

import cv2
import numpy as np
import pytest

from pytorchocr_tpu.data import build_dataloader as jax_build_dataloader
from pytorchocr_tpu.data import create_operators as jax_create_operators
from pytorchocr_tpu.data import transform as jax_transform
from pytorchocr_tpu_torch.data import build_dataloader, create_operators, transform
from pytorchocr_tpu_torch.utils import geometry
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu.utils import geometry as jax_geometry
from torch_port_util import same_native_path

GLOBAL = {"distributed": False}


def _page(seed, h=180, w=240):
    """A page with dark text-line quads, a 6-point polygon and an ignored
    ("###") box, as PNG bytes and its JSON label line."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 240, np.uint8)
    items = []
    for i in range(4):
        x, y = int(rng.randint(5, w - 90)), int(rng.randint(5, h - 30))
        bw, bh = int(rng.randint(40, 85)), int(rng.randint(10, 24))
        pts = [[x, y], [x + bw, y], [x + bw, y + bh], [x, y + bh]]
        cv2.fillPoly(img, [np.array(pts, np.int32)], (20, 20, 20))
        items.append({"transcription": "###" if i == 3 else "w%d" % i, "points": pts})
    cx, cy = w // 2, h // 2
    items.append({"transcription": "hex", "points": [
        [cx - 30, cy], [cx - 15, cy - 12], [cx + 15, cy - 12], [cx + 30, cy],
        [cx + 15, cy + 12], [cx - 15, cy + 12]]})
    img += rng.randint(0, 10, img.shape).astype(np.uint8)
    return cv2.imencode(".png", img)[1].tobytes(), json.dumps(items)


def _encoded(seed):
    data, label = _page(seed)
    ops = [{"DecodeImage": {"img_mode": "RGB", "channel_first": False}},
           {"DetLabelEncode": {"ignore_txt": ["###", "#####"]}}]
    got = transform({"image": data, "label": label}, create_operators(ops, GLOBAL))
    want = jax_transform({"image": data, "label": label}, jax_create_operators(ops, GLOBAL))
    return got, want


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if k == "shrink_map":
            assert g.shape == w.shape and (g != w).mean() <= 1e-3
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and np.array_equal(np.asarray(g), np.asarray(w)), k


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_det_label_encode_match_jax(seed):
    got, want = _encoded(seed)
    _assert_same(got, want)
    assert got["polys"].shape == (5, 6, 2) and got["ignore_tags"].tolist() == [
        False, False, False, True, False]


AUG_CHAINS = {
    "fused": [{"FusedDetAugCrop": {"flip_p": 0.5, "rotate": [-10, 10], "scale": [0.5, 3],
                                   "size": [128, 128], "max_tries": 50, "keep_ratio": True}}],
    "fused_stretch": [{"FusedDetAugCrop": {"size": [96, 128], "keep_ratio": False}}],
    "iaa_east": [
        {"IaaAugment": {"augmenter_args": [
            {"type": "Fliplr", "args": {"p": 0.5}},
            {"type": "Affine", "args": {"rotate": [-10, 10]}},
            {"type": "Resize", "args": {"size": [0.5, 3]}}]}},
        {"EastRandomCropData": {"size": [128, 128], "max_tries": 50, "keep_ratio": True}}],
}
GT_OPS = [{"MakeBorderMap": {"shrink_ratio": 0.45, "thresh_min": 0.3, "thresh_max": 0.7}},
          {"MakeShrinkMap": {"shrink_ratio": 0.45, "min_text_size": 8}}]


@pytest.mark.parametrize("chain", sorted(AUG_CHAINS))
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_augment_crop_and_gt_maps_match_jax(chain, seed):
    """The augment + crop ops from the same seeds give the JAX op's image,
    polygons, tags and texts; the GT makers then give its maps, exactly."""
    same_native_path()
    got, want = _encoded(seed % 2)
    ops = AUG_CHAINS[chain] + GT_OPS
    got = _seeded(lambda: transform(got, create_operators(ops, GLOBAL)), seed)
    want = _seeded(lambda: jax_transform(want, jax_create_operators(ops, GLOBAL)), seed)
    _assert_same(got, want)
    assert got["shrink_map"].max() == 1 and got["threshold_mask"].max() == 1


@pytest.mark.parametrize("native", [True, False])
def test_make_border_map_paths_match_jax(native, monkeypatch):
    """The port's native library and its numpy path each equal the JAX
    package's same path exactly; across paths the map agrees to 2e-5."""
    from pytorchocr_tpu import native as jax_native
    from pytorchocr_tpu_torch import native as port_native

    same_native_path()
    if not native:
        monkeypatch.setattr(port_native, "native_available", lambda: False)
        monkeypatch.setattr(jax_native, "native_available", lambda: False)
    assert port_native.native_available() == native
    got, want = _encoded(1)
    got = transform(got, create_operators(GT_OPS, GLOBAL))
    want = jax_transform(want, jax_create_operators(GT_OPS, GLOBAL))
    _assert_same(got, want)

    other = transform(_encoded(1)[0], create_operators(GT_OPS[:1], GLOBAL)) if native else None
    if native:
        monkeypatch.setattr(port_native, "native_available", lambda: False)
        numpy_path = transform(_encoded(1)[0], create_operators(GT_OPS[:1], GLOBAL))
        np.testing.assert_array_equal(other["threshold_mask"], numpy_path["threshold_mask"])
        np.testing.assert_allclose(other["threshold_map"], numpy_path["threshold_map"],
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("ops", [
    [{"ToTensor": None}, {"Normalize": {"mean": [0.485, 0.456, 0.406],
                                        "std": [0.229, 0.224, 0.225]}}],
    [{"NormalizeImage": {"scale": "1./255.", "mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]}}],
    [{"DecodeImage": {"img_mode": "GRAY"}}, {"ToTensor": None}],
])
def test_normalize_ops_match_jax(ops):
    data, _ = _page(5)
    if "DecodeImage" not in ops[0]:
        ops = [{"DecodeImage": {"img_mode": "BGR"}}] + ops
    got = transform({"image": data}, create_operators(ops, GLOBAL))
    want = jax_transform({"image": data}, jax_create_operators(ops, GLOBAL))
    _assert_same(got, want)


def test_shrink_geometry_matches_jax():
    rng = np.random.RandomState(4)
    for _ in range(6):
        c = rng.uniform(30, 70, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
        poly = (c + np.stack([25 * np.cos(ang), 12 * np.sin(ang)], 1)).astype(np.float32)
        d = geometry.shrink_distance(poly, 0.4)
        assert d == jax_geometry.shrink_distance(poly, 0.4)
        a, b = np.zeros((100, 100), np.float32), np.zeros((100, 100), np.float32)
        assert geometry.rasterize_shrunk_polygon(a, poly, d) == \
            jax_geometry.rasterize_shrunk_polygon(b, poly, d)
        assert (a != b).mean() <= 1e-3
        (x0, y0, dist), (jx0, jy0, jdist) = (
            geometry.polygon_distance_field(poly, (100, 100)),
            jax_geometry.polygon_distance_field(poly, (100, 100)))
        assert (x0, y0) == (jx0, jy0)
        np.testing.assert_allclose(dist, jdist, rtol=1e-6)
        np.testing.assert_array_equal(geometry.shrunk_polygon_points(poly, d),
                                      jax_geometry.shrunk_polygon_points(poly, d))


def _loader_config(tmp_path, n=6):
    paths = []
    for i in range(n):
        data, label = _page(20 + i)
        p = tmp_path / ("page_%d.png" % i)
        p.write_bytes(data)
        paths.append("%s\t%s" % (p, label))
    label_file = tmp_path / "label.txt"
    label_file.write_text("\n".join(paths) + "\n")
    from pytorchocr_tpu_torch.utils.config import load_config

    cfg = load_config("configs/det/det_r18_db_synth.yml")
    cfg["Global"]["distributed"] = False
    cfg["Train"]["dataset"]["label_file_list"] = [str(label_file)]
    cfg["Train"]["dataset"]["transforms"][2]["FusedDetAugCrop"]["size"] = [96, 96]
    cfg["Train"]["loader"].update(batch_size_per_card=2, num_workers=1)
    return cfg


def test_loader_first_two_batches_match_jax(tmp_path):
    """build_dataloader + OCRDataLoader on a 6-image set, one thread worker:
    the epoch order (RandomState(seed + epoch)), the augmentations drawn
    from the globally seeded generators and the collation give the JAX
    loader's first two batches, field for field."""
    same_native_path()
    cfg = _loader_config(tmp_path)
    logger = get_logger()
    batches = {}
    for name, build in (("port", build_dataloader), ("jax", jax_build_dataloader)):
        loader, _ = build(copy.deepcopy(cfg), "Train", logger)
        loader.set_epoch(1)
        random.seed(7)
        np.random.seed(7)
        # the whole epoch: a prefetching worker left running would draw from
        # the global generators while the other loader runs
        batches[name] = list(loader)[:2]
    assert len(batches["port"][0]) == 5
    for got, want in zip(batches["port"], batches["jax"]):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert batches["port"][0][0].shape == (2, 96, 96, 3)


def test_native_library_builds_once_under_concurrent_first_use(tmp_path, monkeypatch):
    """The loader's worker threads reach MakeBorderMap's first call
    together: one build, and every thread gets the library."""
    import threading

    from pytorchocr_tpu_torch import native

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(native.native_available()))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == [True] * 6 and len(list(tmp_path.glob("libocrgeom_*.so"))) == 1


RACE = """
import importlib.util, json, sys, time
sys.path.insert(0, sys.argv[3])
from torch_port_util import same_native_path
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
first = bool(mod._load())
print(json.dumps({"first": first, "after": bool(same_native_path(mod))}))
"""


def test_same_native_path_steadies_the_jax_library_first_build_race(tmp_path):
    """Six processes make the first use of a copy of the JAX package's
    native library (pytorchocr_tpu/native/, built in place with no lock) at
    once: some may load the file another is still linking and get False;
    through tests/torch_port_util.py:same_native_path every one of them ends
    with the library loaded."""
    import os
    import shutil
    import subprocess
    import sys
    import time

    import pytorchocr_tpu.native as jax_native

    if not shutil.which("g++"):
        pytest.skip("no g++: both packages take their numpy paths")
    src = os.path.dirname(jax_native.__file__)
    copy_dir = tmp_path / "native"
    copy_dir.mkdir()
    for name in ("__init__.py", "geometry_kernels.cpp"):
        shutil.copy(os.path.join(src, name), copy_dir / name)
    tests = os.path.dirname(os.path.abspath(__file__))
    start = time.time() + 8.0  # after every process has imported torch
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(copy_dir / "__init__.py"),
                               repr(start), tests], stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    out = [json.loads(p.communicate(timeout=180)[0].strip().splitlines()[-1]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert [o["after"] for o in out] == [True] * 6, out
    assert (copy_dir / "libocrgeom.so").exists()
