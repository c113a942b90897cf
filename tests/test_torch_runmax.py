"""The port's segmented run-max (K1) against the JAX package: the plain
PyTorch version (what a CPU tensor runs) against the Pallas kernel in
interpret mode and the XLA associative-scan oracle. Integer outputs: exact.
The CUDA kernel itself is held against the plain version on the card
(marked `cuda`, skipped here)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.ops.cc_label import _segmented_runmax, spread_labels_scan
from pytorchocr_tpu.ops.pallas_propagate import segmented_runmax_pallas
from pytorchocr_tpu_torch.ops import cc_label, runmax
from torch_port_util import cuda_device  # noqa: F401  (fixture)


def _case(rng, h, w, p=0.5):
    mask = rng.rand(h, w) > p
    vals = np.where(mask, rng.randint(1, 1 << 20, (h, w)), 0).astype(np.int32)
    return vals, mask


# jitted: one compile per shape instead of op-by-op dispatch (the Pallas
# kernel still runs in interpret mode on the CPU)
_oracle = jax.jit(_segmented_runmax, static_argnums=2)
_pallas = jax.jit(segmented_runmax_pallas, static_argnums=2)
_jax_spread = jax.jit(spread_labels_scan)


def _port(vals, mask, axis):
    return runmax.segmented_runmax(
        torch.from_numpy(vals), torch.from_numpy(mask), axis
    ).numpy()


@pytest.mark.parametrize("shape", [(16, 128), (24, 256), (40, 384), (37, 301)])
@pytest.mark.parametrize("axis", [0, 1])
def test_runmax_ref_matches_pallas_and_oracle(shape, axis):
    vals, mask = _case(np.random.RandomState(3), *shape)
    got = _port(vals, mask, axis)
    pallas = np.asarray(_pallas(jnp.asarray(vals), jnp.asarray(mask), axis))
    oracle = np.asarray(_oracle(jnp.asarray(vals), jnp.asarray(mask), axis))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


def test_runmax_ref_tall_map_matches_oracle():
    vals, mask = _case(np.random.RandomState(3), 2304, 256, p=0.4)
    for axis in (0, 1):
        want = np.asarray(_oracle(jnp.asarray(vals), jnp.asarray(mask), axis))
        np.testing.assert_array_equal(_port(vals, mask, axis), want)


def test_runmax_changed_flag_and_counter():
    vals, mask = _case(np.random.RandomState(5), 20, 33)
    t_vals, t_mask = torch.from_numpy(vals), torch.from_numpy(mask)
    before = runmax.launches
    out, changed = runmax.segmented_runmax(t_vals, t_mask, 0, prev=t_vals)
    assert int(changed) == int((out != t_vals).any())
    _, same = runmax.segmented_runmax(out, t_mask, 0, prev=out)
    assert int(same) == 0
    assert runmax.launches == before  # CPU tensors launch no kernel


def test_runmax_wrapper_checks():
    vals = torch.zeros((4, 5), dtype=torch.int32)
    mask = torch.ones((4, 5), dtype=torch.bool)
    with pytest.raises(TypeError):
        runmax.segmented_runmax(vals.float(), mask, 0)
    with pytest.raises(ValueError):
        runmax.segmented_runmax(vals, mask[:, :4], 0)
    with pytest.raises(ValueError):
        runmax.segmented_runmax(vals.t(), mask.t(), 0)  # not contiguous
    with pytest.raises(ValueError):
        runmax.segmented_runmax(vals, mask, 2)
    with pytest.raises(ValueError):  # the changed flag is the axis-0 pass's only
        runmax.segmented_runmax(vals, mask, 1, prev=vals)


def test_spread_labels_scan_matches_jax():
    rng = np.random.RandomState(7)
    for h, w, p in [(40, 52, 0.6), (33, 70, 0.45), (64, 64, 0.5)]:
        binary = rng.rand(h, w) > p
        seed = np.where(binary, np.arange(h * w).reshape(h, w) + 1, 0).astype(np.int32)
        want = np.asarray(_jax_spread(jnp.asarray(seed), jnp.asarray(binary)))
        before = cc_label.alternations
        got = cc_label.spread_labels_scan(torch.from_numpy(seed), torch.from_numpy(binary))
        assert cc_label.alternations > before
        np.testing.assert_array_equal(got.numpy(), want)


def _card_case(name):
    """(vals, mask) of the card cases: the kernels' edge paths."""
    rng = np.random.RandomState(11)
    shapes = {"736x1280": (736, 1280), "37x301 W not a multiple of 4": (37, 301),
              "736x736 eval page, 24 a lane": (736, 736), "8x513 narrowest 24 a lane": (8, 513),
              "8x768 widest 24 a lane": (8, 768),
              "97x1001": (97, 1001), "8x2048 widest held row": (8, 2048),
              "8x2049 chunked row loop": (8, 2049), "64x20000 chunked row loop": (64, 20000),
              "2048x64 one row block": (2048, 64), "2049x3 two row blocks": (2049, 3),
              "4096x256 row blocks": (4096, 256), "1x5000": (1, 5000), "5000x1": (5000, 1),
              "1x1": (1, 1)}
    if name in shapes:
        return _case(rng, *shapes[name])
    mask = np.full((736, 1280), name == "all masked")
    return np.where(mask, rng.randint(1, 1 << 20, mask.shape), 0).astype(np.int32), mask


CARD_CASES = ["736x1280", "37x301 W not a multiple of 4", "736x736 eval page, 24 a lane",
              "8x513 narrowest 24 a lane", "8x768 widest 24 a lane", "97x1001",
              "8x2048 widest held row",
              "8x2049 chunked row loop", "64x20000 chunked row loop", "2048x64 one row block",
              "2049x3 two row blocks", "4096x256 row blocks", "1x5000", "5000x1", "1x1",
              "all masked", "empty"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("offset", [False, True])
def test_runmax_kernel_matches_ref_on_card(cuda_device, case, offset):
    """Both axes and the axis-0 flag, exactly. With `offset` the map is a
    contiguous view one row into a larger buffer, so rows start unaligned
    where W is odd (the held-row kernel's scalar path)."""
    vals, mask = _card_case(case)
    tv, tm = torch.from_numpy(vals), torch.from_numpy(mask)
    dv, dm = tv.to(cuda_device), tm.to(cuda_device)
    if offset:
        dv = torch.cat([dv[:1], dv])[1:]
        dm = torch.cat([dm[:1], dm])[1:]
    for axis in (0, 1):
        want = runmax.segmented_runmax_ref(tv, tm, axis)
        got = runmax.segmented_runmax(dv, dm, axis)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    want = runmax.segmented_runmax_ref(tv, tm, 0)
    got, changed = runmax.segmented_runmax(dv, dm, 0, prev=dv)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert int(changed.item()) == int((want != tv).any())
    _, same = runmax.segmented_runmax(got, dm, 0, prev=got)
    assert int(same.item()) == 0


@pytest.mark.cuda
def test_spread_labels_scan_on_card(cuda_device):
    """The fixpoint of alternations on the card against its CPU run."""
    rng = np.random.RandomState(13)
    for h, w, p in [(736, 1280, 0.45), (97, 1001, 0.4), (2500, 40, 0.4)]:
        binary = rng.rand(h, w) > p
        seed = np.where(binary, np.arange(h * w).reshape(h, w) + 1, 0).astype(np.int32)
        want = cc_label.spread_labels_scan(torch.from_numpy(seed), torch.from_numpy(binary))
        got = cc_label.spread_labels_scan(torch.from_numpy(seed).to(cuda_device),
                                          torch.from_numpy(binary).to(cuda_device))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
