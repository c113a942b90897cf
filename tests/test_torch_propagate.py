"""The port's label propagation (K2) against the JAX package: the plain
PyTorch version (what a CPU tensor runs) against the Pallas kernel in
interpret mode (as tests/test_pallas_propagate.py runs it), and the fixpoint
against the JAX fixpoint and the synchronous XLA oracle `spread_labels_jax`.
Integer outputs: exact. The CUDA kernel itself is held against the plain
version on the card (marked `cuda`, skipped here). This file imports no
flax, so its card tests collect on a machine without it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.ops.pallas_propagate import (
    pallas_available,
    propagate_rounds_pallas,
    spread_labels_fixpoint as jax_fixpoint,
)
from pytorchocr_tpu.ops.propagate import spread_labels_jax
from pytorchocr_tpu_torch.ops import propagate
from torch_port_util import cuda_device  # noqa: F401  (fixture)

_pallas = jax.jit(propagate_rounds_pallas, static_argnums=2)
_oracle = jax.jit(spread_labels_jax, static_argnames=("fill_only",))


def _case(rng, h, w, fill_only, p=0.3, seeds=0.02):
    """A random mask; for the fill rule sparse seed labels (some of them on
    unmasked pixels), for the CC rule every masked pixel's own index."""
    mask = rng.rand(h, w) > p
    if fill_only:
        labels = np.where(rng.rand(h, w) < seeds, rng.randint(1, 60, (h, w)), 0)
    else:
        labels = np.where(mask, np.arange(h * w).reshape(h, w) + 1, 0)
    return labels.astype(np.int32), mask


def _port_rounds(labels, mask, fill_only):
    out, changed = propagate.propagate_rounds(
        torch.from_numpy(labels), torch.from_numpy(mask), fill_only
    )
    return out.numpy(), int(changed[0])


@pytest.mark.parametrize("shape", [(64, 64), (40, 200), (1, 300)])
@pytest.mark.parametrize("fill_only", [True, False])
def test_rounds_ref_matches_pallas(shape, fill_only):
    """Labels and the round-16 flag, exactly; the flag both set (mid-way)
    and clear (at the fixpoint)."""
    labels, mask = _case(np.random.RandomState(sum(shape)), *shape, fill_only)
    assert pallas_available(shape)
    for _ in range(2):
        want, want_changed = _pallas(jnp.asarray(labels), jnp.asarray(mask), fill_only)
        got, changed = _port_rounds(labels, mask, fill_only)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert changed == int(bool(want_changed))
        labels = got
    fixed = propagate.spread_labels_fixpoint(torch.from_numpy(labels), torch.from_numpy(mask),
                                             fill_only).numpy()
    want, want_changed = _pallas(jnp.asarray(fixed), jnp.asarray(mask), fill_only)
    got, changed = _port_rounds(fixed, mask, fill_only)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, fixed)
    assert changed == 0 and not bool(want_changed)


@pytest.mark.parametrize("shape", [(64, 64), (57, 131)])
@pytest.mark.parametrize("fill_only", [True, False])
def test_fixpoint_matches_jax_fixpoint_and_oracle(shape, fill_only):
    labels, mask = _case(np.random.RandomState(7), *shape, fill_only, seeds=0.005)
    got = propagate.spread_labels_fixpoint(torch.from_numpy(labels), torch.from_numpy(mask),
                                           fill_only).numpy()
    want = np.asarray(jax_fixpoint(jnp.asarray(labels), jnp.asarray(mask), fill_only=fill_only))
    oracle = np.asarray(_oracle(jnp.asarray(labels), jnp.asarray(mask), fill_only=fill_only))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert (got != labels).sum() > 10  # the spreading had work to do


def test_band_tiled_jax_path_diverges_from_synchronous():
    """Divergence 1 of ROADMAP.md C. A map of 524,288 pixels or more takes
    the JAX package's band-tiled path, which runs 408-row bands one after
    another, so the band below starts from labels 16 rounds ahead and a
    contested pixel near the band edge can change owner. The port stays
    synchronous: it equals the XLA oracle, and the tiled path does not."""
    h, w = 416, 1280
    mask = np.zeros((h, w), bool)
    mask[300:416, 100:140] = True  # a 116x40 column crossing row 408
    labels = np.zeros((h, w), np.int32)
    labels[330, 120] = 1
    labels[415, 120] = 2
    assert not pallas_available((h, w))
    got = propagate.spread_labels_fixpoint(torch.from_numpy(labels), torch.from_numpy(mask)).numpy()
    oracle = np.asarray(_oracle(jnp.asarray(labels), jnp.asarray(mask), fill_only=True))
    tiled = np.asarray(jax_fixpoint(jnp.asarray(labels), jnp.asarray(mask), fill_only=True))
    np.testing.assert_array_equal(got, oracle)
    assert (tiled != oracle).sum() == 28
    assert [(got == k).sum() for k in (1, 2)] == [2920, 1720]
    assert [(tiled == k).sum() for k in (1, 2)] == [2948, 1692]


def test_wrapper_checks_and_counter():
    labels = torch.zeros((4, 5), dtype=torch.int32)
    mask = torch.ones((4, 5), dtype=torch.bool)
    with pytest.raises(TypeError):
        propagate.propagate_rounds(labels.long(), mask, True)
    with pytest.raises(ValueError):
        propagate.propagate_rounds(labels, mask[:, :4], True)
    with pytest.raises(ValueError):
        propagate.propagate_rounds(labels.t(), mask.t(), True)  # not contiguous
    before = propagate.launches
    out, changed = propagate.propagate_rounds(labels, mask.to(torch.uint8), True)
    assert propagate.launches == before  # CPU tensors launch no kernel
    assert out.dtype == changed.dtype == torch.int32 and int(changed) == 0


@pytest.mark.cuda
def test_propagate_kernel_matches_ref_on_card(cuda_device):
    rng = np.random.RandomState(11)
    for h, w in [(736, 1280), (184, 320), (97, 1001), (4096, 256), (1, 5000), (1, 1)]:
        for fill_only in (True, False):
            labels, mask = _case(rng, h, w, fill_only, seeds=0.002)
            tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
            dl, dm = tl.to(cuda_device), tm.to(cuda_device)
            for _ in range(2):  # the flag set mid-way, then perhaps clear
                want, want_changed = propagate.propagate_rounds_ref(tl, tm, fill_only)
                got, changed = propagate.propagate_rounds(dl, dm, fill_only)
                np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
                assert int(changed.item()) == int(want_changed.item())
                tl, dl = want, got
            want = propagate.spread_labels_fixpoint(tl, tm, fill_only)
            got = propagate.spread_labels_fixpoint(dl, dm, fill_only)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
