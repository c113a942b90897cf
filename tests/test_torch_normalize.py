"""The deploy input normalisation of the port against the JAX JitRunner's.

JitRunner multiplies the raw image by the Python float 1/255 (a float32
multiplier once in JAX), then subtracts the mean and divides by the std
(deploy/common.py:104-108). The port's Runner.normalize computes the same
three float32 operations, so on every uint8 value and ImageNet channel the
two agree bit for bit with the JAX function run eagerly. Dividing by 255
instead, as the port did before, rounds a part of them an ulp apart; the int8
stem quantizes this input, where an ulp can move an element a quantum."""

import numpy as np
import torch
from torch import nn

from pytorchocr_tpu_torch.deploy.common import Runner

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _all_values():
    return np.broadcast_to(np.arange(256, dtype=np.uint8)[None, None, :, None],
                           (1, 1, 256, 3)).copy()


def test_runner_normalize_equals_jitrunner_normalize_bit_for_bit():
    from deploy.common import JitRunner

    images = _all_values()
    jr = JitRunner(None, None, mean=MEAN, std=STD)
    want = np.asarray(jr._normalize(images))  # eager: no jit around it
    got = Runner(nn.Identity(), "cpu", MEAN, STD).normalize(torch.from_numpy(images)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.size == 768
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    mean = np.asarray(MEAN, np.float32).reshape(1, 1, 1, 3)
    std = np.asarray(STD, np.float32).reshape(1, 1, 1, 3)
    divided = (images.astype(np.float32) / np.float32(255.0) - mean) / std
    assert (divided != want).sum() > 0  # the division the port used to compute
