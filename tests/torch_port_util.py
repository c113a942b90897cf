"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py).

jax is imported inside the bridge helpers only: the card's machine runs the
`cuda`-marked tests of the files that import this one."""

from functools import partial

import numpy as np
import pytest
import torch

# The suite runs several test processes on one host; torch's default of one
# intra-op thread per core would oversubscribe it and disturb the suite's
# timing-based tests. The port's tests use small shapes.
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def cuda_device():
    """The first card; the test skips where there is none. Decided when the
    test runs, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


DEEP = dict(atol=2e-3, rtol=1e-3)  # deep float32 stacks, XLA:CPU against oneDNN


def randomize(tree, rng):
    """Random biases, BN scales and statistics (kernels stay at init)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k in ("bias", "b", "mean"):
            v = 0.1 * rng.randn(*v.shape)
        elif k == "scale":
            v = 1.0 + 0.1 * rng.randn(*v.shape)
        elif k == "var":
            v = 0.5 + rng.rand(*v.shape)
        out[k] = v.astype(np.float32)
    return out


def init_pair(jmod, tmod, x_nhwc, seed=0, **apply_kw):
    """Init the flax module, randomise, bridge into the torch module; return
    the flax variables and a jitted eval apply. `x_nhwc` is an array or a
    list of arrays (a neck's feature maps)."""
    import jax
    import jax.numpy as jnp

    from pytorchocr_tpu_torch.utils.weights import load_flax_variables

    init = jax.jit(partial(jmod.init, train=True, **apply_kw))
    variables = init(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, x_nhwc))
    variables = randomize(jax.device_get(dict(variables)), np.random.RandomState(seed))
    load_flax_variables(tmod, variables)
    tmod.eval()
    return variables, jax.jit(partial(jmod.apply, train=False, **apply_kw))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def jax_train_state(cfg_path, example_shape, char_num=None):
    """A freshly initialised JAX train state of the config's model."""
    import jax

    from pytorchocr_tpu.modeling import build_model
    from pytorchocr_tpu.optimizer import build_optimizer
    from pytorchocr_tpu.trainer import create_train_state
    from pytorchocr_tpu.utils.config import load_config

    config = load_config(cfg_path)
    if char_num is not None:
        config["Architecture"]["Head"]["out_channels"] = char_num
    model = build_model(config["Architecture"])
    tx, _ = build_optimizer(
        {"base_lr": 1e-3, "optim": {"name": "Adam"}}, epochs=1, step_each_epoch=1
    )
    return create_train_state(
        model, tx, jax.random.PRNGKey(0), (np.zeros(example_shape, np.float32),)
    )
