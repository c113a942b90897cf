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


def jax_train_state(cfg_path, example_shape, char_num=None, optimizer=None, steps=1):
    """A freshly initialised JAX train state of the config's model. With
    `optimizer` (an Optimizer config section) its state is that optimizer's,
    for one epoch of `steps` steps, and (state, model, tx, lr_schedule) are
    returned."""
    import jax

    from pytorchocr_tpu.modeling import build_model
    from pytorchocr_tpu.optimizer import build_optimizer
    from pytorchocr_tpu.trainer import create_train_state
    from pytorchocr_tpu.utils.config import load_config

    config = load_config(cfg_path)
    if char_num is not None:
        config["Architecture"]["Head"]["out_channels"] = char_num
    model = build_model(config["Architecture"])
    tx, schedule = build_optimizer(
        optimizer or {"base_lr": 1e-3, "optim": {"name": "Adam"}}, epochs=1,
        step_each_epoch=steps
    )
    state = create_train_state(
        model, tx, jax.random.PRNGKey(0), (np.zeros(example_shape, np.float32),)
    )
    return state if optimizer is None else (state, model, tx, schedule)


def quant_leaves(tree, prefix=()):
    """{"a.b.c": float} of a JAX `quant` collection: its leaves under the
    names of the port's AbsMax modules."""
    if not hasattr(tree, "items"):
        return {".".join(prefix): float(np.asarray(tree))}
    out = {}
    for k, v in tree.items():
        out.update(quant_leaves(v, prefix + (k,)))
    return out


def assert_absmax_match(model, quant_vars, rtol=1e-5):
    """Every leaf of a JAX `quant` collection against the calibrated AbsMax
    module of `model` of the same name. Returns the number of leaves."""
    mods = dict(model.named_modules())
    want = quant_leaves(quant_vars)
    assert want
    for name, value in want.items():
        assert mods[name].calibrated, name
        np.testing.assert_allclose(float(mods[name].value), value, rtol=rtol, err_msg=name)
    return len(want)


def rect_hmean(got, want, min_iou=0.5):
    """hmean of two runs' boxes (one list per page; a box is an array of
    points, or an OCR row whose first item is one) matched one to one, page
    by page, greedily by bounding-rectangle IoU >= min_iou."""
    def rect(row):
        p = np.asarray(row[0] if isinstance(row, (list, tuple)) else row).reshape(-1, 2)
        return np.r_[p.min(0), p.max(0)].astype(np.float64)

    matched = 0
    for page, ref in zip(got, want):
        free = [rect(r) for r in ref]
        for row in page:
            a, best, best_iou = rect(row), None, min_iou
            for j, b in enumerate(free):
                if b is None:
                    continue
                inter = np.prod(np.clip(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]), 0,
                                        None))
                union = np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter
                if union > 0 and inter / union >= best_iou:
                    best, best_iou = j, inter / union
            if best is not None:
                free[best] = None
                matched += 1
    total = sum(map(len, got)) + sum(map(len, want))
    return 2.0 * matched / total if total else 1.0


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def tiny_db_config(path, train_label, eval_label, save_dir, size=64, fpn=32, batch=2,
                   base="configs/det/det_r18_db_synth.yml"):
    """Write a small-shape copy of a DB training config (ResNet-18 at full
    depth, FPN `fpn`, `size`x`size` crops, batch `batch`, float32, CPU, one
    epoch, eval after it) to `path` and return it."""
    import os

    import yaml

    from pytorchocr_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, base))
    g = cfg["Global"]
    g.update(use_gpu=False, use_amp=False, epoch_num=1, print_batch_step=1,
             save_model_dir=str(save_dir), eval_epoch_step=[0, 1], log_smooth_window=2)
    cfg["Architecture"]["Neck"]["out_channels"] = fpn
    for op in cfg["Train"]["dataset"]["transforms"]:
        name = next(iter(op))
        if name in ("FusedDetAugCrop", "EastRandomCropData"):
            op[name]["size"] = [size, size]
    for op in cfg["Eval"]["dataset"]["transforms"]:
        if "DetResizeForTest" in op:
            op["DetResizeForTest"] = {"limit_side_len": size, "limit_type": "min"}
    cfg["Train"]["dataset"]["label_file_list"] = [str(train_label)]
    cfg["Eval"]["dataset"]["label_file_list"] = [str(eval_label)]
    cfg["Train"]["loader"].update(batch_size_per_card=batch, num_workers=1)
    cfg["Eval"]["loader"].update(num_workers=1)
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f, sort_keys=False)
    return str(path)



def tiny_rec_cls_config(path, kind, train_label, eval_label, save_dir):
    """Write a small-shape copy of the CRNN (`kind` "rec":
    rec_vgg_bilstm_ctc_synth.yml with VGG scale 0.5, hidden 48, 1x32x64
    lines, the 36-character table) or classifier (`kind` "cls":
    cls_mbv3small_synth.yml at 3x24x96) training config to `path`: batch
    4, float32, CPU, one epoch with an eval after it, every
    augmentation and cal_metric_during_train kept; return it."""
    import os

    import yaml

    from pytorchocr_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {"rec": "configs/rec/rec_vgg_bilstm_ctc_synth.yml",
            "cls": "configs/cls/cls_mbv3small_synth.yml"}[kind]
    cfg = load_config(os.path.join(repo, base))
    cfg["Global"].update(use_gpu=False, use_amp=False, epoch_num=1, print_batch_step=1,
                         save_model_dir=str(save_dir), eval_epoch_step=[0, 1],
                         log_smooth_window=2)
    shape = [1, 32, 64] if kind == "rec" else [3, 24, 96]
    if kind == "rec":
        cfg["Architecture"]["Backbone"]["scale"] = 0.5
        cfg["Architecture"]["Neck"]["hidden_size"] = 48
    for mode in ("Train", "Eval"):
        for op in cfg[mode]["dataset"]["transforms"]:
            name = next(iter(op))
            if name in ("RecResizeImg", "ClsResizeImg"):
                op[name]["image_shape"] = shape
        cfg[mode]["loader"].update(batch_size_per_card=4, num_workers=1)
    cfg["Train"]["dataset"]["label_file_list"] = [str(train_label)]
    cfg["Eval"]["dataset"]["label_file_list"] = [str(eval_label)]
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f, sort_keys=False)
    return str(path)
