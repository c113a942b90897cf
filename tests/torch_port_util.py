"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py).

jax is imported inside the bridge helpers only: the card's machine runs the
`cuda`-marked tests of the files that import this one."""

import shutil
import time
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


def same_native_path(jax_native=None, timeout=60.0, poll=0.5):
    """Call before comparing the port with a JAX path that may run the JAX
    package's native library (MakeBorderMap, the det metric's IoU matrix).

    That library (pytorchocr_tpu/native/__init__.py) is built in place on
    first use, with no lock: a process that starts while another links it
    loads a partial file, and caches "unavailable" for its life, so its JAX
    ops take their float64 numpy paths while the port's take the native
    float32 ones, and exact comparisons differ by ~2e-5. Where g++ exists and
    the load failed, this forgets that result and retries every `poll`
    seconds, up to `timeout`, while the other build ends. Then it asserts
    that both packages are on the same path. Returns the loaded library or
    False. `jax_native` defaults to pytorchocr_tpu.native."""
    from pytorchocr_tpu_torch import native as port_native

    if jax_native is None:
        from pytorchocr_tpu import native as jax_native
    lib = jax_native._load()
    if not lib and shutil.which("g++"):
        deadline = time.monotonic() + timeout
        while not lib and time.monotonic() < deadline:
            time.sleep(poll)
            jax_native._lib = None
            lib = jax_native._load()
    assert bool(lib) == port_native.native_available(), (
        "the JAX package's native library is %s and the port's is %s: the JAX library's "
        "in-place first build raced with another process's (same_native_path's docstring), "
        "so the two would compare a native path with a numpy one"
        % (("loaded", "not loaded") if lib else ("not loaded", "loaded")))
    return lib


def jax_selections(loss_name, maps, labels, kernel_sample_mask="pred"):
    """The boolean maps the JAX PSELoss / PANLoss take from thresholds on
    the predictions `maps` (NHWC logits at 1/4), as torch tensors named as
    the port's `selections` names them: the OHEM selection, the
    kernel-sample mask, and the IoU logs' text and kernel binarisations."""
    import jax
    import jax.numpy as jnp

    from pytorchocr_tpu.losses import basic
    from pytorchocr_tpu.modeling.common import resize_nearest

    up = resize_nearest(jnp.asarray(maps), 4)
    texts = up[..., 0]
    gt_texts = jnp.asarray(labels[1])
    masks = jnp.asarray(labels[3 if loss_name == "PSELoss" else 4])
    sel = {"ohem": basic.ohem_batch(texts, gt_texts, masks) > 0,
           "kernel_mask": (gt_texts if kernel_sample_mask == "gt"
                           else jax.nn.sigmoid(texts) > 0.5) * masks > 0,
           "text>0": texts > 0,
           "kernel>0": up[..., -1 if loss_name == "PSELoss" else 1] > 0}
    return {k: torch.from_numpy(np.array(v)) for k, v in sel.items()}


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


def shaped_variables(jmod, x_nhwc, seed=0, **init_kw):
    """Random flax variables of `jmod` without running its init: the tree's
    shapes from `jax.eval_shape` (a trace, no compile), kernels drawn from
    numpy with variance 1 / fan-in (kh*kw*in of a conv, in of a Dense), then
    `randomize`'s biases and BN statistics. Much quicker than a jitted init
    on the CPU for deep backbones."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(partial(jmod.init, train=True, **init_kw), jax.random.PRNGKey(seed),
                            jax.tree.map(jnp.asarray, x_nhwc))
    rng = np.random.RandomState(seed)

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.randn(*s.shape) * np.sqrt(1.0 / fan_in)).astype(np.float32)

    variables = jax.tree.map(fill, jax.device_get(dict(shapes)))
    return randomize(variables, rng)


def shaped_train_state(jmod, tx, x_nhwc, seed=0):
    """A JAX TrainState of `jmod` (a BaseModel) holding `shaped_variables`
    and `tx`'s initial state: `create_train_state` without the jitted flax
    init (seconds on the CPU for a deep model)."""
    import jax.numpy as jnp

    from pytorchocr_tpu.trainer import TrainState

    variables = shaped_variables(jmod, x_nhwc, seed)
    return TrainState(params=variables["params"], batch_stats=variables.get("batch_stats", {}),
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))


def shaped_pair(jmod, tmod, x_nhwc, seed=0, **apply_kw):
    """`init_pair` with `shaped_variables` in place of the flax init."""
    import jax

    from pytorchocr_tpu_torch.utils.weights import load_flax_variables

    variables = shaped_variables(jmod, x_nhwc, seed, **apply_kw)
    load_flax_variables(tmod, variables)
    tmod.eval()
    return variables, jax.jit(partial(jmod.apply, train=False, **apply_kw))


def perturbed_tps_params(params, rng, stretch=1.15, rare=True):
    """A TPS's flax params (the `transform` subtree) set to RARE's init
    (or, with `rare` False, to the fiducials of the identity warp),
    perturbed: fc2's weight small and random, its fiducial bias stretched by
    `stretch` (1.15: part of the grid leaves [-1, 1]; below 1 keeps it
    inside), so the grid depends on the input; the tail `fc` small and
    random, its bias 0."""
    loc = params["loc_net"]
    loc["fc2"]["kernel"] = (0.02 * rng.randn(*loc["fc2"]["kernel"].shape)).astype(np.float32)
    half = loc["fc2"]["bias"].shape[0] // 4
    x = np.linspace(-1.0, 1.0, half)
    top, bottom = ((np.linspace(0.0, -1.0, half), np.linspace(1.0, 0.0, half)) if rare
                   else (-np.ones(half), np.ones(half)))
    fid = np.concatenate([np.stack([x, top], 1), np.stack([x, bottom], 1)]).reshape(-1)
    loc["fc2"]["bias"] = (stretch * fid).astype(np.float32)
    params["fc"]["kernel"] = (0.01 * rng.randn(*params["fc"]["kernel"].shape)).astype(np.float32)
    params["fc"]["bias"] = np.zeros_like(params["fc"]["bias"])
    return params


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


def tiny_det_config(path, base, train_label, eval_label, save_dir, size=64, neck=32, batch=2,
                    layers=None, post=None):
    """Write a small-shape copy of a detection training config `base` (DB,
    PSE or PAN) to `path` and return it: its backbone at full depth (or
    ResNet-`layers`), the neck's and the head's widths `neck`, `size`x`size`
    crops (the PSE/PAN GT makers' upscale target too), batch `batch`,
    float32, CPU, one epoch with an eval after it at `size` on the short
    side; `post` updates the PostProcess section."""
    import os

    import yaml

    from pytorchocr_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, base))
    g = cfg["Global"]
    g.update(use_gpu=False, use_amp=False, epoch_num=1, print_batch_step=1,
             save_model_dir=str(save_dir), eval_epoch_step=[0, 1], log_smooth_window=2)
    arch = cfg["Architecture"]
    arch["Neck"]["out_channels"] = neck
    if "hidden_dim" in arch["Head"]:
        arch["Head"]["hidden_dim"] = neck
    if layers is not None:
        arch["Backbone"]["layers"] = layers
    cfg["PostProcess"].update(post or {})
    for op in cfg["Train"]["dataset"]["transforms"]:
        name = next(iter(op))
        if name in ("FusedDetAugCrop", "EastRandomCropData", "RandomCropImgMask"):
            op[name]["size"] = [size, size]
        elif name in ("MakePseGt", "MakePanGt"):
            op[name]["size"] = size
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
    lines, the 36-character table), STAR-Net (`kind` "starnet":
    rec_vgg_tps_bilstm_ctc_synth.yml alike, its TPS "small", the freeze as
    published) or classifier (`kind` "cls": cls_mbv3small_synth.yml at
    3x24x96) training config to `path`: batch 4, float32, CPU, one epoch
    with an eval after it, every augmentation and cal_metric_during_train
    kept; return it."""
    import os

    import yaml

    from pytorchocr_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {"rec": "configs/rec/rec_vgg_bilstm_ctc_synth.yml",
            "starnet": "configs/rec/rec_vgg_tps_bilstm_ctc_synth.yml",
            "cls": "configs/cls/cls_mbv3small_synth.yml"}[kind]
    cfg = load_config(os.path.join(repo, base))
    cfg["Global"].update(use_gpu=False, use_amp=False, epoch_num=1, print_batch_step=1,
                         save_model_dir=str(save_dir), eval_epoch_step=[0, 1],
                         log_smooth_window=2)
    shape = [3, 24, 96] if kind == "cls" else [1, 32, 64]
    if kind == "starnet":
        cfg["Architecture"]["Transform"]["model_name"] = "small"
    if kind != "cls":
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


def tiny_table_config(path, label, save_dir, p=0.25, max_len=12, size=64):
    """Write table_sla_synth.yml at small widths (PPLCNet x0.5, CSPPAN 24,
    hidden 32, `max_len` steps, `size`-square tables) with scheduled
    sampling `p`, bs 2, float32, CPU, one epoch with an eval after it, over
    `label` (a PubTabNet jsonl), everything else as published, to `path`;
    return it."""
    import os

    import yaml

    from pytorchocr_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "table", "table_sla_synth.yml"))
    cfg["Global"].update(use_gpu=False, use_amp=False, epoch_num=1, print_batch_step=1,
                         save_model_dir=str(save_dir), eval_epoch_step=[0, 1],
                         log_smooth_window=2, max_text_length=max_len)
    arch = cfg["Architecture"]
    arch["Backbone"]["scale"] = 0.5
    arch["Neck"]["out_channels"] = 24
    arch["Head"].update(hidden_size=32, max_text_length=max_len, scheduled_sampling_p=p)
    for mode in ("Train", "Eval"):
        for op in cfg[mode]["dataset"]["transforms"]:
            name = next(iter(op))
            if name == "TableLabelEncode":
                op[name]["max_text_length"] = max_len
            elif name == "ResizeTableImage":
                op[name]["max_len"] = size
        cfg[mode]["dataset"]["label_file_list"] = [str(label)]
        cfg[mode]["loader"].update(batch_size_per_card=2, num_workers=1)
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f, sort_keys=False)
    return str(path)


TRAIN_SCRIPT = (
    "import importlib, json, sys\n"
    "out = importlib.import_module('pytorchocr_tpu_torch.tools.train').run(sys.argv[1:])\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pytorchocr_tpu'))\n"
    "assert not bad, bad\n"
    "print('RESULT ' + json.dumps({'steps': out['steps'], 'best': out['best']}))\n"
)


def train_cli(cfg, *opts):
    """`python -m pytorchocr_tpu_torch.tools.train -c cfg -o Global.use_gpu=False
    *opts` in a subprocess from the repo root that must load no module of
    jax, flax or the JAX package; returns {"steps", "best"} of its report."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT, "-c", str(cfg), "-o",
                           "Global.use_gpu=False", *opts], cwd=repo, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])
