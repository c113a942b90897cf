"""The zoo's tail in the port against the JAX package, on the CPU:
DB-ConvNeXt-tiny and DB-Swin (embed 32) at 160x160, their backbones' taps
and their boxes through the DB post process (Swin's stages 1-3 shift 7x7
windows over padded maps, stage 4 takes 5x5 windows without the shift), the
recognition ResNet (18, 34, 50), DPModule, a CRNN-ResNet34 (CTC texts
equal), the drop path, AttnLabelEncode /
AttnLabelDecode, CopyPaste, Resize, ToCHWImage and the torchvision weight
converter.

Weights cross through the weight bridge (shaped_variables: random kernels,
randomised biases, LayerNorm and BN statistics). A backbone or module in
float32 within 1e-5 of the largest |value| of each JAX output; integer
outputs (boxes, texts, labels) equal.

The JAX ConvNeXt reads its drop-path rates with `float()` of a
jnp.linspace (det_convnext.py:70-72), which fails under any trace
(ConcretizationTypeError): jax.jit and jax.eval_shape of it run here under
`jax.ensure_compile_time_eval()`, which evaluates that constant eagerly.
"""

import os
import random
import sys
from functools import partial

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pytorchocr_tpu.data.imaug import create_operators as jax_create_operators
from pytorchocr_tpu.data.imaug import transform as jax_transform
from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.modeling.backbones.det_convnext import ConvNeXt as JConvNeXt
from pytorchocr_tpu.modeling.backbones.det_swin import SwinTransformer as JSwin
from pytorchocr_tpu.modeling.backbones.rec_resnet import ResNet as JRecResNet
from pytorchocr_tpu.modeling.common import DPModule as JDPModule
from pytorchocr_tpu.postprocess import build_post_process as jax_build_post
from pytorchocr_tpu_torch.data.imaug import create_operators, transform
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.modeling.backbones.det_convnext import ConvNeXt
from pytorchocr_tpu_torch.modeling.backbones.det_swin import SwinTransformer
from pytorchocr_tpu_torch.modeling.backbones.rec_resnet import ResNet as RecResNet
from pytorchocr_tpu_torch.modeling.common import DPModule, drop_path, linspace_f32
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.tools.convert_torch_weights import convert_resnet_state
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.seeded import text_like_db_head_
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import nchw, nhwc, shaped_pair, shaped_variables

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
REL = 1e-5  # float32: max |port - JAX| over the JAX output's max |value|


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= REL, err


def _matches(jmod, tmod, x, jit=False):
    """The bridged port module against the JAX one's eager apply, or its
    jitted one where that compiles quicker than the eager ops run (Swin's
    many small ops)."""
    with jax.ensure_compile_time_eval():
        variables = shaped_variables(jmod, x)
    load_flax_variables(tmod, variables)
    apply = partial(jmod.apply, train=False)
    want = (jax.jit(apply) if jit else apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod.eval()(nchw(x))
    if not isinstance(got, list):
        got, want = [got], [want]
    for g, w in zip(got, want):
        _close(nhwc(g), w)


def test_convnext_drop_path_rates_are_jax_float32():
    """ConvNeXt's drop-path rates are jnp.linspace's float32 values bit for
    bit (its forward against JAX: test_db_boxes_match_jax's taps)."""
    assert ConvNeXt(3, "tiny").out_channels == list(JConvNeXt(model_name="tiny").out_channels)
    for rate, n in ((0.4, 18), (0.4, 36), (0.2, 12)):
        np.testing.assert_array_equal(np.float32(linspace_f32(rate, n)),
                                      np.asarray(jnp.linspace(0, rate, n)))
    assert [b.drop_rate for b in ConvNeXt(3, "tiny").modules() if hasattr(b, "drop_rate")] \
        == linspace_f32(0.4, 18)


@pytest.mark.parametrize("arch,jax_cls", [
    ({"model_type": "det", "Backbone": {"name": "ConvNeXt", "model_name": "small"}}, JConvNeXt),
    ({"model_type": "det", "Backbone": {"name": "ConvNeXt", "model_name": "base"}}, JConvNeXt),
    ({"model_type": "det", "Backbone": {"name": "SwinTransformer"}}, JSwin),
    ({"model_type": "rec", "Backbone": {"name": "ResNet", "layers": 101}}, JRecResNet),
    ({"model_type": "rec", "Backbone": {"name": "ResNet", "layers": 152}}, JRecResNet),
], ids=["ConvNeXt-small", "ConvNeXt-base", "Swin-T", "ResNet101", "ResNet152"])
def test_build_model_builds_the_tail(arch, jax_cls):
    """build_model's registries build the deeper variants (a det model with
    FPN 32 and DBHead, a rec model with the CTC neck and head), their
    widths the JAX modules'."""
    cfg = dict(arch, algorithm="DB" if arch["model_type"] == "det" else "CRNN", Transform=None)
    if arch["model_type"] == "det":
        cfg.update(Neck={"name": "FPN", "out_channels": 32, "mode": "DB"},
                   Head={"name": "DBHead", "k": 50})
    else:
        cfg.update(Neck={"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 48},
                   Head={"name": "CTCHead", "out_channels": 37})
    backbone = build_model(cfg).backbone
    kwargs = {k: v for k, v in arch["Backbone"].items() if k != "name"}
    assert backbone.out_channels == jax_cls(**kwargs).out_channels


@pytest.mark.parametrize("layers", [18, 34, 50])
def test_rec_resnet_matches_jax(layers):
    """(N, 32, W) gray lines -> (N, C, 1, W/4), the height collapsed."""
    x = np.random.RandomState(layers).randn(2, 32, 64, 1).astype(np.float32)
    tmod = RecResNet(1, layers)
    assert tmod.out_channels == JRecResNet(layers=layers).out_channels
    _matches(JRecResNet(layers=layers), tmod, x)
    with torch.no_grad():
        assert tmod(nchw(x)).shape[2:] == (1, 16)


def test_dp_module_matches_jax():
    x = np.random.RandomState(22).randn(2, 16, 16, 12).astype(np.float32)
    _matches(JDPModule(out_channels=20, stride=2), DPModule(12, 20, stride=2), x)


DB_CFG = """
Global: {use_gpu: False}
Architecture:
  model_type: det
  algorithm: DB
  Transform:
  Backbone: %s
  Neck: {name: FPN, out_channels: 32, mode: DB}
  Head: {name: DBHead, k: 50}
PostProcess: {name: DBPostProcess, thresh: 0.3, box_thresh: 0.5, max_candidates: 100,
              unclip_ratio: 1.5, score_mode: poly}
Eval:
  dataset:
    name: SimpleDataSet
    label_file_list: [dummy]
    transforms:
      - DecodeImage: {img_mode: RGB, channel_first: False}
      - DetLabelEncode:
      - DetResizeForTest: {limit_side_len: 160, limit_type: min}
      - ToTensor:
      - Normalize: {mean: [0.485, 0.456, 0.406], std: [0.229, 0.224, 0.225]}
      - KeepKeys: {keep_keys: [image, shape, polys, ignore_tags]}
"""


@pytest.mark.parametrize("backbone", [
    "{name: ConvNeXt, model_name: tiny, drop_path_rate: 0.0}",
    "{name: SwinTransformer, embed_dim: 32, depths: [2, 2, 2, 2], num_heads: [1, 2, 4, 8], "
    "drop_path_rate: 0.0}",
], ids=["ConvNeXt", "Swin"])
def test_db_boxes_match_jax(tmp_path, backbone):
    """DB-ConvNeXt-tiny and DB-Swin (FPN 32, DBHead) with the JAX weights at
    160x160 (Swin: stages 1-3 shift 7x7 windows over padded maps, stage 4
    takes 5x5 windows without the shift, its bias tables the 81 rows of the
    window the JAX init saw, so a forward at 7x7 windows there raises, as
    flax's apply would on the shape): the backbone's four taps within 1e-5;
    then, the head made text-like on two drawn pages and written back
    into the flax params, the JAX model and DBPostProcess on the port's
    preprocessed pages give the port Deter.run_batch's boxes (its front half
    through K1's plain version), every one."""
    import synth

    from pytorchocr_tpu.utils.utility import sort_boxes as jax_sort_boxes

    text = DB_CFG % backbone
    cfg_path = tmp_path / "db.yml"
    cfg_path.write_text(text)
    label = synth.make_det_dataset(str(tmp_path / "imgs"), n=2, size=160, seed=5)
    pages = [label.replace("det_label.txt", "det_%04d.png" % i) for i in range(2)]
    cfg = yaml.safe_load(text)
    jmod = jax_build_model(cfg["Architecture"])
    deter = Deter(str(cfg_path), None, device="cpu")
    imgs = [cv2.imread(p) for p in pages]
    pre = [deter._preprocess(im) for im in imgs]
    batch = np.concatenate([p[0] for p in pre])
    x = deter.runner.normalize(torch.from_numpy(batch))
    with jax.ensure_compile_time_eval():
        variables = shaped_variables(jmod, x.numpy(), seed=23)
    model = deter.runner.model
    load_flax_variables(model, variables)
    dark = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) < 128 for im in batch])
    text_like_db_head_(model, x.permute(0, 3, 1, 2), dark)
    tower = variables["params"]["head"]["binarize"]
    for name in ("deconv1", "deconv2"):  # phase-free kernels: the bridge's flip is a no-op
        w = getattr(model.head.binarize, name)
        tower[name]["kernel"] = np.ascontiguousarray(w.weight.detach().numpy().transpose(2, 3, 0, 1))
        tower[name]["bias"] = w.bias.detach().numpy().copy()

    apply = partial(jmod.apply, train=False,
                    capture_intermediates=lambda mdl, _: mdl.name == "backbone")
    if "Swin" in backbone:  # its many small ops: a jit compiles quicker than they run
        apply = jax.jit(apply)
    maps, seen = apply(variables, jnp.asarray(x.numpy()))
    with torch.no_grad():
        taps = model.eval().backbone(x.permute(0, 3, 1, 2))
    for got, want in zip(taps, seen["intermediates"]["backbone"]["__call__"][0]):
        _close(nhwc(got), want)
    if "Swin" in backbone:
        assert model.backbone.stage3_block0.attn.relative_position_bias_table.shape == (81, 8)
        with pytest.raises(ValueError, match="window"), torch.no_grad():
            model.backbone(torch.zeros(1, 3, 224, 224))
    shapes = np.concatenate([p[1] for p in pre])
    want = jax_build_post(cfg["PostProcess"])({"maps": np.asarray(maps["maps"])}, shapes)
    got = deter.run_batch(imgs)
    assert sum(len(b) for b in got) >= 2, "no text boxes found"
    for page, ref in zip(got, want):
        ref = jax_sort_boxes(ref["points"])
        assert len(page) == len(ref)
        for box, wbox in zip(page, ref):
            np.testing.assert_array_equal(box, np.asarray(wbox))


def test_crnn_resnet34_texts_match_jax():
    """rec_vgg_bilstm_ctc.yml with Backbone {name: ResNet, layers: 34} (the
    6,624-class head; BiLSTM 48 here): the same CTC texts from both
    packages' CTCLabelDecode on 8 gray 32x64 lines, their confidences within
    1e-5."""
    cfg = load_config(os.path.join(REPO, "configs", "rec", "rec_vgg_bilstm_ctc.yml"))
    arch = cfg["Architecture"]
    arch["Backbone"] = {"name": "ResNet", "layers": 34}
    arch["Neck"]["hidden_size"] = 48
    post = {"name": "CTCLabelDecode",
            "character_dict_path": os.path.join(REPO, cfg["Global"]["character_dict_path"])}
    arch["Head"]["out_channels"] = len(build_post_process(post).character)
    assert arch["Head"]["out_channels"] == 6624
    x = np.random.RandomState(24).rand(8, 32, 64, 1).astype(np.float32)
    jmod = jax_build_model(arch)
    tmod = build_model(arch)
    variables, apply = shaped_pair(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    want = np.asarray(apply(variables, x))
    _close(got.numpy(), want)
    texts, jtexts = build_post_process(post)(got), jax_build_post(post)(want)
    assert [t for t, _ in texts] == [t for t, _ in jtexts]
    np.testing.assert_allclose([c for _, c in texts], [c for _, c in jtexts], rtol=1e-5)
    assert sum(len(t) for t, _ in texts) > 0


def test_drop_path_needs_a_generator_in_both_packages():
    """A train-mode forward through a drop path > 0 without a random source:
    flax raises InvalidRngError for the "dropout" rng the JAX train step
    never hands it (trainer.py:159), the port raises naming that; eval mode
    and a rate of 0 need none. With a generator, the keep share of 40,000
    samples at rate 0.3 lies within 4.5 binomial sigma of 0.7, and a kept
    sample is divided by 0.7."""
    from flax.errors import InvalidRngError

    x = np.random.RandomState(25).randn(1, 32, 32, 3).astype(np.float32)
    small_swin = dict(SWIN, embed_dim=8, depths=(1, 1, 1, 1), drop_path_rate=0.2)
    jmod = JSwin(**small_swin)  # the same make_rng("dropout") as ConvNeXt's block
    variables = shaped_variables(jmod, x)
    with pytest.raises(InvalidRngError, match="dropout"):  # raised while tracing
        jax.eval_shape(partial(jmod.apply, train=True, rngs={"sample": jax.random.PRNGKey(1)}),
                       variables, jnp.asarray(x))
    # a fresh Swin's tables are for 7x7 windows: its last stage needs 224 px
    x224 = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(25))
    for tmod, xt in ((ConvNeXt(3, "tiny", 0.4), nchw(x)), (SwinTransformer(3, **small_swin), x224)):
        tmod.train()
        with pytest.raises(RuntimeError, match="InvalidRngError"):
            tmod(xt)
        tmod(xt, generator=torch.Generator().manual_seed(0))
        tmod.eval()
        with torch.no_grad():
            tmod(xt)
    ConvNeXt(3, "tiny", 0.0).train()(nchw(x))

    n, rate = 40000, 0.3
    ones = torch.ones(n, 1, 1, 1)
    out = drop_path(ones, rate, True, torch.Generator().manual_seed(1))
    kept = float((out != 0).float().mean())
    assert abs(kept - 0.7) <= 4.5 * (0.7 * 0.3 / n) ** 0.5, kept
    assert torch.equal(out[out != 0], torch.full_like(out[out != 0], 1.0 / 0.7))
    assert torch.equal(drop_path(ones, rate, False, None), ones)


def test_attn_label_encode_and_decode_match_jax():
    """AttnLabelEncode on texts of the 36-character table and of the
    6,623-character dictionary (too long, empty, unknown characters), then
    AttnLabelDecode of those labels and of predictions that run past eos
    (the JAX rule stops at eos)."""
    dict_path = os.path.join(REPO, "pytorchocr_tpu", "utils", "char_dict_6623.txt")
    texts = ["hello", "a", "x" * 24, "x" * 25, "", "Abc!9", "你好世界"]
    for params in ({"max_text_length": 25},
                   {"max_text_length": 25, "character_dict_path": dict_path}):
        ops = [{"AttnLabelEncode": params}]
        enc, jenc = create_operators(ops)[0], jax_create_operators(ops)[0]
        assert enc.character == jenc.character
        labels = []
        for t in texts:
            got, want = enc({"label": t}), jenc({"label": t})
            assert (got is None) == (want is None), t
            if got is not None:
                np.testing.assert_array_equal(got["label"], want["label"])
                np.testing.assert_array_equal(got["length"], want["length"])
                if len(got["label"]) == 25:  # 24 characters give 26 in both packages
                    labels.append(got["label"])
        post = {"name": "AttnLabelDecode", **{k: v for k, v in params.items()
                                              if k == "character_dict_path"}}
        dec, jdec = build_post_process(post), jax_build_post(post)
        rng = np.random.RandomState(26)
        probs = rng.rand(4, 12, len(dec.character)).astype(np.float32)
        probs[0, 5, -1] = 2.0  # eos at step 5: the text stops there
        probs[1, :, 0] = 2.0  # sos everywhere: empty
        got = dec(torch.from_numpy(probs), np.stack(labels))
        want = jdec(probs, np.stack(labels))
        assert got[1] == want[1]
        assert [t for t, _ in got[0]] == [t for t, _ in want[0]]
        np.testing.assert_allclose([c for _, c in got[0]], [c for _, c in want[0]], rtol=1e-6)
        assert got[0][1] == ("", 0.0) and 0 < len(got[0][0][0]) <= 5


def _det_sample(seed, size=(120, 160), n=5):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, size + (3,)).astype(np.uint8)
    polys = []
    for _ in range(n):
        x, y = rng.randint(5, size[1] - 45), rng.randint(5, size[0] - 25)
        w, h = rng.randint(15, 40), rng.randint(8, 20)
        polys.append([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
    return {"image": img, "polys": np.array(polys, np.float32),
            "ignore_tags": np.array([i == n - 1 for i in range(n)])}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copy_paste_resize_to_chw_match_jax(seed):
    """CopyPaste (the other sample's crops rotated and pasted where they
    overlap no polygon, limit_paste on and off), then Resize and ToCHWImage:
    with `random` and `np.random` seeded alike before each package's chain,
    image and polygons equal."""
    ops = [{"CopyPaste": {"objects_paste_ratio": 0.6, "limit_paste": seed != 2}},
           {"Resize": {"size": [96, 128]}}, {"ToCHWImage": None}]
    out = []
    for create, run in ((create_operators, transform), (jax_create_operators, jax_transform)):
        data = _det_sample(seed)
        data["ext_data"] = [_det_sample(seed + 10, size=(140, 150))]
        random.seed(seed)
        np.random.seed(seed)
        out.append(run(data, create(ops)))
    got, want = out
    assert got["image"].shape == (3, 96, 128)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["polys"], want["polys"])
    np.testing.assert_array_equal(got["ignore_tags"], want["ignore_tags"])
    assert len(got["polys"]) > 5 or seed == 2


def test_torchvision_converter_matches_the_jax_path(tmp_path):
    """A synthetic torchvision ResNet-18 / 50 state_dict (the key names of
    JAX tools/convert_torch_weights.resnet_key_map, fc included) through the
    JAX apply_mapping and then the weight bridge equals the port
    converter's output, tensor for tensor; the backbone loads it through
    Architecture.Backbone.{pretrained, ckpt_path}."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import convert_torch_weights as jconv

    from pytorchocr_tpu.modeling.backbones.det_resnet import ResNet as JResNet
    from pytorchocr_tpu_torch.modeling.backbones.det_resnet import ResNet
    from pytorchocr_tpu_torch.utils.save_load import load_backbone_pretrained

    for layers in (18, 50):
        rng = np.random.RandomState(layers)
        jmod = JResNet(layers=layers)
        x = np.zeros((1, 64, 64, 3), np.float32)
        variables = shaped_variables(jmod, x, seed=layers)
        tv = {}
        for path, (key, fn) in jconv.resnet_key_map(layers).items():
            leaf = variables[path[0]]
            for k in path[1:]:
                leaf = leaf.get(k) if isinstance(leaf, dict) else None
            if leaf is None:
                continue
            shape = np.shape(leaf)
            if fn is jconv._t_conv:  # HWIO -> torchvision's OIHW
                shape = (shape[3], shape[2], shape[0], shape[1])
            tv[key] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        tv["fc.weight"], tv["fc.bias"] = torch.zeros(1000, 512 * (1 if layers < 50 else 4)), \
            torch.zeros(1000)
        params, stats = jconv.apply_mapping(variables["params"], variables["batch_stats"],
                                            {k: v.numpy() for k, v in tv.items()},
                                            jconv.resnet_key_map(layers), logger=lambda *a: None)
        want = flax_to_state_dict(ResNet(layers=layers),
                                  {"params": params, "batch_stats": stats})
        got = convert_resnet_state(tv, layers, log=lambda *a: None)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    path = str(tmp_path / "r50.pt")
    torch.save(got, path)
    arch = {"model_type": "det", "algorithm": "DB", "Transform": None,
            "Backbone": {"name": "ResNet", "layers": 50, "pretrained": True, "ckpt_path": path},
            "Neck": {"name": "FPN", "out_channels": 32, "mode": "DB"},
            "Head": {"name": "DBHead", "k": 50}}
    model = load_backbone_pretrained(build_model(arch), arch)
    for k, v in got.items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
