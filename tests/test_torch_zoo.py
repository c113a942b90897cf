"""The rest of the detection zoo in the port against the JAX package, on the
CPU: the ASF attention (DB++) in its three forms, FPN and FPEM_FFM with
`use_asf`, the detection MobileNetV3 (small x1.0, large x0.5), ShuffleNetV2
(x0.5, x1.0), RepVGG in train and deploy form, the RepVGG fold against
`reparameterize_params`, DB++ boxes through DBPostProcess, the zoo's
published configs built and served through `infer_det` (float and int8
PTQ), the RepVGG check tool and
the optax-state bridge over the new trees.

Weights cross through the weight bridge with randomised biases and BN
statistics (torch_port_util.randomize). Tolerances, float32: one attention
module at atol/rtol 1e-5; a neck, a backbone or a detector at DEEP (atol
2e-3, rtol 1e-3; XLA:CPU and oneDNN sum in different orders); the fold at
1e-6 relative in float64 (JAX reaches 2.7e-7 on its own fold); boxes
equal."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import linen as fnn

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.modeling.backbones.det_mobilenet_v3 import MobileNetV3 as JMobileNetV3
from pytorchocr_tpu.modeling.backbones.det_repvgg import RepVGG as JRepVGG
from pytorchocr_tpu.modeling.backbones.det_repvgg import RepVGGBlock as JRepVGGBlock
from pytorchocr_tpu.modeling.backbones.det_repvgg import reparameterize_params
from pytorchocr_tpu.modeling.backbones.det_shufflenet_v2 import ShuffleNetV2 as JShuffleNetV2
from pytorchocr_tpu.modeling.necks.asf import ScaleFeatureSelection as JSFS
from pytorchocr_tpu.modeling.necks.fpem_ffm import FPEM_FFM as JFPEM_FFM
from pytorchocr_tpu.modeling.necks.fpn import FPN as JFPN
from pytorchocr_tpu_torch.deploy import infer_det
from pytorchocr_tpu_torch.deploy.infer_det import Deter
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.modeling.backbones.det_mobilenet_v3 import MobileNetV3
from pytorchocr_tpu_torch.modeling.backbones.det_repvgg import (
    RepVGG, RepVGGBlock, reparameterize_state_dict,
)
from pytorchocr_tpu_torch.modeling.backbones.det_shufflenet_v2 import (
    ShuffleNetV2, channel_shuffle,
)
from pytorchocr_tpu_torch.modeling.necks.asf import ScaleFeatureSelection
from pytorchocr_tpu_torch.modeling.necks.fpem_ffm import FPEM_FFM
from pytorchocr_tpu_torch.modeling.necks.fpn import FPN
from pytorchocr_tpu_torch.utils.seeded import nontrivial_bn_, seeded_init_, text_like_db_head_
from pytorchocr_tpu_torch.utils.weights import load_flax_variables
from torch_port_util import DEEP, nchw, nhwc, shaped_pair, shaped_variables, tiny_det_config

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ATT = ["scale_spatial", "scale_channel_spatial", "scale_channel"]


class _JSFSWrap(fnn.Module):
    """The JAX ScaleFeatureSelection on its own levels (NHWC)."""
    in_channels: int
    inter_channels: int
    attention_type: str

    @fnn.compact
    def __call__(self, feats, train=False):
        return JSFS(self.in_channels, self.inter_channels, attention_type=self.attention_type,
                    name="sfs")(jnp.concatenate(feats, axis=-1), feats, train)


class _SFSWrap(torch.nn.Module):
    def __init__(self, in_channels, inter_channels, attention_type):
        super().__init__()
        self.sfs = ScaleFeatureSelection(in_channels, inter_channels,
                                         attention_type=attention_type)

    def forward(self, feats):
        return self.sfs(torch.cat(feats, dim=1), feats)


@pytest.mark.parametrize("attention_type", ATT)
def test_scale_feature_selection_matches_jax(attention_type):
    """Eval mode, and train mode for the one with a BN (scale_channel)."""
    rng = np.random.RandomState(ATT.index(attention_type))
    feats = [rng.randn(2, 8, 10, 6).astype(np.float32) for _ in range(4)]
    jmod, tmod = _JSFSWrap(24, 12, attention_type), _SFSWrap(24, 12, attention_type)
    variables, apply = shaped_pair(jmod, tmod, feats)
    with torch.no_grad():
        got = nhwc(tmod([nchw(f) for f in feats]))
    assert got.shape == (2, 8, 10, 24)
    np.testing.assert_allclose(got, np.asarray(apply(variables, feats)), atol=1e-5, rtol=1e-5)
    if attention_type == "scale_channel":
        want, _ = jmod.apply(variables, feats, train=True, mutable=["batch_stats"])
        with torch.no_grad():
            got = nhwc(tmod.train()([nchw(f) for f in feats]))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fpn_with_asf_matches_jax():
    """DB mode, scale_channel_spatial (det_r18_dbpp.yml's), and the int8
    fused-map region keyed off under use_asf, as in JAX."""
    rng = np.random.RandomState(11)
    chans = [8, 12, 16, 20]
    x = [rng.randn(2, 16 >> i, 16 >> i, c).astype(np.float32) for i, c in enumerate(chans)]
    kw = dict(out_channels=16, mode="DB", use_asf=True, attention_type="scale_channel_spatial")
    tmod = FPN(chans, **kw)
    assert tmod.fuse_absmax is None and FPN(chans, out_channels=16, mode="DB").fuse_absmax
    variables, apply = shaped_pair(JFPN(in_channels=chans, **kw), tmod, x)
    with torch.no_grad():
        got = nhwc(tmod([nchw(a) for a in x]))
    assert got.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(got, np.asarray(apply(variables, x)), **DEEP)


def test_fpem_ffm_with_asf_matches_jax():
    rng = np.random.RandomState(12)
    chans = [8, 12, 16, 20]
    x = [rng.randn(2, 16 >> i, 16 >> i, c).astype(np.float32) for i, c in enumerate(chans)]
    kw = dict(out_channels=8, mode="v2", fpem_num=2, use_asf=True)
    tmod = FPEM_FFM(chans, **kw)
    variables, apply = shaped_pair(JFPEM_FFM(in_channels=chans, **kw), tmod, x)
    with torch.no_grad():
        got = nhwc(tmod([nchw(a) for a in x]))
    assert got.shape == (2, 16, 16, 32)
    np.testing.assert_allclose(got, np.asarray(apply(variables, x)), **DEEP)


def _backbone_matches(jmod, tmod, x):
    """Every feature map at DEEP; untrained stacks reach activations of
    ~1e4-1e5, so the atol grows with the map's largest value (2e-6 of it, at
    least DEEP's), as test_torch_pse_pan.py holds ResNet-50."""
    variables, apply = shaped_pair(jmod, tmod, x)
    with torch.no_grad():
        got = [nhwc(t) for t in tmod(nchw(x))]
    want = [np.asarray(w) for w in apply(variables, x)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.shape[-1] for g in got] == list(tmod.out_channels) == list(jmod.out_channels)
    for g, w in zip(got, want):
        atol = max(DEEP["atol"], 2e-6 * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=DEEP["rtol"], atol=atol)
    return variables


@pytest.mark.parametrize("name,width,se", [("small", 1.0, True), ("large", 0.5, False)])
def test_det_mobilenet_v3_matches_jax(name, width, se):
    """det_mbv3_db.yml's small x1.0 and det_mbv3large05_db_synth.yml's large
    x0.5 (taps from index 2); BN eps 1e-3, flax momentum 0.99."""
    x = np.random.RandomState(13).randn(2, 64, 64, 3).astype(np.float32)
    tmod = MobileNetV3(3, name, width, se)
    assert tmod.conv1.bn.eps == 1e-3 and tmod.conv1.bn.momentum == pytest.approx(0.01)
    _backbone_matches(JMobileNetV3(model_name=name, width_mult=width, use_se=se), tmod, x)


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_shufflenet_v2_matches_jax(scale):
    x = np.random.RandomState(14).randn(2, 64, 64, 3).astype(np.float32)
    _backbone_matches(JShuffleNetV2(scale=scale), ShuffleNetV2(3, scale), x)


def test_channel_shuffle_gives_the_jax_channel_order():
    from pytorchocr_tpu.modeling.backbones.det_shufflenet_v2 import (
        channel_shuffle as jax_channel_shuffle,
    )
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    want = np.asarray(jax_channel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_array_equal(nhwc(channel_shuffle(nchw(x), 2)), want)


@pytest.mark.parametrize("deploy", [False, True])
def test_repvgg_matches_jax(deploy):
    """RepVGG-A0 (det_repvgg_db_synth.yml's) in train form (dense, one,
    idbn) and in deploy form (reparam)."""
    x = np.random.RandomState(15).randn(2, 64, 64, 3).astype(np.float32)
    tmod = RepVGG(3, "A0", deploy=deploy)
    _backbone_matches(JRepVGG(model_name="A0", deploy=deploy), tmod, x)


def _f64(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float64), tree)


@pytest.mark.parametrize("groups", [1, 2])
def test_repvgg_fold_matches_reparameterize_params(groups):
    """The fold of one block (groups 2: the grouped identity kernel, o %
    in_dim) and of RepVGG-A0 against the JAX fold, both in float64 from the
    same float32 weights, within 1e-6 relative; the folded A0 in float64
    gives the train form's maps within 1e-6 relative."""
    rng = np.random.RandomState(16 + groups)
    if groups == 1:
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
        jmod, tmod = JRepVGG(model_name="A0"), RepVGG(3, "A0")
    else:
        x = rng.randn(2, 6, 6, 8).astype(np.float32)
        jmod, tmod = JRepVGGBlock(8, 1, groups=groups), RepVGGBlock(8, 8, 1, groups=groups)
    variables, _ = shaped_pair(jmod, tmod, x)
    want = reparameterize_params(_f64(variables["params"]), _f64(variables["batch_stats"]))
    folded = reparameterize_state_dict(tmod)
    n = 0
    for name, mod in tmod.named_modules():
        if not isinstance(mod, RepVGGBlock):
            continue
        leaf = want
        for k in (name.split(".") if name else []):
            leaf = leaf[k]
        p = name + "." if name else ""
        kernel = np.transpose(leaf["reparam"]["kernel"], (3, 2, 0, 1))
        for got, ref in ((folded[p + "reparam.weight"], kernel),
                         (folded[p + "reparam.bias"], leaf["reparam"]["bias"])):
            assert got.dtype == torch.float64
            err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-6, (name, err)
        n += 1
    assert n == (1 if groups > 1 else 22)

    deploy = RepVGG(3, "A0", deploy=True) if groups == 1 else \
        RepVGGBlock(8, 8, 1, groups=groups, deploy=True)
    deploy.load_state_dict(folded)
    xt = nchw(x).double()
    with torch.no_grad():
        a, b = tmod.double()(xt), deploy.double().eval()(xt)
    for u, v in zip(a if groups == 1 else [a], b if groups == 1 else [b]):
        assert float((u - v).abs().max() / u.abs().max()) < 1e-6


DBPP_CFG = """
Global: {distributed: False, seed: 1}
Architecture:
  model_type: det
  algorithm: DB
  Transform:
  Backbone: {name: ResNet, layers: 18}
  Neck: {name: FPN, out_channels: 32, mode: DB, use_asf: True,
         attention_type: scale_channel_spatial}
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


def test_dbpp_boxes_match_jax_db_postprocess(tmp_path):
    """A small DB++ (ResNet-18, FPN 32 with ASF scale_channel_spatial,
    DBHead) with the JAX init, its head made text-like on two drawn pages
    (utils.seeded.text_like_db_head_) and written back into the flax
    params: the JAX model and DBPostProcess on the port's preprocessed
    pages give the port Deter.run_batch's boxes, every one."""
    import synth

    from pytorchocr_tpu.postprocess import build_post_process as jax_build_post
    from pytorchocr_tpu.utils.utility import sort_boxes as jax_sort_boxes

    cfg_path = tmp_path / "dbpp.yml"
    cfg_path.write_text(DBPP_CFG)
    label = synth.make_det_dataset(str(tmp_path / "imgs"), n=2, size=160, seed=3)
    pages = [label.replace("det_label.txt", "det_%04d.png" % i) for i in range(2)]
    cfg = yaml.safe_load(DBPP_CFG)
    jmod = jax_build_model(cfg["Architecture"])
    deter = Deter(str(cfg_path), None, device="cpu")
    imgs = [cv2.imread(p) for p in pages]
    pre = [deter._preprocess(im) for im in imgs]
    batch = np.concatenate([p[0] for p in pre])
    x = deter.runner.normalize(torch.from_numpy(batch))
    variables = shaped_variables(jmod, x.numpy(), seed=17)
    model = deter.runner.model
    load_flax_variables(model, variables)
    dark = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) < 128 for im in batch])
    text_like_db_head_(model, x.permute(0, 3, 1, 2), dark)
    tower = variables["params"]["head"]["binarize"]
    for name in ("deconv1", "deconv2"):  # phase-free kernels: the bridge's flip is a no-op
        w = getattr(model.head.binarize, name)
        tower[name]["kernel"] = np.ascontiguousarray(w.weight.detach().numpy().transpose(2, 3, 0, 1))
        tower[name]["bias"] = w.bias.detach().numpy().copy()

    maps = jmod.apply(variables, jnp.asarray(x.numpy()), train=False)
    shapes = np.concatenate([p[1] for p in pre])
    want = jax_build_post(cfg["PostProcess"])({"maps": np.asarray(maps["maps"])}, shapes)
    got = deter.run_batch(imgs)
    assert sum(len(b) for b in got) >= 2, "no text boxes found"
    for page, ref in zip(got, want):
        ref = jax_sort_boxes(ref["points"])
        assert len(page) == len(ref)
        for box, wbox in zip(page, ref):
            np.testing.assert_array_equal(box, np.asarray(wbox))


ZOO = ["det_r18_dbpp.yml", "det_r18_dbpp_synth.yml", "det_mbv3_db.yml",
       "det_mbv3large05_db_synth.yml", "det_sfv2_db.yml", "det_repvgg_db_synth.yml",
       "det_r50_db.yml"]


def _small_eval_config(tmp_path, name, side=64):
    from pytorchocr_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(os.path.join(REPO, "configs", "det", name))
    for op in cfg["Eval"]["dataset"]["transforms"]:
        if "DetResizeForTest" in op:
            op["DetResizeForTest"] = {"limit_side_len": side, "limit_type": "min"}
    path = str(tmp_path / name)
    save_config(cfg, path)
    return path


@pytest.mark.parametrize("name", ZOO)
def test_zoo_config_serves_through_infer_det(tmp_path, monkeypatch, name):
    """The published config at its own widths, seeded weights saved as a
    .pt, through `python -m pytorchocr_tpu_torch.deploy.infer_det`'s main on
    a drawn page (resized to 64 on its short side): one res_*.txt of
    integer boxes; with `--quant --calib_n 1` (int8 PTQ, calibrated on the
    page) too: every detector of the zoo runs int8."""
    import synth

    cfg_path = _small_eval_config(tmp_path, name)
    label = synth.make_det_dataset(str(tmp_path / "imgs"), n=1, size=160, seed=5)
    page = label.replace("det_label.txt", "det_0000.png")
    model = build_model(yaml.safe_load(open(cfg_path))["Architecture"])
    seeded_init_(model, torch.Generator().manual_seed(0))
    pt = str(tmp_path / "det.pt")
    torch.save(model.state_dict(), pt)
    out = tmp_path / "out"
    argv = ["infer_det", "--config", cfg_path, "--model_path", pt, "--img_path", page,
            "--out_dir", str(out), "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    infer_det.main()
    rows = (out / "res_det_0000.txt").read_text().splitlines()
    assert all(len(r.split(",")) == 8 for r in rows)
    (out / "res_det_0000.txt").unlink()
    monkeypatch.setattr(sys, "argv", argv + ["--quant", "--calib_n", "1"])
    infer_det.main()
    rows = (out / "res_det_0000.txt").read_text().splitlines()
    assert all(len(r.split(",")) == 8 for r in rows)


def test_check_repvgg_deploy_tool_passes_on_a_checkpoint(tmp_path, capsys):
    """`python -m pytorchocr_tpu_torch.tools.check_repvgg_deploy` on a small
    RepVGG-A0 DB checkpoint with seeded, non-trivial BN statistics: the
    folded deploy model's prob maps within 1e-4 of the train form's
    (float32 on the CPU; the tool's own bound is 0.05), and its report."""
    import synth

    from pytorchocr_tpu_torch.optimizer import build_optimizer
    from pytorchocr_tpu_torch.tools import check_repvgg_deploy
    from pytorchocr_tpu_torch.utils.save_load import save_model

    label = synth.make_det_dataset(str(tmp_path / "data"), n=2, size=160, seed=4)
    cfg = tiny_det_config(tmp_path / "cfg.yml", "configs/det/det_repvgg_db_synth.yml", label,
                          label, tmp_path / "out")
    config = yaml.safe_load(open(cfg))
    model = build_model(config["Architecture"])
    gen = torch.Generator().manual_seed(3)
    nontrivial_bn_(seeded_init_(model, gen), gen)
    opt, _ = build_optimizer(config["Optimizer"], epochs=1, step_each_epoch=1,
                             parameters=model.parameters())
    save_model(model, opt, {"start_epoch": 1, "global_step": 0, "best_model": {}},
               str(tmp_path / "out"), prefix="best_accuracy")
    ok, max_abs = check_repvgg_deploy.run(
        ["-c", cfg, "-o", "Global.use_gpu=False", "Global.device_normalize=False",
         "Global.checkpoints=%s" % (tmp_path / "out" / "best_accuracy")])
    assert ok and max_abs < 1e-4, max_abs
    assert "REPVGG_DEPLOY_PARITY OK" in capsys.readouterr().out


OPTAX_ARCHS = {
    "dbpp": (yaml.safe_load(DBPP_CFG)["Architecture"], (1, 64, 64, 3),
             ("neck.concat_attention.conv.weight", ("neck", "concat_attention", "conv", "kernel"))),
    "repvgg": ({"model_type": "det", "algorithm": "DB", "Backbone": {"name": "RepVGG"},
                "Neck": {"name": "FPN", "out_channels": 32, "mode": "DB"},
                "Head": {"name": "DBHead", "k": 50}}, (1, 64, 64, 3),
               ("backbone.stage2_1.idbn.weight", ("backbone", "stage2_1", "idbn", "scale"))),
    "starnet": ({"model_type": "rec", "algorithm": "STARNet", "in_channels": 1,
                 "Transform": {"name": "TPS", "num_fiducial": 20, "model_name": "small"},
                 "Backbone": {"name": "VGG", "model_name": "v1", "scale": 0.5},
                 "Neck": {"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 32},
                 "Head": {"name": "CTCHead", "out_channels": 37}}, (1, 32, 64, 1),
                ("transform.loc_net.fc2.weight", ("transform", "loc_net", "fc2", "kernel"))),
}


@pytest.mark.parametrize("arch", sorted(OPTAX_ARCHS))
def test_optax_state_bridge_takes_the_new_trees(arch):
    """load_optax_adam_state carries random amsgrad moments in the JAX
    params layout (the ASF attention, RepVGG's branches, the TPS) onto
    every parameter of the port's optimizer, each in its leaf's layout (a
    conv kernel HWIO -> OIHW, a Dense kernel transposed, a BN scale)."""
    from pytorchocr_tpu_torch.optimizer import build_optimizer
    from pytorchocr_tpu_torch.utils.weights import load_optax_adam_state

    cfg, shape, (name, path) = OPTAX_ARCHS[arch]
    jmod, model = jax_build_model(cfg), build_model(cfg)
    variables = shaped_variables(jmod, np.zeros(shape, np.float32))
    rng = np.random.RandomState(7)
    moments = {k: jax.tree.map(lambda v: rng.rand(*np.shape(v)).astype(np.float32),
                               variables["params"]) for k in ("mu", "nu", "nu_max")}
    opt, _ = build_optimizer({"base_lr": 1e-3, "optim": {"name": "Adam", "amsgrad": True}},
                             epochs=1, step_each_epoch=1, parameters=model.parameters())
    load_optax_adam_state(opt, model, dict(moments, count=5), variables["batch_stats"])
    named = dict(model.named_parameters())
    trained = [p for g in opt.param_groups for p in g["params"]]
    assert all(set(opt.state[p]) == {"mu", "nu", "nu_max"} for p in trained)
    assert opt.param_groups[0]["count"] == 5
    leaf = moments["nu"]
    for k in path:
        leaf = leaf[k]
    want = torch.from_numpy(np.ascontiguousarray(
        leaf.T if leaf.ndim == 2 else np.transpose(leaf, (3, 2, 0, 1)) if leaf.ndim == 4
        else leaf))
    assert torch.equal(opt.state[named[name]]["nu"], want)
