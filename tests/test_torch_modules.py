"""The port's modules against the JAX package in float32, with weights that
cross through the weight bridge (pytorchocr_tpu_torch/utils/weights.py).

Inputs come from seeded numpy. BN statistics and all biases are randomised
so that a swapped or missing mapping shows. Tolerances: a single conv+BN is
held at 1e-5 (one f32 reduction, different summation order); deep stacks
at atol 2e-3 / rtol 1e-3, as tests/test_weight_convert.py holds ResNet
(XLA:CPU and oneDNN sum convolutions in different orders, and ReLU/BN chains
amplify the last-bit differences). Integer outputs (CTC codes, lengths) and
the nearest upsample are exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.modeling import build_model as jax_build_model
from pytorchocr_tpu.modeling import common as jcommon
from pytorchocr_tpu.modeling.backbones.rec_vgg import VGG as JVGG
from pytorchocr_tpu.modeling.heads.det_db_head import DBHead as JDBHead
from pytorchocr_tpu.modeling.heads.rec_ctc_head import CTCHead as JCTCHead
from pytorchocr_tpu.modeling.necks.rnn import SequenceEncoder as JSeqEnc
from pytorchocr_tpu.ops.ctc_decode import ctc_greedy_collapse as jax_collapse
from pytorchocr_tpu_torch.modeling import build_model, common
from pytorchocr_tpu_torch.modeling.backbones.rec_vgg import VGG
from pytorchocr_tpu_torch.modeling.heads.det_db_head import DBHead
from pytorchocr_tpu_torch.modeling.heads.rec_ctc_head import CTCHead
from pytorchocr_tpu_torch.modeling.necks.rnn import SequenceEncoder
from pytorchocr_tpu_torch.ops.ctc_decode import ctc_greedy_collapse
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict
from torch_port_util import DEEP, init_pair, nchw, nhwc


def test_conv_bn_act_matches_jax():
    x = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    jmod = jcommon.ConvBNAct(8, 3, 2, act="relu")
    tmod = common.ConvBNAct(3, 8, 3, 2, act="relu")
    variables, apply = init_pair(jmod, tmod, x)
    assert tmod.bn.momentum == pytest.approx(0.1)  # flax momentum 0.9
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), np.asarray(apply(variables, x)),
                               atol=1e-5, rtol=1e-5)


def test_resize_nearest_exact():
    x = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32)
    for s in (2, 4, 8):
        want = np.asarray(jcommon.resize_nearest(jnp.asarray(x), s))
        np.testing.assert_array_equal(nhwc(common.resize_nearest(nchw(x), s)), want)


def test_max_pool_matches_jax():
    x = np.random.RandomState(3).randn(2, 8, 9, 4).astype(np.float32)
    for args in ((3, 2, 1), ((2, 2), (2, 1), (0, 1))):
        want = np.asarray(jcommon.max_pool(jnp.asarray(x), *args))
        np.testing.assert_array_equal(nhwc(common.max_pool(nchw(x), *args)), want)


def test_db_head_matches_jax_eval_and_train():
    """Covers the deconv kernel flip of the bridge."""
    x = np.maximum(np.random.RandomState(6).randn(2, 8, 8, 32), 0).astype(np.float32)
    jmod, tmod = JDBHead(in_channels=32), DBHead(32)
    variables, apply = init_pair(jmod, tmod, x)
    got = tmod(nchw(x))["maps"].detach().numpy()
    assert got.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, np.asarray(apply(variables, x)["maps"]), **DEEP)
    want_train, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got_train = tmod.train()(nchw(x))["maps"].detach().numpy()
    assert got_train.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got_train, np.asarray(want_train["maps"]), **DEEP)


DB_ARCH = {
    "model_type": "det",
    "algorithm": "DB",
    "Transform": None,
    "Backbone": {"name": "ResNet", "layers": 18},
    "Neck": {"name": "FPN", "out_channels": 32, "mode": "DB"},
    "Head": {"name": "DBHead", "k": 50},
    "return_all_feats": True,
}


@pytest.fixture(scope="module")
def db_outputs():
    """DB-ResNet18 + FPN(32) + DBHead on a 64x64 input, every stage's output
    from one JAX compile: (port, jax) dicts of NHWC numpy arrays."""
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    tmod = build_model(DB_ARCH)
    variables, apply = init_pair(jax_build_model(DB_ARCH), tmod, x)
    got, want = tmod(nchw(x)), apply(variables, x)

    def flat(y, conv):
        out = {"C%d" % (i + 2): conv(f) for i, f in enumerate(y["backbone_out"])}
        out["neck"] = conv(y["neck_out"])
        out["maps"] = np.asarray(y["maps"]) if conv is np.asarray else y["maps"].detach().numpy()
        return out

    return flat(got, nhwc), flat(want, np.asarray)


@pytest.mark.parametrize("stage", ["C2", "C3", "C4", "C5", "neck", "maps"])
def test_db_resnet18_fpn_head_match_jax(db_outputs, stage):
    """ResNet-18 feature maps, the FPN (DB mode, 32 channels) and the whole
    DB BaseModel's prob map."""
    got, want = db_outputs
    assert got[stage].shape == want[stage].shape
    np.testing.assert_allclose(got[stage], want[stage], **DEEP)


def test_vgg_v1_matches_jax():
    x = np.random.RandomState(8).randn(2, 32, 64, 1).astype(np.float32)
    tmod = VGG(1, "v1", 0.5)
    variables, apply = init_pair(JVGG(in_channels=1, model_name="v1", scale=0.5), tmod, x)
    got, want = nhwc(tmod(nchw(x))), np.asarray(apply(variables, x))
    assert got.shape == want.shape == (2, 1, 17, 512)
    np.testing.assert_allclose(got, want, **DEEP)


def test_sequence_encoder_and_ctc_head_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(3, 1, 20, 48).astype(np.float32)
    jenc, tenc = JSeqEnc(in_channels=48, encoder_type="rnn", hidden_size=32), \
        SequenceEncoder(48, "rnn", 32)
    variables, apply = init_pair(jenc, tenc, x)
    seq = apply(variables, x)
    got = tenc(nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(seq), atol=1e-5, rtol=1e-5)

    jhead, thead = JCTCHead(in_channels=64, out_channels=37), CTCHead(64, 37)
    hv, happly = init_pair(jhead, thead, np.asarray(seq))
    want = np.asarray(happly(hv, seq))
    got = thead(torch.from_numpy(np.array(seq))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_ctc_greedy_collapse_matches_jax():
    rng = np.random.RandomState(10)
    n, t, c = 6, 40, 12
    codes = rng.randint(0, c, (n, t))
    codes[:, 5:9] = codes[:, 5:6]  # repeats
    codes[0] = 0  # an all-blank row
    logits = rng.randn(n, t, c).astype(np.float32)
    logits[np.arange(n)[:, None], np.arange(t)[None], codes] += 4.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for max_len in (40, 8):
        want = jax_collapse(jnp.asarray(probs), max_len=max_len)
        got = ctc_greedy_collapse(torch.from_numpy(probs), max_len=max_len)
        (codes, lengths, conf), (jcodes, jlengths, jconf) = got, want
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
        # the kept-step sums are taken in another order: last-bit differences
        np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-6)


def test_bridge_rejects_mismatched_trees():
    tmod = common.ConvBNAct(3, 8, 3)
    jmod = jcommon.ConvBNAct(8, 3)
    variables = jax.device_get(dict(jmod.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8, 8, 3)), train=True)))
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros(1)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        flax_to_state_dict(tmod, extra)
    missing = {"params": {"conv": variables["params"]["conv"]},
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="bn"):
        flax_to_state_dict(tmod, missing)


@pytest.mark.parametrize("section,name,item", [
    ("Backbone", "ConvNeXt", None), ("Backbone", "SwinTransformer", None),
    ("Head", "NoSuchHead", "unknown"),
])
def test_registry_names_the_roadmap_item(section, name, item):
    """An unknown name raises naming what the port supports; ConvNeXt and
    SwinTransformer, which raised naming ROADMAP.md A.11, build, and so does
    AttnLabelDecode."""
    arch = dict(DB_ARCH, **{section: {"name": name}})
    if item is None:
        assert type(build_model(arch).backbone).__name__ == name
    else:
        with pytest.raises(NotImplementedError, match=item):
            build_model(arch)
    assert type(build_post_process({"name": "AttnLabelDecode"})).__name__ == "AttnLabelDecode"
