"""SLANet's modules in the port against the JAX package, on the CPU: the
table data ops (TableLabelEncode with merged / unmerged cells, empty cells,
colspans and the row / column counts, TableBoxEncode, ResizeTableImage,
PaddingTableImage), PubTabDataSet with its retry, PPLCNet, CSPPAN (table
mode, det mode with and without the ASF), the SLAHead decode (GRU and LSTM,
aux_count on and off) at eval and at train with scheduled sampling at p = 0
and p = 1, the share of fed-back steps at p = 0.25, SLALoss and its
gradient, TableLabelDecode and TableMetric, the weight bridge over the head,
the published table configs built, the seeded decisive head, and one
train -> eval CLI round on the CPU.

Small sizes: PPLCNet x0.5 on 64x64 inputs, CSPPAN 24, hidden 32,
max_text_length 8-12. Weights cross through the weight bridge (random
kernels, randomised biases and BN statistics: torch_port_util). Tolerances,
float32: data ops, the dataset, the decode's token sequences, the post
process and the metric exactly; a backbone or neck at DEEP (atol 2e-3, rtol
1e-3); the head's probabilities and boxes atol 1e-5, its train logits atol
1e-4; the loss rtol 1e-5 and its gradient atol 1e-6."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchocr_tpu.modeling.backbones.det_pplcnet import PPLCNet as JPPLCNet
from pytorchocr_tpu.modeling.heads.table_att_head import SLAHead as JSLAHead
from pytorchocr_tpu.modeling.necks.csp_pan import CSPPAN as JCSPPAN
from pytorchocr_tpu_torch.data import build_dataloader, create_operators, transform
from pytorchocr_tpu_torch.losses import build_loss
from pytorchocr_tpu_torch.metrics import build_metric
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.modeling.backbones.det_pplcnet import PPLCNet
from pytorchocr_tpu_torch.modeling.heads.table_att_head import SLAHead
from pytorchocr_tpu_torch.modeling.necks.csp_pan import CSPPAN
from pytorchocr_tpu_torch.postprocess import build_post_process
from pytorchocr_tpu_torch.trainer import sample_generator
from pytorchocr_tpu_torch.utils.config import load_config
from pytorchocr_tpu_torch.utils.logging import get_logger
from pytorchocr_tpu_torch.utils.seeded import decisive_sla_head_, seeded_init_
from pytorchocr_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_port_util import (DEEP, nchw, nhwc, shaped_pair, shaped_variables,
                             tiny_table_config, train_cli)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DICT = "pytorchocr_tpu/utils/table_structure_dict_ch.txt"
CPU = torch.device("cpu")
N_CLS = 50  # sos + 48 tokens (merged <td></td>) + eos
EOS = N_CLS - 1

# hand-written PubTabNet structures: a header row, colspans, a rowspan,
# cells without a box (empty), and one structure too long for max length 24
STRUCTURES = [
    (["<thead>", "<tr>", "<td>", "</td>", "<td", ' colspan="2"', ">", "</td>", "</tr>",
      "</thead>", "<tbody>", "<tr>", "<td>", "</td>", "<td>", "</td>", "<td>", "</td>",
      "</tr>", "</tbody>"], [1, 1, 1, 0, 1]),
    (["<tbody>", "<tr>", "<td", ' rowspan="2"', ">", "</td>", "<td>", "</td>", "</tr>",
      "<tr>", "<td>", "</td>", "</tr>", "</tbody>"], [1, 0, 1]),
    (["<tbody>", "<tr>", "<td", ' colspan="3"', ">", "</td>", "</tr>", "<tr>", "<td>",
      "</td>", "<td>", "</td>", "<td>", "</td>", "</tr>", "</tbody>"], [0, 1, 1, 0]),
    (["<tbody>"] + ["<tr>", "<td>", "</td>", "<td>", "</td>", "</tr>"] * 8 + ["</tbody>"],
     [1] * 16),
]


def _cells(flags, rng):
    cells = []
    for has_box in flags:
        x0, y0 = rng.randint(0, 40, 2)
        x1, y1 = x0 + rng.randint(4, 20), y0 + rng.randint(4, 20)
        cell = {"tokens": ["a", "b"] if has_box else []}
        if has_box:
            cell["bbox"] = [int(v) for v in (x0, y0, x1, y0, x1, y1, x0, y1)]
        cells.append(cell)
    return cells


def _jax_ops(ops):
    from pytorchocr_tpu.data.imaug import create_operators as jcreate
    return jcreate(ops)


def _jax_transform(data, ops):
    from pytorchocr_tpu.data.imaug import transform as jtransform
    return jtransform(data, ops)


def _assert_same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray) or np.isscalar(want[k]):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("merge,replace,learn_empty", [
    (True, False, False), (False, False, True), (True, True, False),
])
def test_table_label_encode_matches_jax(merge, replace, learn_empty):
    """structure, bboxes, bbox_masks, row_cnt, col_cnt exactly; the over-long
    structure is dropped (None) by both."""
    op = [{"TableLabelEncode": {"max_text_length": 24, "character_dict_path": DICT,
                                "merge_no_span_structure": merge,
                                "replace_empty_cell_token": replace,
                                "learn_empty_box": learn_empty, "loc_reg_num": 8}}]
    mine, theirs = create_operators(op), _jax_ops(op)
    rng = np.random.RandomState(0)
    kept = 0
    for tokens, flags in STRUCTURES:
        cells = _cells(flags, rng)
        data = {"structure": list(tokens), "cells": copy.deepcopy(cells)}
        got = transform(copy.deepcopy(data), mine)
        want = _jax_transform(copy.deepcopy(data), theirs)
        _assert_same(got, want)
        kept += want is not None
    assert kept == 3


@pytest.mark.parametrize("fmt_in,fmt_out", [
    ("xyxyxyxy", "xyxyxyxy"), ("xyxy", "xywh"), ("xyxyxyxy", "xywh"),
])
def test_table_box_encode_matches_jax(fmt_in, fmt_out):
    rng = np.random.RandomState(1)
    width = 8 if fmt_in == "xyxyxyxy" else 4
    bboxes = rng.uniform(0, 300, (26, width)).astype(np.float32)
    shape = np.array([300, 200, 1.6, 1.6, 480, 320])
    op = [{"TableBoxEncode": {"in_box_format": fmt_in, "out_box_format": fmt_out}}]
    got = transform({"bboxes": bboxes.copy(), "shape": shape}, create_operators(op))
    want = _jax_transform({"bboxes": bboxes.copy(), "shape": shape}, _jax_ops(op))
    np.testing.assert_array_equal(got["bboxes"], want["bboxes"])
    assert got["bboxes"].dtype == want["bboxes"].dtype


@pytest.mark.parametrize("hw,padding", [((123, 77), True), ((60, 200), False), ((90, 90), True)])
def test_table_image_ops_match_jax(hw, padding):
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(np.uint8)
    ops = [{"ResizeTableImage": {"max_len": 96, "use_padding": padding}},
           {"PaddingTableImage": {"size": [128, 128]}}]
    for chain in (ops[:1], ops):
        got = transform({"image": img.copy()}, create_operators(chain))
        want = _jax_transform({"image": img.copy()}, _jax_ops(chain))
        _assert_same(got, want)


def _table_config(label_file, max_len=24, size=64, shuffle=False):
    transforms = [
        {"DecodeImage": {"img_mode": "RGB", "channel_first": False}},
        {"TableLabelEncode": {"learn_empty_box": False, "merge_no_span_structure": True,
                              "replace_empty_cell_token": False, "loc_reg_num": 8,
                              "max_text_length": max_len}},
        {"ResizeTableImage": {"max_len": size, "use_padding": True}},
        {"TableBoxEncode": {"in_box_format": "xyxyxyxy", "out_box_format": "xyxyxyxy"}},
        {"KeepKeys": {"keep_keys": ["image", "structure", "bboxes", "bbox_masks", "row_cnt",
                                    "col_cnt", "shape"]}},
    ]
    ds = {"name": "PubTabDataSet", "label_file_list": [label_file], "transforms": transforms}
    return {"Global": {"distributed": False, "seed": 5, "character_dict_path": DICT,
                       "max_text_length": max_len},
            "Train": {"dataset": ds, "loader": {"shuffle": shuffle, "batch_size_per_card": 4,
                                                "drop_last": False, "num_workers": 1}},
            "Eval": {"dataset": copy.deepcopy(ds),
                     "loader": {"shuffle": False, "batch_size_per_card": 4,
                                "drop_last": False, "num_workers": 1}}}


def _hand_written_dataset(root):
    """The STRUCTURES as PubTabNet jsonl on drawn images, plus one line whose
    image is missing (the dataset's retry)."""
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(3)
    lines = []
    for i, (tokens, flags) in enumerate(STRUCTURES[:3] * 2):
        path = os.path.join(root, "t%d.png" % i)
        cv2.imwrite(path, rng.randint(0, 256, (70 + 9 * i, 90, 3)).astype(np.uint8))
        lines.append({"img_path": path, "html": {"cells": _cells(flags, rng),
                                                 "structure": {"tokens": tokens}}})
    lines.insert(2, {"img_path": os.path.join(root, "missing.png"),
                     "html": {"cells": [], "structure": {"tokens": ["<tr>"]}}})
    label = os.path.join(root, "label.jsonl")
    with open(label, "w") as f:
        f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return label


@pytest.mark.parametrize("which", ["synth", "hand"])
def test_pubtab_dataset_matches_jax(tmp_path, which):
    """Every sample of both modes exactly, with the seeded sample and shuffle
    order and the retry of the missing image (the next index at eval, a
    np.random index at train); then the loader's stacked batches."""
    import synth
    from pytorchocr_tpu.data.pubtab_dataset import PubTabDataSet as JPubTab

    from pytorchocr_tpu_torch.data import PubTabDataSet

    label = (synth.make_pubtab_dataset(str(tmp_path), n=6) if which == "synth"
             else _hand_written_dataset(str(tmp_path)))
    cfg = _table_config(label, shuffle=True)
    logger = get_logger()
    for mode in ("Train", "Eval"):
        mine = PubTabDataSet(cfg, mode, logger, seed=5)
        theirs = JPubTab(cfg, mode, logger, seed=5)
        assert mine.data_lines == theirs.data_lines
        for i in range(len(theirs)):
            np.random.seed(i)
            got = mine[i]
            np.random.seed(i)
            want = theirs[i]
            assert len(got) == len(want) == 7
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    batches = list(build_dataloader(cfg, "Eval", logger)[0])
    assert [b[0].shape[0] for b in batches] == ([4, 2] if which == "synth" else [4, 3])
    assert all(isinstance(x, np.ndarray) and x.dtype != object for x in batches[0])


def test_pplcnet_matches_jax():
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    tmod = PPLCNet(scale=0.5)
    variables, japply = shaped_pair(JPPLCNet(scale=0.5), tmod, x)
    want = japply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(nchw(x))
    assert tmod.out_channels == list(JPPLCNet(scale=0.5).out_channels)
    assert [tuple(g.shape) for g in got] == [(2, c, 64 // s, 64 // s) for c, s in
                                              zip((32, 64, 128, 256), (4, 8, 16, 32))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **DEEP)


@pytest.mark.parametrize("mode,asf", [("table", False), ("det", False), ("det", True)])
def test_csppan_matches_jax(mode, asf):
    chans = (32, 64, 128, 256)
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, 32 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(chans)]
    kw = dict(out_channels=24, mode=mode, use_asf=asf)
    tmod = CSPPAN(list(chans), **kw)
    variables, japply = shaped_pair(JCSPPAN(in_channels=chans, **kw), tmod, feats)
    want = np.asarray(japply(variables, [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = nhwc(tmod([nchw(f) for f in feats]))
    assert got.shape == want.shape == ((2, 4, 4, 24) if mode == "table" else (2, 32, 32, 96))
    assert tmod.fused_channels == want.shape[-1]
    np.testing.assert_allclose(got, want, **DEEP)


def _head_pair(use_gru=True, aux=False, p=0.0, max_len=12, seed=0):
    """A JAX and a port SLAHead (C 24, hidden 32, 50 classes) with the same
    random weights, and a (2, 24, 4, 5) feature map with its teacher tokens."""
    kw = dict(in_channels=24, hidden_size=32, out_channels=N_CLS, max_text_length=max_len,
              loc_reg_num=8, use_gru=use_gru, aux_count=aux, scheduled_sampling_p=p)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 4, 5, 24).astype(np.float32)
    structure = rng.randint(1, N_CLS - 1, (2, max_len + 2))
    structure[:, 0] = 0
    jmod, tmod = JSLAHead(**kw), SLAHead(**kw)
    variables = shaped_variables(jmod, x, seed, targets=[None, jnp.asarray(structure)])
    load_flax_variables(tmod, variables)
    return jmod, tmod, variables, x, structure


@pytest.mark.parametrize("use_gru,aux", [(True, False), (True, True), (False, False),
                                         (False, True)])
def test_slahead_eval_decode_matches_jax(use_gru, aux):
    """The greedy decode (every step, fed back): token sequences equal,
    probabilities and boxes atol 1e-5; no GRU bias beyond flax's."""
    jmod, tmod, variables, x, _ = _head_pair(use_gru, aux)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod.eval()
    with torch.no_grad():
        got = tmod(nchw(x))
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["structure_probs"].argmax(-1).numpy(),
                                  np.asarray(want["structure_probs"]).argmax(-1))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    biases = sorted(k for k in tmod.state_dict() if k.startswith("decode.rnn.") and "bias" in k)
    assert biases == (["decode.rnn.hn.bias", "decode.rnn.in.bias", "decode.rnn.ir.bias",
                       "decode.rnn.iz.bias"] if use_gru else
                      ["decode.rnn.h%s.bias" % g for g in "fgio"])


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_slahead_train_forward_matches_jax(p):
    """Teacher forcing (p = 0) and own predictions every step (p = 1: every
    coin is 1, in JAX and in the port): the train logits atol 1e-4. Without
    a generator the port feeds as p = 0, as JAX does without a sample rng."""
    jmod, tmod, variables, x, structure = _head_pair(True, True, p=p)
    targets = [None, jnp.asarray(structure)]
    want = jmod.apply(variables, jnp.asarray(x), targets=targets, train=True,
                      rngs={"sample": jax.random.PRNGKey(3)})
    tmod.train()
    tt = [None, torch.from_numpy(structure)]
    with torch.no_grad():
        got = tmod(nchw(x), targets=tt, generator=sample_generator(CPU, 0))
        plain = tmod(nchw(x), targets=tt)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    teacher = jmod.clone(scheduled_sampling_p=0.0).apply(variables, jnp.asarray(x),
                                                         targets=targets, train=True)
    np.testing.assert_allclose(plain["structure_probs"].numpy(),
                               np.asarray(teacher["structure_probs"]), atol=1e-4)


def test_scheduled_sampling_share_and_coins():
    """p = 0.25: the share of steps that feed the model's own prediction
    over 64 x 25 coins lies within 4.5 binomial standard deviations of 0.25
    (+-0.049); the same step's generator gives the same coins and logits,
    another step's others. The teacher tokens are a class the model never
    predicts (its logit biased far down), so a fed token tells the two
    apart."""
    torch.manual_seed(0)
    head = SLAHead(24, 32, N_CLS, max_text_length=24, loc_reg_num=8, scheduled_sampling_p=0.25)
    with torch.no_grad():
        head.decode.structure_fc2.bias[7] = -1e3
    head.train()
    x = torch.randn(64, 24, 4, 5)
    tokens = torch.full((64, 26), 7, dtype=torch.long)
    fed = []
    hook = head.decode.register_forward_pre_hook(lambda m, a: fed.append(a[1].argmax(1)))
    with torch.no_grad():
        out = [head(x, targets=[None, tokens], generator=sample_generator(CPU, s))
               for s in (4, 4, 5)]
    hook.remove()
    own = torch.stack(fed[:25], 1) != 7
    n = own.numel()
    bound = 4.5 * (0.25 * 0.75 / n) ** 0.5
    assert abs(float(own.float().mean()) - 0.25) < bound
    assert torch.equal(out[0]["structure_probs"], out[1]["structure_probs"])
    assert not torch.equal(out[0]["structure_probs"], out[2]["structure_probs"])


@pytest.mark.parametrize("cfg", [
    dict(loc_loss_type="mse"), dict(loc_loss_type="smooth_l1"),
    dict(loc_loss_type="smooth_l1", label_smoothing=0.1, aux_count_weight=1.0),
    dict(loc_loss_type="mse", label_smoothing=0.2, steps=6),
])
def test_sla_loss_and_gradient_match_jax(cfg):
    """Every term rtol 1e-5 and the gradient with respect to every
    prediction atol 1e-6, against jax.grad; `steps` 6 decode steps against
    12 + 1 target steps (the t = min alignment). The loc predictions and
    targets spread past 1 so smooth-L1 takes both pieces."""
    from pytorchocr_tpu.losses.table_att_loss import SLALoss as JSLALoss

    cfg = dict(cfg)
    steps = cfg.pop("steps", 13)
    rng = np.random.RandomState(2)
    n = 3
    preds = {"structure_probs": rng.randn(n, steps, N_CLS).astype(np.float32),
             "loc_preds": rng.uniform(0, 1, (n, steps, 8)).astype(np.float32),
             "row_logits": rng.randn(n, 32).astype(np.float32),
             "col_logits": rng.randn(n, 32).astype(np.float32)}
    batch = [None, rng.randint(0, N_CLS, (n, 14)),
             rng.uniform(-1, 2.5, (n, 14, 8)).astype(np.float32),
             (rng.rand(n, 14, 1) > 0.4).astype(np.float32),
             rng.randint(0, 32, n).astype(np.int32), rng.randint(0, 32, n).astype(np.int32)]
    args = dict(structure_weight=1.0, loc_weight=2.0, **cfg)
    jloss = JSLALoss(**args)
    jb = [None] + [jnp.asarray(b) for b in batch[1:]]
    want = jloss({k: jnp.asarray(v) for k, v in preds.items()}, jb)
    jgrad = jax.grad(lambda p: jloss(p, jb)["loss"])({k: jnp.asarray(v)
                                                       for k, v in preds.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in preds.items()}
    got = build_loss(dict(name="SLALoss", **args))(tp, [None] + [torch.from_numpy(b)
                                                                 for b in batch[1:]])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    got["loss"].backward()
    for k in preds:
        if tp[k].grad is None:  # the aux logits without aux_count_weight
            assert k.endswith("_logits") and not np.asarray(jgrad[k]).any()
            continue
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrad[k]), atol=1e-6,
                                   err_msg=k)


def test_table_decode_and_metric_match_jax(tmp_path):
    """TableLabelDecode (structures, scores, boxes, decoded labels) and
    TableMetric with del_thead_tbody, with and without the bbox metric:
    equal on the same predictions over a dataset batch. Two predictions are
    the labels' own structures (acc strictly between 0 and 1)."""
    from pytorchocr_tpu.metrics import build_metric as jbuild_metric
    from pytorchocr_tpu.postprocess import build_post_process as jbuild_post

    label = _hand_written_dataset(str(tmp_path))
    cfg = _table_config(label)
    batch = next(iter(build_dataloader(cfg, "Eval", get_logger())[0]))
    n, t = batch[1].shape[0], 25
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(N_CLS) * 0.3, (n, t)).astype(np.float32)
    for i in (0, 2):  # the labels' own structures
        probs[i, np.arange(t), batch[1][i, 1:t + 1]] += 2.0
    preds = {"structure_probs": probs, "loc_preds": rng.rand(n, t, 8).astype(np.float32)}
    post_cfg = {"name": "TableLabelDecode", "merge_no_span_structure": True}
    mine = build_post_process(post_cfg, cfg["Global"])(
        {k: torch.from_numpy(v) for k, v in preds.items()}, batch)
    theirs = jbuild_post(post_cfg, cfg["Global"])(preds, batch)
    for got, want in zip(mine, theirs):
        assert got["structure_batch_list"] == want["structure_batch_list"]
        for a, b in zip(got["bbox_batch_list"], want["bbox_batch_list"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(mine[0]["bbox_batch_list"][0]) > 0
    for bbox in (False, True):
        metric_cfg = {"name": "TableMetric", "main_indicator": "acc", "box_format": "xyxyxyxy",
                      "compute_bbox_metric": bbox, "del_thead_tbody": True}
        m, j = build_metric(metric_cfg), jbuild_metric(metric_cfg)
        m(mine, batch)
        j(theirs, batch)
        got, want = m.get_metric(), j.get_metric()
        assert got == want
        assert 0 < want["acc"] < 1


def test_bridge_maps_slanet_and_raises_on_an_unused_leaf():
    """A JAX SLANet's variables (aux_count on and off) map with every leaf
    used; a flax leaf without a torch tensor (an nn.GRUCell-style hr bias)
    raises."""
    from pytorchocr_tpu.modeling import build_model as jbuild

    x = np.zeros((1, 64, 64, 3), np.float32)
    for aux in (False, True):
        arch = {"model_type": "table", "algorithm": "SLANet", "Transform": None,
                "Backbone": {"name": "PPLCNet", "scale": 0.5},
                "Neck": {"name": "CSPPAN", "out_channels": 24, "mode": "table"},
                "Head": {"name": "SLAHead", "hidden_size": 32, "max_text_length": 8,
                         "loc_reg_num": 8, "out_channels": N_CLS, "aux_count": aux}}
        variables = shaped_variables(jbuild(arch), x)
        model = build_model(arch)
        sd = flax_to_state_dict(model, variables)
        assert set(sd) == set(model.state_dict())
        assert ("head.count_fc.weight" in sd) == aux
    bad = copy.deepcopy(variables)
    bad["params"]["head"]["decode"]["rnn"]["hr"]["bias"] = np.zeros(32, np.float32)
    with pytest.raises(KeyError, match="head/decode/rnn/hr/bias"):
        flax_to_state_dict(model, bad)


@pytest.mark.parametrize("name", ["table_sla_ch.yml", "table_sla_synth.yml"])
def test_published_table_configs_build(name):
    """Both table configs build at full width in the port (PPLCNet x1.0,
    CSPPAN 96, SLAHead 256 over the 50-class merged table)."""
    cfg = load_config(os.path.join(REPO, "configs", "table", name))
    post = build_post_process(cfg["PostProcess"], cfg["Global"])
    cfg["Architecture"]["Head"]["out_channels"] = len(post.character)
    model = build_model(cfg["Architecture"])
    assert len(post.character) == N_CLS
    assert model.neck.fused_channels == 96 and model.head.hidden_size == 256
    assert model.head.aux_count == (name == "table_sla_synth.yml")
    build_loss(cfg["Loss"])
    build_metric(cfg["Metric"])
    create_operators(cfg["Train"]["dataset"]["transforms"], cfg["Global"])


def test_decisive_sla_head_gives_long_decided_decodes():
    """Seeded weights with the decisive head: on 8 random 64x64 inputs at
    most a quarter of the tables reach eos within their first 8 steps, the
    eval decode (eos at the steps the helper reports) is at least 8 tokens
    long on most, the td tokens take the share the helper reports (at least
    a quarter of the steps, so the post process decodes boxes), and the
    top-2 gap of every step before eos is clear of rounding (> 1e-4)."""
    arch = {"model_type": "table", "algorithm": "SLANet", "Transform": None,
            "Backbone": {"name": "PPLCNet", "scale": 0.5},
            "Neck": {"name": "CSPPAN", "out_channels": 24, "mode": "table"},
            "Head": {"name": "SLAHead", "hidden_size": 32, "max_text_length": 24,
                     "loc_reg_num": 8, "out_channels": N_CLS}}
    post = build_post_process({"name": "TableLabelDecode", "merge_no_span_structure": True,
                               "character_dict_path": DICT})
    td = [post.dict[t] for t in post.td_token if t in post.dict]
    model = build_model(arch)
    seeded_init_(model, torch.Generator().manual_seed(0))
    x = torch.randn(8, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    first, share = decisive_sla_head_(model, x, EOS, boxes=td, min_tokens=8)
    model.eval()
    with torch.no_grad():
        preds = model(x)
    probs = preds["structure_probs"]
    tokens = probs.argmax(-1)
    got = [int((t[1:] == EOS).nonzero()[0]) + 1 if (t[1:] == EOS).any() else t.numel()
           for t in tokens]
    assert got == first
    assert sum(f >= 8 for f in first) >= 6
    assert share >= 0.25
    shape = np.tile(np.array([64, 64, 1.0, 1.0, 64, 64]), (8, 1))
    decoded = post({k: v for k, v in preds.items()}, [shape])
    assert sum(len(b) for b in decoded["bbox_batch_list"]) > 0
    top2 = probs.topk(2, dim=-1).values
    for i, f in enumerate(first):
        assert float((top2[i, :f, 0] - top2[i, :f, 1]).min()) > 1e-4


def test_train_then_eval_cli_from_best_accuracy(tmp_path):
    """`python -m pytorchocr_tpu_torch.tools.train` on a small
    table_sla_synth.yml (scheduled sampling at its published 0.25, aux_count;
    a subprocess that loads no module of jax, flax or the JAX package), then
    tools.eval on OUT/best_accuracy: the same acc and token_acc."""
    import synth

    from pytorchocr_tpu_torch.tools import eval as eval_cli

    label = synth.make_pubtab_dataset(str(tmp_path / "data"), n=4, size=64)
    cfg = tiny_table_config(tmp_path / "t.yml", label, tmp_path / "out")
    out = tmp_path / "cli_out"
    got = train_cli(cfg, "Global.save_model_dir=%s" % out)
    assert got["steps"] == 2
    metric = eval_cli.run(["-c", cfg, "-o", "Global.use_gpu=False",
                           "Global.checkpoints=%s" % (out / "best_accuracy")])
    for k in ("acc", "token_acc"):
        assert metric[k] == got["best"][k], k
