"""chip_smoke.py's float32-against-float64 train-step reference
(`chip_smoke.Branches`), on the CPU at small sizes: a forward or loss that
replays the pieces of the piecewise-linear functions and the comparisons
recorded in another run takes exactly those pieces. Replaying a run's own
record gives that run bit for bit (same values, same strides, so the convs
after a replayed relu round as before); a flipped record moves the
gradients and its elements are counted. Exact comparisons throughout."""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from pytorchocr_tpu_torch.losses.det_db_loss import DBLoss
from pytorchocr_tpu_torch.modeling import build_model
from pytorchocr_tpu_torch.tools.train import seeded_init_
from pytorchocr_tpu_torch.utils.seeded import perturbed_tps_

ARCHS = {
    # MobileNetV3 small x0.35 (relu, hard_swish and hard_sigmoid through relu6)
    "cls": ({"model_type": "cls", "algorithm": "CLS", "Transform": None,
             "Backbone": {"name": "MobileNetV3", "model_name": "small"},
             "Neck": None, "Head": {"name": "ClsHead", "class_dim": 2}}, (2, 3, 24, 96)),
    # VGG x0.5 + BiLSTM (relu, max_pool2d)
    "rec": ({"model_type": "rec", "algorithm": "CRNN", "Transform": None,
             "Backbone": {"name": "VGG", "scale": 0.5},
             "Neck": {"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 16},
             "Head": {"name": "CTCHead", "out_channels": 10}}, (2, 3, 32, 64)),
    # STAR-Net: TPS small off RARE's init (relu, max_pool2d, the sampler's floor)
    "starnet": ({"model_type": "rec", "algorithm": "STARNet", "in_channels": 1,
                 "Transform": {"name": "TPS", "num_fiducial": 20, "model_name": "small"},
                 "Backbone": {"name": "VGG", "scale": 0.5},
                 "Neck": {"name": "SequenceEncoder", "encoder_type": "rnn", "hidden_size": 16},
                 "Head": {"name": "CTCHead", "out_channels": 10}}, (2, 1, 32, 64)),
}


def _model(arch, dtype):
    model = build_model(copy.deepcopy(arch))
    seeded_init_(model, torch.Generator().manual_seed(0))
    if arch.get("Transform"):  # RARE's init gives the localization net no gradient
        perturbed_tps_(model, torch.Generator().manual_seed(1))
    return model.to(dtype).train()


def _grads(model, x):
    out = model(x)
    (out.double() ** 2).sum().backward()
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_forward_replay_takes_the_recorded_pieces(kind):
    arch, shape = ARCHS[kind]
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
    branches = chip_smoke.Branches()
    g32 = _grads(branches.wrap(_model(arch, torch.float32), replay=False), x)
    names = {name for name, _ in branches.records["model"]}
    want = {"cls": {"relu", "relu6"}, "rec": {"relu", "max_pool2d"},
            "starnet": {"relu", "max_pool2d", "floor"}}[kind]
    assert names >= want, names
    # the run's own record: bit for bit, no element counted
    assert all(torch.equal(g32[k], g) for k, g in _grads(
        branches.wrap(_model(arch, torch.float32), replay=True), x).items())
    assert set(branches.flips.values()) == {0}, branches.flips

    # float64 replaying its own record equals the plain float64 run
    x64 = x.double()
    plain = _grads(_model(arch, torch.float64), x64)
    b64 = chip_smoke.Branches()
    _grads(b64.wrap(_model(arch, torch.float64), replay=False), x64)
    replayed = _grads(b64.wrap(_model(arch, torch.float64), replay=True), x64)
    assert all(torch.equal(plain[k], g) for k, g in replayed.items())

    # the first activation's record turned over (relu's or hard_swish's
    # relu6: every element to another piece): each element counted, and the
    # gradients no longer the plain run's
    name, piece = b64.records["model"][0]
    assert name in ("relu", "relu6")
    b64.records["model"][0] = (name, (piece == 0).to(torch.uint8))
    b64.flips = {}
    moved = _grads(b64.wrap(_model(arch, torch.float64), replay=True), x64)
    assert b64.flips[name] >= piece.numel()
    assert max(float((plain[k] - g).abs().max()) for k, g in moved.items()) > 1e-3


def test_sampler_floor_replay_takes_the_recorded_corners():
    """The TPS sampler's floor, recorded on one run and replayed on another:
    a record moved by one on every element (the other corners, as a
    coordinate within rounding of an integer can take on another device)
    is counted element by element and moves the transform's gradients."""
    arch, shape = ARCHS["starnet"]
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape)).double()
    plain = _grads(_model(arch, torch.float64), x)
    branches = chip_smoke.Branches()
    _grads(branches.wrap(_model(arch, torch.float64), replay=False), x)
    floors = [i for i, (name, _) in enumerate(branches.records["model"]) if name == "floor"]
    assert len(floors) == 2  # x and y of the one sampling grid
    i = floors[0]
    name, value = branches.records["model"][i]
    branches.records["model"][i] = (name, value + 1)
    moved = _grads(branches.wrap(_model(arch, torch.float64), replay=True), x)
    assert branches.flips["floor"] == value.numel()
    assert max(float((plain[k] - moved[k]).abs().max()) for k in plain
               if k.startswith("transform.")) > 1e-6


def test_db_loss_replay_takes_the_recorded_cut_sign_and_clamp():
    """DBLoss's OHEM bisection (comparisons), its L1's sign (abs) and its
    BCE's clamp: a float32 record replayed in float32 gives the loss and its
    gradient bit for bit; replayed in float64 it keeps the recorded
    selection, which the plain float64 loss may not."""
    rng = np.random.RandomState(3)
    n, h, w = 2, 32, 32
    logits = rng.randn(n, h, w, 3).astype(np.float32)
    shrink = (rng.rand(n, h, w) > 0.7).astype(np.float32)
    labels = (None, torch.from_numpy(rng.rand(n, h, w).astype(np.float32) * 0.4 + 0.3),
              torch.from_numpy((rng.rand(n, h, w) > 0.5).astype(np.float32)),
              torch.from_numpy(shrink), torch.ones(n, h, w))

    def run(loss, dtype):
        maps = torch.from_numpy(logits).to(dtype).requires_grad_()
        out = loss({"maps": torch.sigmoid(maps)}, tuple(
            t if t is None else t.to(dtype) for t in labels))
        out["loss"].backward()
        return float(out["loss"].detach()), maps.grad

    branches = chip_smoke.Branches()
    value, grad = run(branches.wrap_loss(DBLoss(), replay=False), torch.float32)
    assert {name for name, _ in branches.records["loss"]} == {"abs", "clamp", "comparison"}
    again, grad_again = run(branches.wrap_loss(DBLoss(), replay=True), torch.float32)
    assert again == value and torch.equal(grad_again, grad)
    assert set(branches.flips.values()) == {0}, branches.flips
    branches.flips = {}
    v64, g64 = run(branches.wrap_loss(DBLoss(), replay=True), torch.float64)
    assert abs(v64 - value) <= 1e-5 * abs(value)
    assert float((g64 - grad.double()).abs().max()) <= 1e-5 * float(g64.abs().max())


def test_in_place_pieces_are_refused():
    branches = chip_smoke.Branches()
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 3), torch.nn.ReLU(inplace=True))
    branches.wrap(model, replay=False)
    with pytest.raises(NotImplementedError, match="in-place relu"):
        model(torch.zeros(1, 1, 5, 5))


TABLE = {"model_type": "table", "algorithm": "SLANet", "Transform": None,
         "Backbone": {"name": "PPLCNet", "scale": 0.5},
         "Neck": {"name": "CSPPAN", "out_channels": 24, "mode": "table"},
         "Head": {"name": "SLAHead", "hidden_size": 32, "max_text_length": 6, "loc_reg_num": 8,
                  "out_channels": 12, "scheduled_sampling_p": 0.5, "aux_count": True}}


def test_table_replay_takes_the_recorded_pieces_coins_and_tokens():
    """SLANet with scheduled sampling (PPLCNet's hardswish, CSPPAN's leaky
    relu, SLAHead's coins and fed-back argmax): its own record replayed with
    another generator's coins gives the recorded run bit for bit (the coins
    and tokens are the record's, the other draws uncounted); a fed-back
    token turned over is counted and moves the gradients."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32))
    tokens = torch.from_numpy(np.random.RandomState(5).randint(1, 11, (2, 8)))

    def grads(branches, replay, seed, dtype=torch.float32):
        model = branches.wrap(_model(TABLE, dtype), replay=replay)
        out = model(x.to(dtype), data=[None, tokens],
                    generator=torch.Generator().manual_seed(seed))
        (out["structure_probs"].double() ** 2).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}

    branches = chip_smoke.Branches()
    g = grads(branches, False, 0)
    names = {name for name, _ in branches.records["model"]}
    assert names >= {"relu", "relu6", "leaky_relu", "argmax", "rand"}, names
    again = grads(branches, True, 1)  # other coins drawn, the record's replayed
    assert all(torch.equal(g[k], v) for k, v in again.items())
    assert set(branches.flips.values()) == {0}, branches.flips
    plain_other = grads(chip_smoke.Branches(), False, 1)
    assert any(not torch.equal(g[k], v) for k, v in plain_other.items())

    i = [j for j, (name, _) in enumerate(branches.records["model"]) if name == "argmax"][0]
    name, value = branches.records["model"][i]
    branches.records["model"][i] = (name, (value + 1) % 12)
    branches.flips = {}
    moved = grads(branches, True, 0)
    assert branches.flips["argmax"] == value.numel()
    assert max(float((g[k] - v).abs().max()) for k, v in moved.items()) > 0
