"""RepVGG detection backbone and its deploy fold — port of
pytorchocr_tpu/modeling/backbones/det_repvgg.py:24-212.

Train form: each block sums a 3x3 conv + BN (`dense`), a 1x1 conv + BN
(`one`) and, where the input and output widths agree at stride 1, a BN of
the input (`idbn`); an optional squeeze-excitation (`se`); relu. Deploy form
(`deploy=True`): one 3x3 conv with a bias (`reparam`) in place of the three
branches. `reparameterize_state_dict` folds a train-form model's weights
into the deploy form's state_dict, as the JAX `reparameterize_params` folds
its params (BN into the 3x3 kernel, the 1x1 padded to 3x3, the identity BN
as an identity kernel, `o % in_dim` for grouped convs). NCHW.

int8 PTQ (ops/quant.py): in train form the `dense` and `one` ConvBNActs
run int8, grouped where `groups_map` says so (JAX :96-101), each on its
own float input; `idbn` and the SE stay float. The deploy form's `reparam`
is a plain conv in JAX (:89-93) and stays float, so an int8 RepVGG in
deploy form is a float backbone under an int8 FPN and head.
"""

import torch
from torch import nn

from ..common import BatchNorm2d, ConvBNAct

__all__ = ["RepVGG", "RepVGGBlock", "reparameterize_state_dict"]

_OPTIONAL_GROUPWISE = [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26]


def _model_conf(model_name):
    """(num_blocks, width multipliers, {layer index: groups}, use_se);
    det_repvgg.py:24."""
    g2 = {layer: 2 for layer in _OPTIONAL_GROUPWISE}
    g4 = {layer: 4 for layer in _OPTIONAL_GROUPWISE}
    if "A" in model_name:
        num_blocks = [2, 4, 14, 1]
    elif "B" in model_name:
        num_blocks = [4, 6, 16, 1]
    elif "D" in model_name:
        num_blocks = [8, 14, 24, 1]
    else:
        raise ValueError(model_name)
    groups_map, use_se = {}, False
    if model_name == "A0":
        wm = [0.75, 0.75, 0.75, 2.5]
    elif model_name == "A1":
        wm = [1, 1, 1, 2.5]
    elif model_name == "A2":
        wm = [1.5, 1.5, 1.5, 2.75]
    elif model_name == "B0":
        wm = [1, 1, 1, 2.5]
    elif "B1" in model_name:
        wm = [2, 2, 2, 4]
        groups_map = g2 if model_name == "B1g2" else g4 if model_name == "B1g4" else {}
    elif "B2" in model_name:
        wm = [2.5, 2.5, 2.5, 5]
        groups_map = g2 if model_name == "B2g2" else g4 if model_name == "B2g4" else {}
    elif "B3" in model_name:
        wm = [3, 3, 3, 5]
        groups_map = g2 if model_name == "B3g2" else g4 if model_name == "B3g4" else {}
    elif model_name == "D2se":
        wm = [2.5, 2.5, 2.5, 5]
        use_se = True
    else:
        raise ValueError(model_name)
    return num_blocks, wm, groups_map, use_se


class _SEBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.down = nn.Conv2d(channels, channels // 16, 1)
        self.up = nn.Conv2d(channels // 16, channels, 1)

    def forward(self, x):
        s = self.up(self.down(x.mean(dim=(2, 3), keepdim=True)).relu())
        return x * torch.sigmoid(s)


class RepVGGBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride=1, groups=1, use_se=False, deploy=False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.reparam = nn.Conv2d(in_ch, out_ch, 3, stride, padding=1, groups=groups,
                                     bias=True)
        else:
            self.dense = ConvBNAct(in_ch, out_ch, 3, stride, groups=groups, act=None)
            self.one = ConvBNAct(in_ch, out_ch, 1, stride, padding=0, groups=groups, act=None)
            self.idbn = (BatchNorm2d(in_ch, eps=1e-5, momentum=0.1)  # flax momentum 0.9
                         if in_ch == out_ch and stride == 1 else None)
        self.se = _SEBlock(out_ch) if use_se else None

    def forward(self, x):
        if self.deploy:
            out = self.reparam(x)
        else:
            out = self.dense(x) + self.one(x)
            if self.idbn is not None:
                out = out + self.idbn(x)
        if self.se is not None:
            out = self.se(out)
        return out.relu()


class RepVGG(nn.Module):
    int8_ported = True  # ops.quant.unsupported: its int8 regions are ported

    def __init__(self, in_channels=3, model_name="A0", use_se=False, deploy=False):
        super().__init__()
        num_blocks, wm, groups_map, conf_se = _model_conf(model_name)
        use_se = use_se or conf_se
        planes = [int(64 * wm[0]), int(128 * wm[1]), int(256 * wm[2]), int(512 * wm[3])]
        self.out_channels = planes
        inp = min(64, int(64 * wm[0]))
        self.stage0 = RepVGGBlock(in_channels, inp, 2, use_se=use_se, deploy=deploy)
        self.stage_names = []
        layer_idx = 1
        for si in range(4):
            names = []
            for i in range(num_blocks[si]):
                name = "stage%d_%d" % (si + 1, i)
                self.add_module(name, RepVGGBlock(inp, planes[si], 2 if i == 0 else 1,
                                                  groups=groups_map.get(layer_idx, 1),
                                                  use_se=use_se, deploy=deploy))
                names.append(name)
                inp = planes[si]
                layer_idx += 1
            self.stage_names.append(names)

    def forward(self, x):
        x = self.stage0(x)
        outs = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


def _fuse_conv_bn(kernel, bn):
    """A conv kernel (out, in/groups, kh, kw) and the BN after it -> the
    kernel and bias of the one conv that computes both (eval-mode BN)."""
    t = bn["weight"] / torch.sqrt(bn["running_var"] + bn["eps"])
    return kernel * t[:, None, None, None], bn["bias"] - bn["running_mean"] * t


@torch.no_grad()
def reparameterize_state_dict(model):
    """The state_dict of `model` (a train-form RepVGG or a model holding
    one) built with `deploy=True`: every RepVGGBlock's dense 3x3 + BN, 1x1 +
    BN padded to 3x3 and identity BN (an identity kernel, `o % in_dim` in a
    grouped conv) summed into one 3x3 kernel and bias (JAX
    det_repvgg.py:154-212), computed on the CPU in float64 and returned in
    it; the rest of the state_dict as it is. Load it with `load_state_dict`,
    which casts to the deploy model's dtype."""
    dtype = torch.float64
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def bn_of(prefix, module):
        state.pop(prefix + "num_batches_tracked", None)
        return {k: state.pop(prefix + k).to(dtype) for k in
                ("weight", "bias", "running_mean", "running_var")} | {"eps": module.eps}

    for name, block in model.named_modules():
        if not isinstance(block, RepVGGBlock) or block.deploy:
            continue
        p = name + "." if name else ""
        k3, b3 = _fuse_conv_bn(state.pop(p + "dense.conv.weight").to(dtype),
                               bn_of(p + "dense.bn.", block.dense.bn))
        k1, b1 = _fuse_conv_bn(state.pop(p + "one.conv.weight").to(dtype),
                               bn_of(p + "one.bn.", block.one.bn))
        kernel = k3 + torch.nn.functional.pad(k1, (1, 1, 1, 1))
        bias = b3 + b1
        if block.idbn is not None:
            out_dim, in_dim = k3.shape[:2]  # in_dim: input channels per group
            id_kernel = torch.zeros_like(k3)
            for o in range(out_dim):
                id_kernel[o, o % in_dim, 1, 1] = 1.0
            kid, bid = _fuse_conv_bn(id_kernel, bn_of(p + "idbn.", block.idbn))
            kernel, bias = kernel + kid, bias + bid
        state[p + "reparam.weight"] = kernel
        state[p + "reparam.bias"] = bias
    return state
