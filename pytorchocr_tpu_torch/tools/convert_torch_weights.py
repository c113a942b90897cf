"""Convert a torchvision ResNet ImageNet checkpoint (.pth) into a state_dict
of the port's detection ResNet backbone (.pt) — the port's counterpart of
tools/convert_torch_weights.py, whose key map (`resnet_key_map`, :27-56)
this copies: torchvision's `conv1` / `bn1` become the 7x7 stem, and
`layer{s}.{i}.conv{c}` / `bn{c}` / `downsample.{0,1}` become
`layer{s}_block{i}/conv{c}` / `downsample`. torchvision's convolutions are
already OIHW, so no tensor is transposed; `fc` is left out; each converted
BN's `num_batches_tracked` is 0, as the weight bridge sets it. A key the
checkpoint lacks, or whose shape differs, keeps the backbone's init, as in
the JAX `apply_mapping`.

The .pt is what `Architecture.Backbone.{pretrained: true, ckpt_path: <.pt>}`
loads into the backbone (utils/save_load.load_backbone_pretrained):

  python -m pytorchocr_tpu_torch.tools.convert_torch_weights --arch resnet18 \\
      --pth resnet18-5c106cde.pth --out ./model_zoo/resnet18_imagenet.pt
"""

import argparse
import os

import torch

from ..modeling.backbones.det_resnet import _SPECS, ResNet

__all__ = ["resnet_key_map", "convert_resnet_state"]


def resnet_key_map(layers):
    """{port backbone state_dict key: torchvision key} of the detection
    ResNet with the 7x7 stem. Every block gets a downsample entry; blocks
    without one drop it (`convert_resnet_state`)."""
    block_type, counts = _SPECS[layers]
    n_convs = 2 if block_type == "basic" else 3
    mapping = {}

    def add(port, tv_conv, tv_bn):
        mapping[port + ".conv.weight"] = tv_conv + ".weight"
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            mapping["%s.bn.%s" % (port, leaf)] = "%s.%s" % (tv_bn, leaf)

    add("stem", "conv1", "bn1")
    for s in range(4):
        for i in range(counts[s]):
            port = "layer%d_block%d" % (s + 1, i)
            tv = "layer%d.%d" % (s + 1, i)
            for c in range(1, n_convs + 1):
                add("%s.conv%d" % (port, c), "%s.conv%d" % (tv, c), "%s.bn%d" % (tv, c))
            add(port + ".downsample", tv + ".downsample.0", tv + ".downsample.1")
    return mapping


def convert_resnet_state(state_dict, layers, log=print):
    """The backbone entries of a torchvision ResNet `state_dict` (name ->
    tensor), as float32 tensors under the port's names."""
    target = ResNet(layers=layers).state_dict()
    out = {}
    for port, tv in resnet_key_map(layers).items():
        if port not in target or tv not in state_dict:
            continue
        value = torch.as_tensor(state_dict[tv])
        if tuple(value.shape) != tuple(target[port].shape):
            log("shape mismatch at %s: %s vs %s" % (port, tuple(target[port].shape),
                                                    tuple(value.shape)))
            continue
        out[port] = value.detach().to(torch.float32).clone()
        if port.endswith(".bn.running_var"):
            out[port[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    log("converted %d tensors" % sum(not k.endswith("num_batches_tracked") for k in out))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", required=True,
                        help="resnet18 | resnet34 | resnet50 | resnet101 | resnet152")
    parser.add_argument("--pth", required=True, help="the torchvision checkpoint")
    parser.add_argument("--out", required=True, help="the .pt state_dict to write")
    args = parser.parse_args(argv)
    if not args.arch.startswith("resnet") or not args.arch[6:].isdigit() \
            or int(args.arch[6:]) not in _SPECS:
        raise SystemExit("unsupported arch %s" % args.arch)
    state = torch.load(args.pth, map_location="cpu", weights_only=True)
    out = convert_resnet_state(state, int(args.arch[6:]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(out, args.out)
    print("saved converted weights to", args.out)


if __name__ == "__main__":
    main()
