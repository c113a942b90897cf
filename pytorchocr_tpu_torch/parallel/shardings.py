"""Parameter sharding over the "model" group — port of
pytorchocr_tpu/parallel/shardings.py (`DEFAULT_TP_RULES` :18,
`param_shardings` :24, `shard_params` :49).

The one weight-heavy matmul of the model family is the CTC head's
projection (hidden x 6,624 classes for `rec_vgg_bilstm_ctc.yml`); the JAX
rules shard its kernel and bias over the vocabulary and replicate the rest.
A rule matches a parameter whose dotted name holds its needle; the leaf is
split along `dim` (torch's Linear weight is (out, in), so the vocabulary is
dim 0 of both) where that size divides the model group, and replicated
otherwise (:34-41): the 37 classes of the synth CTC head replicate, the
6,624 split.

`shard_params` puts a `ColumnParallelLinear` in place of each split Linear:
it keeps this rank's rows of the weight and bias, computes its columns of
the logits and gathers the full width (parallel/functional.py), so the CTC
loss sees the full logits. Build the optimizer after it, from the model's
parameters: its moments then take the shards' shapes, as the JAX recipe
inits optax from the sharded params (:9-11). As in the JAX package, tensor
parallelism has no command-line switch.
"""

import torch.nn.functional as F
from torch import nn

from . import functional
from .mesh import get_mesh

__all__ = ["ColumnParallelLinear", "DEFAULT_TP_RULES", "param_shardings", "shard_params"]

# (name needle, dim): first match wins
DEFAULT_TP_RULES = (
    ("head.fc.weight", 0),  # vocab-dim sharded projection
    ("head.fc.bias", 0),
)


def param_shardings(model, model_world, rules=DEFAULT_TP_RULES):
    """{parameter name: the dim it is split along, or None (replicated)}."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = None
        for needle, dim in rules:
            if needle in name and p.dim() > dim and p.shape[dim] % model_world == 0:
                out[name] = dim
                break
    return out


class ColumnParallelLinear(nn.Module):
    """This rank's rows of a Linear's weight and bias (its output columns),
    the full output gathered over the model group."""

    def __init__(self, linear, rank, world):
        super().__init__()
        width = linear.out_features // world
        rows = slice(rank * width, (rank + 1) * width)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone())
        self.bias = (None if linear.bias is None
                     else nn.Parameter(linear.bias.detach()[rows].clone()))
        for p in self.parameters():
            p.model_parallel = True  # averaged over the data group only

    def forward(self, x):
        y = F.linear(functional.copy_to_model(x), self.weight, self.bias)
        return functional.gather_from_model(y)


def shard_params(model, rules=DEFAULT_TP_RULES):
    """Split the Linears whose weight the rules shard over this rank's
    model group (nothing without a mesh or at model_parallel 1); returns
    the names of the split parameters."""
    mesh = get_mesh()
    if mesh is None or mesh.model_world == 1:
        return []
    split = {k for k, dim in param_shardings(model, mesh.model_world, rules).items()
             if dim == 0}
    done = []
    for name, module in list(model.named_modules()):
        if isinstance(module, nn.Linear) and name + ".weight" in split:
            parent_name, _, child = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, child, ColumnParallelLinear(module, mesh.model_rank,
                                                        mesh.model_world))
            done += [name + ".weight"] + ([name + ".bias"] if module.bias is not None else [])
    return done
