"""Reductions across ranks with their gradients: the global sum, min and max
over the "data" group, the tensor-parallel pair over the "model" group, and
the gradient and loss averages of the train step.

The JAX train step is one jitted function over the global batch
(trainer.py:137): BatchNorm's statistics and the DB and table losses' sums
are over the whole batch, not over a device's shard. A rank here holds its
shard only, so those sums go through `all_sum` (and the OHEM range through
`global_min` / `global_max`). Without a mesh, or with one rank in the data
group, each is the local operation itself: one process computes what it
computed before.

The backward rule. Every rank runs backward on its own loss l_r; the step
then averages the gradients over the data group (`average_gradients`).
For that average to be the gradient of (1/N) sum_r l_r, rank r's backward
must produce d(sum_q l_q)/d(its inputs). A global sum S = sum_r s_r feeds
every rank's loss, so d(sum_q l_q)/ds_r = sum_q dl_q/dS: the backward
all-reduces (sums) the gradient that arrives at S, then passes it to s_r.
The global min and max do the same, then split the sum evenly among the
elements, on every rank, that equal the extreme (as torch's amin and JAX's
min split it among ties). A loss that is a global function of the batch
(DB's) is the same l on every rank, so the average is its gradient; a
per-sample mean (CTC) has the global mean as its average over equal
shards; a sum of the two, each part. torch.distributed.nn.functional's
all_reduce has this backward too; these take the mesh's groups and skip the
collective at one rank.

The model group splits CTCHead's projection by columns (parallel/
shardings.py): `copy_to_model` before it (identity forward; backward sums
the input gradient over the model group, so every rank of the row has the
whole gradient of the features) and `gather_from_model` after it (each
rank's columns put into a zero tensor of the full width and summed over the
group, exact, as gloo on CUDA tensors has all-reduce but no all-gather;
backward takes the rank's columns of the gradient).
"""

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .mesh import get_mesh

__all__ = ["all_sum", "average_gradients", "average_losses", "copy_to_model", "data_world",
           "gather_from_model", "global_max", "global_min"]


def _data_group():
    mesh = get_mesh()
    if mesh is None or mesh.data_world == 1:
        return None
    return mesh.data_group


def data_world():
    mesh = get_mesh()
    return 1 if mesh is None else mesh.data_world


def _reduced(x, group, op=dist.ReduceOp.SUM):
    y = x.detach().reshape(-1).clone()
    dist.all_reduce(y, op=op, group=group)
    return y.reshape(x.shape)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.group), None


def all_sum(x):
    """The sum of `x` over the data group (the identity at one rank)."""
    group = _data_group()
    if group is None:
        return x
    if not x.requires_grad:
        return _reduced(x, group)
    return _AllSum.apply(x, group)


class _GlobalExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, largest, group):
        local = values.amax() if largest else values.amin()
        y = _reduced(local, group, dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN)
        ties = values == y
        ctx.group = group
        ctx.save_for_backward(ties, _reduced(ties.sum().to(values.dtype), group))
        return y

    @staticmethod
    def backward(ctx, grad):
        ties, count = ctx.saved_tensors
        share = _reduced(grad, ctx.group) / count
        return torch.where(ties, share, torch.zeros((), dtype=share.dtype,
                                                    device=share.device)), None, None


def global_min(values):
    """The least element of `values` over every rank's `values` (a 0-dim
    tensor); `values.amin()` at one rank."""
    group = _data_group()
    if group is None:
        return values.amin()
    return _GlobalExtreme.apply(values, False, group)


def global_max(values):
    group = _data_group()
    if group is None:
        return values.amax()
    return _GlobalExtreme.apply(values, True, group)


def _model_group():
    mesh = get_mesh()
    if mesh is None or mesh.model_world == 1:
        return None, 0, 1
    return mesh.model_group, mesh.model_rank, mesh.model_world


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.group), None


def copy_to_model(x):
    group = _model_group()[0]
    return x if group is None else _CopyToModel.apply(x, group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, world):
        ctx.rank, ctx.width = rank, x.shape[-1]
        full = x.new_zeros(x.shape[:-1] + (x.shape[-1] * world,))
        full[..., rank * ctx.width:(rank + 1) * ctx.width] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None, None, None


def gather_from_model(x):
    """The model group's column slices of the last axis, in rank order, as
    one tensor on every rank of the group."""
    group, rank, world = _model_group()
    return x if group is None else _GatherFromModel.apply(x, group, rank, world)


def average_gradients(params):
    """Average the gradients of `params` (those that have one) over the
    data group, in one all-reduce of their flattened concatenation. Under a
    model group, the leaves replicated across it (all but the split ones,
    marked `model_parallel`) are averaged over every rank instead: the
    ranks of a row compute them from the same batch, but cuDNN's weight
    gradients and CUDA's CTC backward are not bit-for-bit deterministic, and
    the average keeps the replicas equal, as JAX's one SPMD gradient does.
    Runs whenever a mesh is up, one rank included (a sum of one and a
    division by 1 are exact), so a one-rank group exercises the
    collective."""
    mesh = get_mesh()
    if mesh is None:
        return
    with_grad = [p for p in params if p.grad is not None]
    split = [p.grad for p in with_grad if getattr(p, "model_parallel", False)]
    replicated = [p.grad for p in with_grad if not getattr(p, "model_parallel", False)]
    for grads, group, n in ((replicated, None, mesh.world),
                            (split, mesh.data_group, mesh.data_world)):
        if not grads or (n == 1 and mesh.world > 1):
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat /= n
        for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(avg)


def average_losses(losses):
    """The loss dict's values averaged over the data group: the global
    batch's loss, which a global loss has on every rank already and a
    per-sample mean takes from the shards' means."""
    group = _data_group()
    if group is None or not losses:
        return losses
    keys = list(losses)
    stacked = torch.stack([losses[k].detach() for k in keys])
    dist.all_reduce(stacked, group=group)
    stacked /= data_world()
    return {k: stacked[i] for i, k in enumerate(keys)}
