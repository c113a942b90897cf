"""Train and eval steps — port of pytorchocr_tpu/trainer.py
(`build_input_transform` :62, `_mask_frozen_updates` :110, `make_train_step`
:137, `make_eval_step` :301).

The JAX step is one jitted graph: forward in train mode, loss, backward,
optimizer update and BN statistics. Here it is the same sequence on an
`nn.Module`: train mode (the flax-statistics BN of modeling/common.py),
`torch.autocast(bfloat16)` around the forward when `use_amp` (the JAX bf16
policy), the model's outputs cast to float32 before the loss, `backward()`, and
`optimizer.step()` (optimizer.OptaxAdam, optax's arithmetic). A model
whose head takes a generator (SLAHead's scheduled sampling) gets one per
step, `sample_generator(device, step)`, as the JAX step hands the model
`fold_in(PRNGKey(17), state.step)` (trainer.py:159).

TF32: `set_matmul_precision` turns TF32 off for cuDNN convolutions and cuBLAS
matmuls, so float32 training computes in float32 as the CPU does; under
`use_amp` the convolutions and matmuls run in bf16 and the setting touches
only the float32 remainder.

Across ranks (parallel/mesh.py) the step is the JAX step on the global
batch: BN statistics and the DB / table losses' sums are global
(parallel/functional.py), the gradients are averaged over the data group
after backward (one all-reduce), and every rank applies the same update,
so the ranks' parameters stay bit-identical; the returned losses are the
global batch's. The model is not wrapped (no DistributedDataParallel): a
frozen teacher has no gradient to reduce, STAR-Net's freeze zeroes the
averaged gradients, and checkpoints carry the model's own names.

`remat` (Global.remat) recomputes the forward in the backward, as
`jax.checkpoint(forward)` does (trainer.py:173): torch.utils.checkpoint,
non-reentrant, over the autocast forward. jax.checkpoint recomputes a pure
function, so flax's `batch_stats` update happens once; here the forward has
two side effects that a recompute would repeat, and neither does: the BN
running statistics are updated by the first forward only
(modeling.common.recomputing skips the update inside the recompute; the
global BN all-reduce of a data-parallel step runs again there, on every rank
alike), and SLAHead's coins come from a generator made inside the
recomputed function from the same seed, so the recompute draws the coins
the forward drew (checkpoint's `preserve_rng_state` restores only the
default generators).

Not carried over (ROADMAP.md A.15): `make_multi_train_step` /
`steps_per_dispatch`, `compiler_options`.
"""

import contextlib

import numpy as np
import torch
import torch.utils.checkpoint

from .modeling.common import recomputing
from .parallel import functional


def set_matmul_precision():
    """TF32 off for cuDNN and cuBLAS: float32 means float32 (the choice is
    recorded in the train log by tools/program.py)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_input_transform(spec):
    """The recorded host normalize chain (Global.device_normalize, see
    tools/program.py:extract_device_normalize) as a function of the raw NHWC
    image tensor on the card -> normalized float32 NHWC. ToTensor divides by
    255, as JAX training does (trainer.py:81); only the deploy Runner
    multiplies by float32(1/255), as the JAX JitRunner does. None for an
    empty spec. From trainer.py:62."""
    if not spec:
        return None
    steps = []
    for entry in spec:
        name, params = entry["op"], entry.get("params") or {}
        if name == "ToTensor":
            steps.append(lambda x: x / 255.0)
        elif name == "Normalize":
            mean = torch.tensor(params["mean"], dtype=torch.float32).view(1, 1, 1, -1)
            std = torch.tensor(params["std"], dtype=torch.float32).view(1, 1, 1, -1)
            steps.append(lambda x, m=mean, s=std: (x - m.to(x.device)) / s.to(x.device))
        elif name == "NormalizeImage":
            scale = params.get("scale", 1.0 / 255.0)
            scale = eval(scale) if isinstance(scale, str) else scale
            mean = torch.tensor(params.get("mean", [0.485, 0.456, 0.406]),
                                dtype=torch.float32).view(1, 1, 1, -1)
            std = torch.tensor(params.get("std", [0.229, 0.224, 0.225]),
                               dtype=torch.float32).view(1, 1, 1, -1)
            steps.append(lambda x, sc=scale, m=mean, s=std:
                         (x * sc - m.to(x.device)) / s.to(x.device))
        else:
            raise ValueError("unsupported device_normalize op: %s" % name)

    def transform(images):
        x = images.to(torch.float32)
        if x.dim() == 3:  # HW C-less gray from some chains
            x = x[..., None]
        for s in steps:
            x = s(x)
        return x

    return transform


def batch_to_device(batch, device):
    """A collated numpy batch -> a tuple whose numeric arrays are tensors on
    `device` (uint8 images stay uint8: the card normalises them); ragged or
    object fields pass through."""
    out = []
    for item in batch:
        if isinstance(item, np.ndarray) and item.dtype != object and item.dtype.kind in "fiub":
            out.append(torch.from_numpy(np.ascontiguousarray(item)).to(device))
        else:
            out.append(item)
    return tuple(out)


def mask_frozen_(model, step, frozen):
    """Zero the gradients of the top-level submodules named in `frozen`,
    pairs (prefix, until_step), while step < until_step; returns their
    parameters and values, which `restore_frozen_` writes back after the
    update, so neither the moments' input nor the update moves them. The
    gradients are zeros, not None, so the optimizer still steps them: their
    Adam moments decay and the count advances as optax's do. BN running
    statistics are buffers and still update, as the JAX mask leaves
    `batch_stats` alone. The gate is the optimizer's count before the
    update, the JAX `state.step`. From trainer.py:110."""
    kept = []
    for prefix, until in frozen:
        if step >= until or not hasattr(model, prefix):
            continue
        for p in getattr(model, prefix).parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
            kept.append((p, p.detach().clone()))
    return kept


def restore_frozen_(kept):
    with torch.no_grad():
        for p, value in kept:
            p.copy_(value)


def float_preds(preds, dtype=torch.float32):
    """The model's floating outputs cast to `dtype`: a dict of maps (DB), a
    tensor (CRNN, cls) or a tuple of tensors. The step casts them to float32
    before the loss, as the JAX losses cast them (`astype(jnp.float32)`)."""
    if torch.is_tensor(preds):
        return preds.to(dtype) if preds.is_floating_point() else preds
    if isinstance(preds, dict):
        return {k: float_preds(v, dtype) for k, v in preds.items()}
    if isinstance(preds, (list, tuple)):
        return type(preds)(float_preds(v, dtype) for v in preds)
    return preds


def sample_generator(device, step):
    """The train step's torch.Generator on `device`, seeded from (17,
    `step`): the port's stand-in for the JAX step's `fold_in(PRNGKey(17),
    step)`, whose stream torch cannot reproduce."""
    return torch.Generator(device=device).manual_seed((17 << 32) + int(step))


def takes_generator(model):
    return bool(getattr(getattr(model, "head", None), "takes_generator", False))


def make_train_step(model, loss_fn, optimizer, input_transform=None, amp=False, frozen=(),
                    remat=False):
    """Build the train step: step(batch) with batch a tuple of tensors on the
    model's device, batch[0] the NHWC image tensor; returns the loss dict
    (device tensors, not synced). The step's generator (`sample_generator`,
    seeded by the optimizer's count before the update, the JAX `state.step`)
    goes to a model whose head takes one. `remat` recomputes the forward in
    the backward (the module docstring). From trainer.py:137."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    device = next(model.parameters()).device
    device_type = device.type
    generator = takes_generator(model)
    # float32 losses, as JAX casts them; a float64 model (a reference step) keeps float64
    loss_dtype = torch.float64 if next(model.parameters()).dtype == torch.float64 else torch.float32

    def forward(images, batch, count):
        kw = {"generator": sample_generator(device, count)} if generator else {}
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
            return model(images.permute(0, 3, 1, 2), data=batch, **kw)  # NCHW view

    def step(batch):
        model.train()
        images = batch[0]
        if input_transform is not None:
            images = input_transform(images)
        count = optimizer.param_groups[0]["count"]
        if remat:
            preds = torch.utils.checkpoint.checkpoint(
                forward, images, batch, count, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), recomputing()))
        else:
            preds = forward(images, batch, count)
        losses = loss_fn(float_preds(preds, loss_dtype), batch)
        optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        functional.average_gradients(params)
        kept = mask_frozen_(model, optimizer.param_groups[0]["count"], frozen) if frozen else ()
        optimizer.step()
        restore_frozen_(kept)
        return functional.average_losses({k: v.detach() for k, v in losses.items()})

    return step


def make_eval_step(model, input_transform=None, amp=False):
    """The eval forward: eval mode, no autograd, bf16 autocast when `amp`.
    From trainer.py:301."""
    device_type = next(model.parameters()).device.type

    @torch.inference_mode()
    def eval_fn(images):
        model.eval()
        if input_transform is not None:
            images = input_transform(images)
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
            return model(images.permute(0, 3, 1, 2))

    return eval_fn
