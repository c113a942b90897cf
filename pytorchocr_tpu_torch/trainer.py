"""Train and eval steps — port of pytorchocr_tpu/trainer.py
(`build_input_transform` :62, `_mask_frozen_updates` :110, `make_train_step`
:137, `make_eval_step` :301).

The JAX step is one jitted graph: forward in train mode, loss, backward,
optimizer update and BN statistics. Here it is the same sequence on an
`nn.Module`: train mode (the flax-statistics BN of modeling/common.py),
`torch.autocast(bfloat16)` around the forward when `use_amp` (the JAX bf16
policy), the model's maps cast to float32 before the loss, `backward()`, and
`optimizer.step()` (optimizer.OptaxAdam, optax's arithmetic).

TF32: `set_matmul_precision` turns TF32 off for cuDNN convolutions and cuBLAS
matmuls, so float32 training computes in float32 as the CPU does; under
`use_amp` the convolutions and matmuls run in bf16 and the setting touches
only the float32 remainder.

Not carried over (ROADMAP.md A.15): `make_multi_train_step` /
`steps_per_dispatch`, `remat` (jax.checkpoint), `compiler_options`.
"""

import numpy as np
import torch


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
    update, so neither the moments' input nor the update moves them. From
    trainer.py:110."""
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


def make_train_step(model, loss_fn, optimizer, input_transform=None, amp=False, frozen=()):
    """Build the train step: step(batch) with batch a tuple of tensors on the
    model's device, batch[0] the NHWC image tensor; returns the loss dict
    (device tensors, not synced). From trainer.py:137."""
    device_type = next(model.parameters()).device.type

    def step(batch):
        model.train()
        images = batch[0]
        if input_transform is not None:
            images = input_transform(images)
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
            preds = model(images.permute(0, 3, 1, 2), data=batch)  # NCHW view
        preds = {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
                 for k, v in preds.items()}
        losses = loss_fn(preds, batch)
        optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        kept = mask_frozen_(model, optimizer.param_groups[0]["count"], frozen) if frozen else ()
        optimizer.step()
        restore_frozen_(kept)
        return {k: v.detach() for k, v in losses.items()}

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
