"""Optimizer factory — port of pytorchocr_tpu/optimizer/__init__.py:24-95.

The JAX package maps the configs' Adam onto `optax.adam` / `optax.amsgrad`
(with `add_decayed_weights` for an L2 `weight_decay`). `OptaxAdam` is a
torch.optim.Optimizer with optax's arithmetic:

  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
  mu_hat = mu / (1 - b1^count);  nu_hat = nu / (1 - b2^count)
  amsgrad: nu_max = max(nu_max, nu_hat), and nu_max stands for nu_hat below
  p -= lr(count - 1) * mu_hat / (sqrt(nu_hat) + eps)

`torch.optim.Adam(amsgrad=True)` takes the running max of the raw second
moment and corrects it afterwards, which differs from the second step on
(tests/test_torch_train_loss_optim.py shows it). The LR is the schedule at
the count before the update, as optax's `scale_by_schedule` evaluates it.
Every config of the repo uses Adam; AdamW, SGD and RMSprop are not ported
(ROADMAP.md A.15).
"""

import copy

import numpy as np
import torch

from .lr_scheduler import WarmupCosineLR, WarmupMultiStepLR, WarmupPolyLR

__all__ = ["OptaxAdam", "build_optimizer"]

_SCHEDULES = {
    "WarmupMultiStepLR": WarmupMultiStepLR,
    "WarmupPolyLR": WarmupPolyLR,
    "WarmupCosineLR": WarmupCosineLR,
}


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam / optax.amsgrad on torch parameters; `lr_schedule` maps the
    update count to the LR. One count for all parameters (optax keeps one),
    stored in each param group so that it travels with `state_dict`."""

    def __init__(self, params, lr_schedule, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False):
        defaults = dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        amsgrad=amsgrad, count=0)
        super().__init__(params, defaults)
        self.lr_schedule = lr_schedule

    def current_lr(self):
        return float(self.lr_schedule(self.param_groups[0]["count"]))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr = float(self.lr_schedule(group["count"]))
            group["count"] += 1
            count = np.float32(group["count"])
            grads = [p.grad for p in params]
            if group["weight_decay"]:  # optax.add_decayed_weights: g + wd * p
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            states = []
            for p in params:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    if group["amsgrad"]:
                        st["nu_max"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                states.append(st)
            mu = [st["mu"] for st in states]
            nu = [st["nu"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # 1 - decay**count in float32, as optax's tree_bias_correction
            bc1 = float(np.float32(1) - np.float32(b1) ** count)
            bc2 = float(np.float32(1) - np.float32(b2) ** count)
            mu_hat = torch._foreach_div(mu, bc1)
            nu_hat = torch._foreach_div(nu, bc2)
            if group["amsgrad"]:
                nu_max = [st["nu_max"] for st in states]
                torch._foreach_maximum_(nu_max, nu_hat)
                nu_hat = nu_max
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(mu_hat, denom)
            torch._foreach_add_(params, mu_hat, alpha=-lr)


def build_optimizer(config, epochs, step_each_epoch, parameters):
    """Returns (optimizer over `parameters`, lr_schedule). From
    optimizer/__init__.py:70."""
    config = copy.deepcopy(config)
    base_lr = config.pop("base_lr")
    optim_cfg = dict(config["optim"])
    optim_name = optim_cfg.pop("name")

    if "lr_decay" in config and "name" in config["lr_decay"]:
        lr_cfg = dict(config["lr_decay"])
        lr_decay_name = lr_cfg.pop("name")
        if lr_decay_name not in _SCHEDULES:
            raise ValueError("lr scheduler only support {}".format(list(_SCHEDULES)))
        warmup_iters = lr_cfg.pop("warmup_epoch", 0) * step_each_epoch
        if "T_max_epoch" in lr_cfg:
            t_max_iters = lr_cfg.pop("T_max_epoch") * step_each_epoch
        else:
            t_max_iters = 50 * step_each_epoch
        lr_schedule = _SCHEDULES[lr_decay_name](
            base_lr, warmup_iters=warmup_iters, max_iters=epochs * step_each_epoch,
            T_max_iters=t_max_iters, **lr_cfg)
    else:
        def lr_schedule(step):
            return np.float32(base_lr)

    if optim_name != "Adam":
        raise NotImplementedError("optimizer %s is not ported (ROADMAP.md A.15): every config "
                                  "of the repo uses Adam" % optim_name)
    optimizer = OptaxAdam(
        parameters, lr_schedule, betas=optim_cfg.get("betas", (0.9, 0.999)),
        eps=optim_cfg.get("eps", 1e-8), weight_decay=optim_cfg.get("weight_decay", 0.0) or 0.0,
        amsgrad=optim_cfg.get("amsgrad", False))
    return optimizer, lr_schedule
