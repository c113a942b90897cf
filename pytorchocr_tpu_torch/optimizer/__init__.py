"""Optimizer factory — port of pytorchocr_tpu/optimizer/__init__.py:23-95.

The JAX package maps the configs' optimizers onto optax transformations;
each class here is a torch.optim.Optimizer with that transformation's
arithmetic, in float32 as optax computes it, and the LR the schedule gives
at the update count before the update (optax's `scale_by_schedule`). One
count for all parameters, kept in each param group so that it travels with
`state_dict`.

Adam (`optax.adam` / `optax.amsgrad`, `add_decayed_weights` first for an L2
`weight_decay`), `OptaxAdam`:

  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
  mu_hat = mu / (1 - b1^count);  nu_hat = nu / (1 - b2^count)
  amsgrad: nu_max = max(nu_max, nu_hat), and nu_max stands for nu_hat below
  p -= lr(count - 1) * mu_hat / (sqrt(nu_hat) + eps)

`torch.optim.Adam(amsgrad=True)` takes the running max of the raw second
moment and corrects it afterwards, which differs from the second step on
(tests/test_torch_train_loss_optim.py shows it).

AdamW (`optax.adamw`; an unset or zero `weight_decay` is 1e-2), `OptaxAdam`
with `decoupled`: the decay joins the Adam direction before the LR,
p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + wd p); torch.optim.AdamW
multiplies p by (1 - lr wd) first, which rounds otherwise.

SGD (`add_decayed_weights(weight_decay)`, then `optax.sgd(momentum or None,
nesterov)`), `OptaxSGD`: g += wd p; with momentum m, t = g + m t and the
update t (nesterov: g + m t); p -= lr * update.

RMSprop (`optax.rmsprop(decay=alpha, eps, momentum)`: `scale_by_rms` with
`eps_in_sqrt` and a zero initial scale, the LR, then a trace even at
momentum 0.0, which the JAX package passes; no weight decay), `OptaxRMSprop`:
nu = (1 - alpha) g^2 + alpha nu; u = -lr g / sqrt(nu + eps); t = u + m t;
p += t. torch.optim.RMSprop divides by sqrt(nu) + eps instead.
"""

import copy

import numpy as np
import torch

from .lr_scheduler import WarmupCosineLR, WarmupMultiStepLR, WarmupPolyLR

__all__ = ["OptaxAdam", "OptaxSGD", "OptaxRMSprop", "build_optimizer"]

_SCHEDULES = {
    "WarmupMultiStepLR": WarmupMultiStepLR,
    "WarmupPolyLR": WarmupPolyLR,
    "WarmupCosineLR": WarmupCosineLR,
}


class _Scheduled(torch.optim.Optimizer):
    """An optimizer whose LR is `lr_schedule(count)`, the update count
    before the update."""

    def __init__(self, params, lr_schedule, **defaults):
        super().__init__(params, dict(defaults, count=0))
        self.lr_schedule = lr_schedule

    def current_lr(self):
        return float(self.lr_schedule(self.param_groups[0]["count"]))

    def _groups(self, closure):
        """(group, its parameters with a gradient, the group's LR) of each
        group, the count advanced."""
        if closure is not None:
            raise ValueError("%s takes no closure" % type(self).__name__)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr = float(self.lr_schedule(group["count"]))
            group["count"] += 1
            yield group, params, lr

    def _state(self, params, names):
        """The named zero-initialised buffers of each parameter."""
        for p in params:
            st = self.state[p]
            for name in names:
                if name not in st:
                    st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return [[self.state[p][name] for p in params] for name in names]


class OptaxAdam(_Scheduled):
    """optax.adam / optax.amsgrad, or optax.adamw with `decoupled`, on torch
    parameters; `lr_schedule` maps the update count to the LR."""

    def __init__(self, params, lr_schedule, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, decoupled=False):
        super().__init__(params, lr_schedule, betas=tuple(betas), eps=eps,
                         weight_decay=weight_decay, amsgrad=amsgrad, decoupled=decoupled)

    @torch.no_grad()
    def step(self, closure=None):
        for group, params, lr in self._groups(closure):
            b1, b2 = group["betas"]
            wd, decoupled = group["weight_decay"], group.get("decoupled", False)
            count = np.float32(group["count"])
            grads = [p.grad for p in params]
            if wd and not decoupled:  # optax.add_decayed_weights: g + wd * p
                grads = torch._foreach_add(grads, params, alpha=wd)
            mu, nu = self._state(params, ("mu", "nu"))
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
                (nu_max,) = self._state(params, ("nu_max",))
                torch._foreach_maximum_(nu_max, nu_hat)
                nu_hat = nu_max
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(mu_hat, denom)
            if wd and decoupled:  # optax.adamw: the decay before the LR
                torch._foreach_add_(mu_hat, params, alpha=wd)
            torch._foreach_add_(params, mu_hat, alpha=-lr)


class OptaxSGD(_Scheduled):
    """add_decayed_weights(weight_decay), then optax.sgd (a trace where
    `momentum` is not 0, nesterov or not)."""

    def __init__(self, params, lr_schedule, momentum=0.0, nesterov=False, weight_decay=0.0):
        super().__init__(params, lr_schedule, momentum=momentum, nesterov=nesterov,
                         weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        for group, params, lr in self._groups(closure):
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            m = group["momentum"]
            if m:  # optax.trace: t = g + m t; nesterov's update g + m t
                (trace,) = self._state(params, ("trace",))
                torch._foreach_mul_(trace, m)
                torch._foreach_add_(trace, grads)
                grads = (torch._foreach_add(grads, trace, alpha=m) if group["nesterov"]
                         else trace)
            torch._foreach_add_(params, grads, alpha=-lr)


class OptaxRMSprop(_Scheduled):
    """optax.rmsprop(lr, decay, eps, momentum): scale_by_rms (eps inside the
    square root, initial scale 0), the LR, then a trace of decay
    `momentum`."""

    def __init__(self, params, lr_schedule, decay=0.9, eps=1e-8, momentum=0.0):
        super().__init__(params, lr_schedule, decay=decay, eps=eps, momentum=momentum)

    @torch.no_grad()
    def step(self, closure=None):
        for group, params, lr in self._groups(closure):
            decay = group["decay"]
            grads = [p.grad for p in params]
            nu, trace = self._state(params, ("nu", "trace"))
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
            scale = torch._foreach_add(nu, group["eps"])
            torch._foreach_rsqrt_(scale)
            update = torch._foreach_mul(scale, grads)
            torch._foreach_mul_(update, -lr)
            torch._foreach_mul_(trace, group["momentum"])
            torch._foreach_add_(trace, update)
            torch._foreach_add_(params, trace)


def build_optimizer(config, epochs, step_each_epoch, parameters):
    """Returns (optimizer over those of `parameters` that require a gradient,
    lr_schedule): a parameter that is held fixed (the BiLSTM's `bias_hh`,
    which has no JAX counterpart) gets no moments. From
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

    params = [p for p in parameters if p.requires_grad]
    betas = optim_cfg.get("betas", (0.9, 0.999))
    eps = optim_cfg.get("eps", 1e-8)
    weight_decay = optim_cfg.get("weight_decay", 0.0) or 0.0
    if optim_name == "Adam":
        optimizer = OptaxAdam(params, lr_schedule, betas=betas, eps=eps, weight_decay=weight_decay,
                              amsgrad=optim_cfg.get("amsgrad", False))
    elif optim_name == "AdamW":
        optimizer = OptaxAdam(params, lr_schedule, betas=betas, eps=eps,
                              weight_decay=weight_decay or 1e-2, decoupled=True)
    elif optim_name == "SGD":
        optimizer = OptaxSGD(params, lr_schedule, momentum=optim_cfg.get("momentum", 0.0) or 0.0,
                             nesterov=optim_cfg.get("nesterov", False), weight_decay=weight_decay)
    elif optim_name == "RMSprop":
        optimizer = OptaxRMSprop(params, lr_schedule, decay=optim_cfg.get("alpha", 0.99), eps=eps,
                                 momentum=optim_cfg.get("momentum", 0.0))
    else:
        raise ValueError("unsupported optimizer %s" % optim_name)
    return optimizer, lr_schedule
