"""Iteration-granular LR schedules with linear/constant warmup — port of
pytorchocr_tpu/optimizer/lr_scheduler.py (WarmupMultiStepLR, WarmupPolyLR at
:51, WarmupCosineLR).

Each is a step -> lr function in numpy float32, in the JAX functions' order
of operations (they run in float32 inside the jitted step), so the port's
LRs equal the JAX ones to float32 rounding. optax evaluates the schedule at
the count before the update (step 0 for the first one); the optimizer
(optimizer/__init__.py) does the same.
"""

import numpy as np

__all__ = ["WarmupMultiStepLR", "WarmupPolyLR", "WarmupCosineLR"]

_F = np.float32


def _warmup_factor(step, warmup_iters, warmup_factor, warmup_method):
    if warmup_method == "constant":
        return _F(warmup_factor)
    if warmup_method == "linear":
        alpha = step / _F(max(warmup_iters, 1))
        return _F(warmup_factor) * (_F(1) - alpha) + alpha
    raise ValueError("Only 'constant' or 'linear' warmup_method accepted")


def WarmupMultiStepLR(base_lr, milestones, gamma=0.1, warmup_factor=1.0 / 3,
                      warmup_iters=500, warmup_method="linear", **kwargs):
    milestones = list(milestones)
    if milestones != sorted(milestones):
        raise ValueError("Milestones should be a list of increasing integers.")
    ms = np.asarray(milestones, _F)

    def schedule(step):
        step = _F(step)
        f = (_warmup_factor(step, warmup_iters, warmup_factor, warmup_method)
             if step < warmup_iters else _F(1))
        decays = int(np.sum(step >= ms))
        return _F(base_lr) * f * _F(gamma) ** _F(decays)

    return schedule


def WarmupPolyLR(base_lr, target_lr=0, max_iters=0, power=0.9, warmup_factor=1.0 / 3,
                 warmup_iters=500, warmup_method="linear", **kwargs):
    span = _F(base_lr - target_lr)

    def schedule(step):
        step = _F(step)
        if step < warmup_iters:
            f = _warmup_factor(step, warmup_iters, warmup_factor, warmup_method)
            return _F(target_lr) + span * f
        n = _F(max(max_iters - warmup_iters, 1))
        t = np.clip(step - _F(warmup_iters), _F(0), n)
        return _F(target_lr) + span * (_F(1) - t / n) ** _F(power)

    return schedule


def WarmupCosineLR(base_lr, T_max_iters, eta_min=0, warmup_factor=1.0 / 3,
                   warmup_iters=500, warmup_method="linear", **kwargs):
    def schedule(step):
        step = _F(step)
        if step < warmup_iters:
            return _F(base_lr) * _warmup_factor(step, warmup_iters, warmup_factor,
                                                warmup_method)
        t = np.mod(step - _F(warmup_iters), _F(2 * T_max_iters))
        return _F(eta_min) + _F(base_lr - eta_min) * (
            _F(1) + np.cos(_F(np.pi) * t / _F(T_max_iters))) / _F(2)

    return schedule
