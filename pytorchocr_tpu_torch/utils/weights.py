"""The weight bridge: JAX/flax variables -> the port's state_dict.

The inverse of tools/convert_torch_weights.py. The port's module names mirror
the flax ones, so a torch module at `a.b.c` reads the flax subtree
`params/a/b/c` (and `batch_stats/a/b/c`):

  Conv2d            kernel (kh, kw, in/groups, out) -> weight (out, in/groups, kh, kw)
  ConvTranspose2d   kernel (kh, kw, in, out) -> weight (in, out, kh, kw), spatially
                    flipped: flax's ConvTranspose applies the flipped kernel
  Linear            kernel (in, out) -> weight (out, in)
  BatchNorm2d       scale, bias, mean, var -> weight, bias, running_mean, running_var
  BiLSTM            wi (2, C, 4H), wh (2, H, 4H), b (2, 4H), direction-major with
                    gates i, f, g, o -> weight_ih_l0[_reverse] = wi[d].T,
                    weight_hh_l0[_reverse] = wh[d].T, bias_ih = b[d], bias_hh = 0

Every torch tensor must find its flax leaf and every flax leaf must be used;
anything else raises.

The int8 PTQ state (the JAX `quant` collection: `act_absmax`, `out_absmax`,
`fuse_absmax`, `mid_absmax` scalars) lies outside the state_dict, in the
port's `ops.quant.AbsMax` modules of the same names (`flax_quant_to_torch`,
`load_absmax`).
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..modeling.necks.rnn import BiLSTM
from ..ops.quant import AbsMax


def _subtree(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _module_leaves(module, params, stats):
    """(torch name -> numpy value, used flax leaf keys) for one module."""
    def p(key):
        return np.asarray(params[key], np.float32)

    if isinstance(module, BiLSTM):
        wi, wh, b = p("wi"), p("wh"), p("b")
        out = {}
        for d, suffix in enumerate(("", "_reverse")):
            out["rnn.weight_ih_l0" + suffix] = wi[d].T
            out["rnn.weight_hh_l0" + suffix] = wh[d].T
            out["rnn.bias_ih_l0" + suffix] = b[d]
            out["rnn.bias_hh_l0" + suffix] = np.zeros_like(b[d])
        return out, {("p", "wi"), ("p", "wh"), ("p", "b")}
    if isinstance(module, nn.ConvTranspose2d):
        out = {"weight": np.transpose(p("kernel")[::-1, ::-1], (2, 3, 0, 1))}
    elif isinstance(module, nn.Conv2d):
        out = {"weight": np.transpose(p("kernel"), (3, 2, 0, 1))}
    elif isinstance(module, nn.Linear):
        out = {"weight": p("kernel").T}
    elif isinstance(module, nn.BatchNorm2d):
        return {
            "weight": p("scale"), "bias": p("bias"),
            "running_mean": np.asarray(stats["mean"], np.float32),
            "running_var": np.asarray(stats["var"], np.float32),
        }, {("p", "scale"), ("p", "bias"), ("s", "mean"), ("s", "var")}
    else:
        return {}, set()
    used = {("p", "kernel")}
    if module.bias is not None:
        out["bias"] = p("bias")
        used.add(("p", "bias"))
    return out, used


def _flat_keys(tree, prefix=()):
    if not isinstance(tree, Mapping):
        return {prefix}
    keys = set()
    for k, v in tree.items():
        keys |= _flat_keys(v, prefix + (k,))
    return keys


def flax_to_state_dict(model, variables):
    """Map flax `variables` ({"params": ..., "batch_stats": ...}, numpy or
    array leaves) onto `model`'s state_dict. Returns a dict of CPU tensors."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    skip = set()  # modules handled by their parent (BiLSTM's nn.LSTM)
    state, used = {}, set()
    for name, module in model.named_modules():
        if name in skip or not name:
            continue
        if isinstance(module, BiLSTM):
            skip.add(name + ".rnn")
        path = tuple(name.split("."))
        try:
            leaves, keys = _module_leaves(
                module, _subtree(params, path) or {}, _subtree(stats, path) or {}
            )
        except KeyError as e:
            raise KeyError("weight bridge: no flax leaf %s for torch module %s"
                           % (e, name)) from None
        for k, v in leaves.items():
            state["%s.%s" % (name, k)] = torch.from_numpy(np.array(v, np.float32))
        for kind, k in keys:
            used.add(("params" if kind == "p" else "batch_stats",) + path + (k,))

    expected = set(model.state_dict())
    missing = sorted(k for k in expected - set(state) if not k.endswith("num_batches_tracked"))
    all_flax = {("params",) + k for k in _flat_keys(params)}
    all_flax |= {("batch_stats",) + k for k in _flat_keys(stats)}
    unused = sorted("/".join(k) for k in all_flax - used)
    if missing or unused:
        raise KeyError(
            "weight bridge mismatch: torch tensors without a flax leaf %s; "
            "flax leaves without a torch tensor %s" % (missing, unused)
        )
    for k in expected:
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long)
    return state


def load_flax_variables(model, variables):
    """Load flax `variables` into `model` in place (shapes checked)."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model


def load_absmax(model, state):
    """Set `model`'s AbsMax modules from `state`, {module name: value} (what
    `flax_quant_to_torch` returns and tools/convert_flax_to_torch.py saves
    as <out>.quant.pt). A name that is not an AbsMax module raises."""
    mods = dict(model.named_modules())
    missing = sorted(k for k in state if not isinstance(mods.get(k), AbsMax))
    if missing:
        raise KeyError("quant bridge: no AbsMax module for %s" % missing)
    for k, v in state.items():
        mods[k].set(v)
    return model


def flax_quant_to_torch(model, quant_vars):
    """Carry the JAX `quant` collection into `model`: the leaf at flax path
    a/b/out_absmax sets the AbsMax module a.b.out_absmax (the port's names
    mirror the flax ones). A leaf without its module raises, as the param
    bridge does. Returns the {module name: float32 tensor} it set. Modules
    the JAX run never calibrated (e.g. the DB head's train-only tower) keep
    their state."""
    state = {}
    for path in sorted(_flat_keys(quant_vars)):
        leaf = quant_vars
        for k in path:
            leaf = leaf[k]
        state[".".join(path)] = torch.tensor(np.asarray(leaf, np.float32).reshape(()))
    load_absmax(model, state)
    return state


def load_optax_adam_state(optimizer, model, opt_state, batch_stats):
    """Carry an optax Adam/amsgrad state into `optimizer` (an
    optimizer.OptaxAdam over `model`'s parameters) in place: `opt_state` is
    {"count": int, "mu": tree, "nu": tree[, "nu_max": tree]} of numpy leaves
    in the flax params layout (the ScaleByAmsgradState fields); each tree
    goes through the param bridge, so a conv's moments land in its weight's
    layout. `batch_stats` only completes the bridge's BN entries."""
    named = dict(model.named_parameters())
    moments = {}
    for key in ("mu", "nu", "nu_max"):
        if key in opt_state:
            sd = flax_to_state_dict(model, {"params": opt_state[key],
                                            "batch_stats": batch_stats})
            moments[key] = {name: sd[name] for name in named}
    for group in optimizer.param_groups:
        group["count"] = int(opt_state["count"])
    by_param = {p: name for name, p in named.items()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = by_param[p]
            optimizer.state[p] = {k: torch.empty_like(p).copy_(v[name])
                                  for k, v in moments.items()}
    return optimizer
