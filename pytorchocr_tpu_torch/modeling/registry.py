"""Registry helpers — port of pytorchocr_tpu/modeling/registry.py.

`build(kind, table, config)` builds a module named in a config section from
the names this slice ports; a name of the JAX package that waits for a later
port raises NotImplementedError naming its ROADMAP.md item.
"""

import copy
import inspect
import logging

_IGNORED_KEYS = {"pretrained", "ckpt_path"}


def instantiate(module_class, config, **extra):
    """Call `module_class` with the config keys its constructor takes; other
    keys are dropped with a warning (the JAX registry does the same)."""
    params = inspect.signature(module_class.__init__).parameters
    kwargs, dropped = {}, []
    for k, v in config.items():
        if k in params:
            kwargs[k] = v
        elif k not in _IGNORED_KEYS:
            dropped.append(k)
    if dropped:
        logging.getLogger(__name__).warning(
            "%s: ignoring config keys %s", module_class.__name__, dropped
        )
    kwargs.update(extra)
    return module_class(**kwargs)


def build(kind, table, later, config, **extra):
    """`table`: name -> class on this slice; `later`: name -> ROADMAP.md item
    of the JAX package's other names."""
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name in table:
        return instantiate(table[name], config, **extra)
    if name in later:
        raise NotImplementedError(
            "%s %s is not ported yet (ROADMAP.md %s)" % (kind, name, later[name])
        )
    raise NotImplementedError(
        "%s %s: unknown; the port supports %s" % (kind, name, list(table))
    )
