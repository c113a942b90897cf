"""YAML config loading — the port's copy of pytorchocr_tpu/utils/config.py:18-62
(`_ConfigLoader`, `AttrDict`, `_to_attrdict`, `load_config`), so that the port
imports nothing of the JAX package. Only what the port calls is copied: the
CLI override parser and `save_config` wait for training (ROADMAP.md A.7).
"""

import copy
import os

import yaml


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader that also understands !!python/tuple (used by reference
    configs, e.g. configs/det/det_r18_db.yml:50). From config.py:18."""


_ConfigLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)),
)


class AttrDict(dict):
    """dict with attribute access, applied recursively on load. From
    config.py:29."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        return AttrDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}
        )


def _to_attrdict(obj):
    """From config.py:47."""
    if isinstance(obj, dict):
        return AttrDict({k: _to_attrdict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_attrdict(v) for v in obj]
    return obj


def load_config(file_path):
    """Load a YAML config file into a nested AttrDict. From config.py:55."""
    _, ext = os.path.splitext(file_path)
    if ext not in (".yml", ".yaml"):
        raise ValueError("only yaml config files are supported, got %s" % file_path)
    with open(file_path, "rb") as f:
        config = yaml.load(f, Loader=_ConfigLoader)
    return _to_attrdict(config)
