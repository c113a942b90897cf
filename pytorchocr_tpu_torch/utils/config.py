"""YAML config loading and the `-c cfg.yml -o Key.Sub=val` CLI — the port's
copy of pytorchocr_tpu/utils/config.py:18-152 (`_ConfigLoader`, `AttrDict`,
`load_config`, `parse_value`, `merge_config`, `ArgsParser`, `save_config`),
so that the port imports nothing of the JAX package.
"""

import argparse
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


def parse_value(v):
    """YAML-parse one CLI override value ('3', 'true', '[1,2]' become typed
    values). From config.py:65."""
    return yaml.load(v, Loader=_ConfigLoader)


def merge_config(config, opts):
    """Merge dotted-key overrides ({"Global.epoch_num": 10, ...}) into config
    in place; a key without a dot replaces or merges a whole top-level
    section. From config.py:71."""
    for key, value in opts.items():
        if "." not in key:
            if isinstance(value, dict) and key in config:
                config[key].update(_to_attrdict(value))
            else:
                config[key] = _to_attrdict(value)
            continue
        sub_keys = key.split(".")
        if sub_keys[0] not in config:
            raise KeyError("the sub_keys can only be one of global_config: {}, but get: "
                           "{}, please check your running command"
                           .format(list(config.keys()), sub_keys[0]))
        cur = config[sub_keys[0]]
        for sub_key in sub_keys[1:-1]:
            if sub_key not in cur or not isinstance(cur[sub_key], dict):
                cur[sub_key] = AttrDict()
            cur = cur[sub_key]
        cur[sub_keys[-1]] = _to_attrdict(value)
    return config


class ArgsParser(argparse.ArgumentParser):
    """`-c config.yml -o Key.Sub=val` CLI. From config.py:101; `--local_rank`
    is accepted for torch.distributed.launch and ignored."""

    def __init__(self, **kwargs):
        super().__init__(formatter_class=argparse.RawDescriptionHelpFormatter, **kwargs)
        self.add_argument("-c", "--config", help="configuration file to use")
        self.add_argument("-o", "--opt", nargs="+", help="set configuration options")
        self.add_argument("--local_rank", type=int, default=0,
                          help="ignored; accepted for torch.distributed.launch")

    def parse_args(self, argv=None):
        args = super().parse_args(argv)
        if args.config is None:
            self.error("Please specify --config=configure_file_path.")
        args.opt = self._parse_opt(args.opt)
        return args

    @staticmethod
    def _parse_opt(opts):
        config = {}
        for s in opts or []:
            k, v = s.strip().split("=", 1)
            config[k] = parse_value(v)
        return config


def save_config(config, path):
    """Dump the resolved config to the run directory. From config.py:138."""
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)

    def plain(obj):
        if isinstance(obj, dict):
            return {k: plain(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [plain(v) for v in obj]
        return obj

    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(plain(config), f, default_flow_style=False, sort_keys=False)
