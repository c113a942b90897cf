"""Data layer — the port's copy of pytorchocr_tpu/data/__init__.py
(`build_dataloader`, :27) and its registry (`data/imaug/__init__.py`).

The per-rank shard comes from torch.distributed when a process group is
initialised (the JAX package asks jax.process_index/count, :18-24); the port
trains on one card, so it is (0, 1) until multi-GPU training (ROADMAP.md
A.8). Only SimpleDataSet is ported; PubTabDataSet waits for A.13.
"""

import copy

from .imaug import create_operators, transform
from .loader import OCRDataLoader, default_collate
from .simple_dataset import SimpleDataSet

__all__ = ["build_dataloader", "create_operators", "default_collate", "OCRDataLoader",
           "SimpleDataSet", "transform"]


def _process_info():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_dataloader(config, mode, logger, seed=None):
    """(loader, loader): the JAX contract, whose second item carries
    `set_epoch`. From data/__init__.py:27."""
    config = copy.deepcopy(config)
    if seed is None:
        # every rank must agree on the dataset order: default to the run seed
        seed = config["Global"].get("seed", 2022)
    module_name = config[mode]["dataset"]["name"]
    if module_name == "PubTabDataSet":
        raise NotImplementedError("PubTabDataSet is not ported yet (ROADMAP.md A.13)")
    if module_name != "SimpleDataSet":
        raise ValueError("DataSet only support ['SimpleDataSet', 'PubTabDataSet']")
    if mode not in ("Train", "Eval", "Test"):
        raise ValueError("Mode should be Train, Eval or Test.")

    dataset = SimpleDataSet(config, mode, logger, seed)
    loader_config = config[mode]["loader"]
    shard_index, num_shards = 0, 1
    if mode == "Train" and config["Global"].get("distributed", False):
        shard_index, num_shards = _process_info()
    data_loader = OCRDataLoader(
        dataset=dataset,
        batch_size=loader_config["batch_size_per_card"],
        shuffle=loader_config["shuffle"] if mode == "Train" else False,
        drop_last=loader_config.get("drop_last", False),
        num_workers=loader_config["num_workers"],
        seed=seed,
        shard_index=shard_index,
        num_shards=num_shards,
        worker_mode=loader_config.get("worker_mode", "thread"),
    )
    return data_loader, data_loader
