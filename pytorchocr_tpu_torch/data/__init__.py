"""Data layer — the port's copy of pytorchocr_tpu/data/__init__.py
(`build_dataloader`, :27) and its registry (`data/imaug/__init__.py`).

The training loader's shard is this rank's data index and the data world
of parallel/mesh.py (the JAX package asks jax.process_index / count,
:18-24), (0, 1) in one process; the eval loader is not sharded (:52).
SimpleDataSet (line files) and PubTabDataSet (PubTabNet jsonl tables).
"""

import copy

from ..parallel.mesh import data_shard

from .imaug import create_operators, transform
from .loader import OCRDataLoader, default_collate
from .pubtab_dataset import PubTabDataSet
from .simple_dataset import SimpleDataSet

__all__ = ["build_dataloader", "create_operators", "default_collate", "OCRDataLoader",
           "PubTabDataSet", "SimpleDataSet", "transform"]


def build_dataloader(config, mode, logger, seed=None):
    """(loader, loader): the JAX contract, whose second item carries
    `set_epoch`. From data/__init__.py:27."""
    config = copy.deepcopy(config)
    if seed is None:
        # every rank must agree on the dataset order: default to the run seed
        seed = config["Global"].get("seed", 2022)
    module_name = config[mode]["dataset"]["name"]
    datasets = {"SimpleDataSet": SimpleDataSet, "PubTabDataSet": PubTabDataSet}
    if module_name not in datasets:
        raise ValueError("DataSet only support %s" % list(datasets))
    if mode not in ("Train", "Eval", "Test"):
        raise ValueError("Mode should be Train, Eval or Test.")

    dataset = datasets[module_name](config, mode, logger, seed)
    loader_config = config[mode]["loader"]
    shard_index, num_shards = 0, 1
    if mode == "Train" and config["Global"].get("distributed", False):
        shard_index, num_shards = data_shard()
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
