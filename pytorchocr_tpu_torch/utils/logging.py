"""Process-aware logger — the port's copy of pytorchocr_tpu/utils/logging.py.

Only rank 0 logs at INFO and writes the log file; other ranks are raised to
ERROR. The rank is torch.distributed's when a process group is initialised,
else 0 (the JAX version asks jax.process_index, logging.py:15-19).
"""

import functools
import logging
import os
import sys

logger_initialized = {}


def process_rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@functools.lru_cache()
def get_logger(name="pytorchocr_tpu_torch", log_file=None, log_level=logging.INFO):
    """From logging.py:22."""
    logger = logging.getLogger(name)
    if name in logger_initialized:
        return logger
    for logger_name in logger_initialized:
        if name.startswith(logger_name):
            return logger

    formatter = logging.Formatter(
        "[%(asctime)s] %(name)s %(levelname)s: %(message)s", datefmt="%Y/%m/%d %H:%M:%S"
    )
    stream_handler = logging.StreamHandler(stream=sys.stdout)
    stream_handler.setFormatter(formatter)
    logger.addHandler(stream_handler)

    rank = process_rank()
    if rank == 0 and log_file is not None:
        log_file_folder = os.path.dirname(log_file)
        if log_file_folder:
            os.makedirs(log_file_folder, exist_ok=True)
        file_handler = logging.FileHandler(log_file, "a")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)

    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    logger_initialized[name] = True
    return logger


def print_dict(d, logger, delimiter=0):
    """Recursively log a config dict. From logging.py:56."""
    for k, v in d.items():
        if isinstance(v, dict):
            logger.info("{}{} : ".format(delimiter * " ", k))
            print_dict(v, logger, delimiter + 4)
        elif isinstance(v, list) and len(v) >= 1 and isinstance(v[0], dict):
            logger.info("{}{} : ".format(delimiter * " ", k))
            for value in v:
                print_dict(value, logger, delimiter + 4)
        else:
            logger.info("{}{} : {}".format(delimiter * " ", k, v))
