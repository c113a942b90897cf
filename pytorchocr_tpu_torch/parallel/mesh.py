"""Process groups for multi-card training — port of
pytorchocr_tpu/parallel/mesh.py (`create_mesh` :24).

The JAX package trains on a 2-D ("data", "model") device mesh: the batch
is sharded over "data", the CTC head's vocabulary over "model"
(parallel/shardings.py), and one jitted step over the global batch does the
rest. Here each rank is a process (`python -m torch.distributed.run`), and
the ranks are laid out as the JAX mesh lays out its devices,
`np.arange(world).reshape(world // model_parallel, model_parallel)`: rank r
sits at data index r // model_parallel and model index r % model_parallel.
A rank's "data" group holds the ranks of its column (replicas of every
parameter, each on its own shard of the batch); its "model" group the ranks
of its row (the same batch, the head's vocabulary split among them).
parallel/functional.py reduces over those groups.

The backend is a choice, never a fallback: nccl for cards, gloo for the
CPU. Two ranks on one card need gloo (NCCL refuses two ranks on one
device); gloo reduces CUDA tensors through the host, so its times say
nothing of NCCL's. `setup` reads the torchrun environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) unless it is given an
`init_method`, rank and world.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "barrier", "broadcast_object", "create_mesh", "data_shard", "get_mesh",
           "select_device", "setup", "teardown", "torchrun_env"]


class Mesh:
    """The (data, model) layout of the initialised default group: this
    rank's place in it and its two groups (None where a group holds this
    rank alone: nothing to reduce)."""

    def __init__(self, rank, world, model_parallel, data_group, model_group, backend):
        self.rank, self.world = rank, world
        self.model_parallel = model_parallel
        self.data_world, self.data_rank = world // model_parallel, rank // model_parallel
        self.model_world, self.model_rank = model_parallel, rank % model_parallel
        self.data_group, self.model_group = data_group, model_group
        self.backend = backend


_MESH = None


def get_mesh():
    """The mesh `setup` / `create_mesh` built in this process, or None (one
    process: every reduction of parallel/functional.py is the identity)."""
    return _MESH


def data_shard():
    """(index, count) of this process's shard of the training data: its
    data rank and the data world under a mesh, else (0, 1). From
    data/__init__.py:18-24, which asks jax.process_index / process_count."""
    if _MESH is None:
        return 0, 1
    return _MESH.data_rank, _MESH.data_world


def torchrun_env():
    """(rank, world, local_rank) from the environment torchrun gives each
    process, or None outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", 0)))


def select_device(use_gpu=True, local_rank=0, ranks_per_card=1):
    """The CPU, or card `local_rank // ranks_per_card`. `use_gpu` without a
    card raises, as does a rank past the last card."""
    if not use_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("Global.use_gpu is True but torch.cuda.is_available() is False; "
                           "pass -o Global.use_gpu=False to run on the CPU")
    index = local_rank // max(int(ranks_per_card), 1)
    if index >= torch.cuda.device_count():
        raise RuntimeError("local rank %d at %d ranks a card needs card %d; this host has %d "
                           "(Global.ranks_per_card puts several ranks on one card, over gloo)"
                           % (local_rank, ranks_per_card, index, torch.cuda.device_count()))
    return torch.device("cuda", index)


def create_mesh(model_parallel=1):
    """The Mesh of the initialised default group. Every rank creates every
    group, in the same order, as torch.distributed.new_group requires. From
    mesh.py:24."""
    global _MESH
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError("world %d is not divisible by model_parallel %d"
                         % (world, model_parallel))
    layout = np.arange(world).reshape(world // model_parallel, model_parallel)
    data_group = model_group = None
    if layout.shape[0] > 1:
        for column in layout.T:
            group = None if model_parallel == 1 else dist.new_group(column.tolist())
            if rank in column:
                data_group = group if group is not None else dist.group.WORLD
    if model_parallel > 1:
        for row in layout:
            group = dist.new_group(row.tolist())
            if rank in row:
                model_group = group
    _MESH = Mesh(rank, world, model_parallel, data_group, model_group, dist.get_backend())
    return _MESH


def setup(backend, device, model_parallel=1, init_method=None, rank=None, world=None):
    """Initialise the default process group on `backend` ("nccl" or
    "gloo"), its ranks on `device`, and build the Mesh. Without
    `init_method` the torchrun environment gives the address, rank and
    world."""
    if backend not in ("nccl", "gloo"):
        raise ValueError("the backend is nccl (cards) or gloo (the CPU, or several ranks on "
                         "one card), not %r" % backend)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl reduces CUDA tensors only; the CPU takes gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # before any CUDA call, or each rank opens cuda:0
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, rank=rank, world_size=world)
    dist.init_process_group(backend, **kwargs)
    return create_mesh(model_parallel)


def teardown():
    global _MESH
    _MESH = None
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier():
    if _MESH is not None:
        dist.barrier()


def broadcast_object(obj, src=0):
    """`obj` of rank `src` on every rank (a picklable object: the eval
    metric); `obj` itself without a mesh."""
    if _MESH is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
