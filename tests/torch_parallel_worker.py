"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py:

  python tests/torch_parallel_worker.py JOB.pt RANK WORLD INIT_FILE OUT.pt

JOB.pt (torch.save of a dict) names the step (`kind`), the config, the
state_dict every rank starts from, the global batch (numpy arrays),
`model_parallel` and the `dtype` of the model and the batch's floats. The
rank takes its data rank's rows of the batch, runs one port train step
(trainer.make_train_step) and saves the losses, every gradient, the
parameters and buffers after the update and its place in the mesh to
OUT.pt. Imports the port only (no JAX), one thread a rank.

Kinds: "step" (any model of the config: DB, SLANet), "per_rank_loss" (the
same, with the DB loss's sums and OHEM range kept per rank, as a plain
DistributedDataParallel would: the control that must miss the JAX loss),
"own_coins" (SLANet drawing each rank's own (N, steps) scheduled-sampling
coins, the control of the global draw), "tp" (the CRNN with its CTC head
split over the model group, shardings.py).
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _to(transform, dtype):
    """The device normalize transform, its float32 output cast to `dtype`."""
    return None if transform is None else (lambda x: transform(x).to(dtype))


def run(job, rank, world, init_file):
    from pytorchocr_tpu_torch.losses import basic, build_loss
    from pytorchocr_tpu_torch.modeling import build_model
    from pytorchocr_tpu_torch.optimizer import build_optimizer
    from pytorchocr_tpu_torch.parallel import mesh, shardings
    from pytorchocr_tpu_torch.trainer import (batch_to_device, build_input_transform,
                                              make_train_step)

    cpu = torch.device("cpu")
    grid = mesh.setup("gloo", cpu, model_parallel=job.get("model_parallel", 1),
                      init_method="file://" + init_file, rank=rank, world=world)
    if job["kind"] == "own_coins":
        from pytorchocr_tpu_torch.modeling.heads import table_att_head

        table_att_head.data_shard = lambda: (0, 1)
    if job["kind"] == "per_rank_loss":
        basic.all_sum = lambda x: x
        basic.global_min = lambda v: v.amin()
        basic.global_max = lambda v: v.amax()
    cfg = job["cfg"]
    model = build_model(cfg["Architecture"])
    model.load_state_dict(job["state"])
    dtype = job.get("dtype", torch.float32)
    model.to(dtype)
    split = shardings.shard_params(model) if job["kind"] == "tp" else []
    opt, _ = build_optimizer(cfg["Optimizer"], epochs=job["epochs"],
                             step_each_epoch=job["steps_per_epoch"],
                             parameters=model.parameters())
    spec = cfg.get("Global", {}).get("_device_normalize_spec", {}).get("Train")
    step = make_train_step(model, build_loss(cfg["Loss"]), opt,
                           input_transform=_to(build_input_transform(spec), dtype))
    n = len(job["batch"][0]) // grid.data_world
    rows = slice(grid.data_rank * n, (grid.data_rank + 1) * n)
    batch = [b.to(dtype) if b.is_floating_point() else b
             for b in batch_to_device([b[rows] for b in job["batch"]], cpu)]
    losses = step(batch)
    out = dict(rank=rank, data_rank=grid.data_rank, model_rank=grid.model_rank, split=split,
               losses={k: v.double() for k, v in losses.items()},
               grads={k: p.grad.detach().clone() for k, p in model.named_parameters()
                      if p.grad is not None},
               state={k: v.detach().clone() for k, v in model.state_dict().items()})
    mesh.teardown()
    return out


def main():
    job_path, rank, world, init_file, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    torch.save(run(job, int(rank), int(world), init_file), out_path)


if __name__ == "__main__":
    main()
