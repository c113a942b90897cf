"""Training entry — port of tools/train.py.

Usage:
  python -m pytorchocr_tpu_torch.tools.train -c configs/det/det_r18_db_synth.yml \
      [-o Global.epoch_num=45 ...]

Runs on the first card; `-o Global.use_gpu=False` runs on the CPU, and
`use_gpu: True` without a card raises. The model starts from the JAX
package's initialisers (utils/seeded.py:seeded_init_, seeded by
Global.seed), then the backbone's ImageNet weights, then a resume
(Global.checkpoints) or finetune (Global.pretrained_model) checkpoint.
"""

import torch

from ..data import build_dataloader
from ..losses import build_loss
from ..metrics import build_metric
from ..modeling import build_model
from ..optimizer import build_optimizer
from ..postprocess import build_post_process
from ..utils.save_load import load_backbone_pretrained, load_model
from ..utils.seeded import seeded_init_
from . import program


def build_train_model(config, device):
    """The config's model on `device` with the JAX initialisers, drawn from
    Global.seed (channels_last on the card)."""
    model = build_model(config["Architecture"])
    seeded_init_(model, torch.Generator().manual_seed(int(config["Global"].get("seed", 2022))))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def main(config, device, logger, tsb_writer):
    global_config = config["Global"]
    train_dataloader, _ = build_dataloader(config, "Train", logger, seed=global_config.get("seed"))
    if len(train_dataloader) == 0:
        logger.error("No Images in train dataset, please ensure\n"
                     "\t1. The images num in the train label_file_list should be larger than or "
                     "equal with batch size.\n"
                     "\t2. The annotation file and path in the configuration file are provided "
                     "normally.")
        return None
    valid_dataloader = None
    if config.get("Eval"):
        valid_dataloader, _ = build_dataloader(config, "Eval", logger,
                                               seed=global_config.get("seed"))

    post_process_class = build_post_process(config["PostProcess"], global_config)
    model = build_train_model(config, device)
    loss_class = build_loss(config["Loss"])
    optimizer, _ = build_optimizer(config["Optimizer"], epochs=global_config["epoch_num"],
                                   step_each_epoch=len(train_dataloader),
                                   parameters=model.parameters())
    load_backbone_pretrained(model, config["Architecture"], logger)
    global_state = load_model(config, model, optimizer, logger)

    logger.info("train dataloader has {} iters".format(len(train_dataloader)))
    if valid_dataloader is not None:
        logger.info("valid dataloader has {} iters".format(len(valid_dataloader)))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model parameters: {:.2f}M".format(n_params / 1e6))

    return program.train(config, device, train_dataloader, valid_dataloader, model, loss_class,
                         optimizer, global_state, post_process_class,
                         build_metric(config["Metric"]), logger, tsb_writer)


def run(argv=None):
    """Parse the command line and train; returns program.train's report."""
    return main(*program.preprocess(is_train=True, argv=argv))


if __name__ == "__main__":
    run()
