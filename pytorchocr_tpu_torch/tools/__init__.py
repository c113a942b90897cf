"""The port's training and eval entry points: `python -m
pytorchocr_tpu_torch.tools.train` and `python -m pytorchocr_tpu_torch.tools.eval`."""
