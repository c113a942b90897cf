"""pytorchocr_tpu_torch — the PyTorch / CUDA port of pytorchocr_tpu.

The port runs on one NVIDIA H100 (Hopper, sm_90a). It mirrors the layout of
the JAX package `pytorchocr_tpu/`, which stays the reference: every module
here names its JAX counterpart, and `tests/test_torch_*.py` hold each one
against it on the same inputs with bridged weights.

It covers the serving path:

  DB-ResNet18 (FPN, DBHead), PSENet or PAN detection -> device front half
  (threshold, connected components through the hand-written run-max
  kernel, the PSE expansion through the propagation kernel) -> host boxes
  -> line crops -> direction classifier (MobileNetV3, ClsHead) -> CRNN
  (VGG, BiLSTM, CTCHead) -> CTC greedy collapse,

composed by `deploy.run_ocr.OCRer.run_many`, with int8 PTQ detection
(`ops/quant.py`; its convolutions in the hand-written int8 kernel), and the
training of DB detectors: the train-time data (`data/`), the DB loss
(`losses/`), optax's Adam (`optimizer/`), the det metric (`metrics/`), the
train step (`trainer.py`), checkpoints (`utils/save_load.py`) and the
`tools.train` / `tools.eval` entry points, on one card or on N ranks under
`torch.distributed.run` (`parallel/`: the JAX step on the global batch, the
CTC head's vocabulary split over a model group). Everything else of the JAX package
raises `NotImplementedError` naming the ROADMAP.md item that ports it.

Layouts: modules are NCHW `nn.Module`s (channels_last on CUDA); the public
functions keep the JAX layouts (HWC image batches in, (N, H, W, 1) DB maps,
(N, T, C) CTC probabilities, (H, W) label maps).

Nothing here imports jax, flax or any module of the JAX package. The host
code the port runs has its own copy here, each function marked with its
origin: config loading (`utils/config.py`), geometry (`utils/geometry.py`),
reading order and crops (`utils/utility.py`), the dictionary path
(`utils/assets.py`), the data ops and loader (`data/`), the DB host path, the
CTC character table and the host PSE/PAN expansions (`postprocess/`), the
native geometry library (`native.py`, `csrc/geometry_kernels.cpp`, built with
g++). CUDA kernels are compiled with nvcc at first use (`_kernels.py`), so
importing this package needs neither a card nor a compiler.
"""

__version__ = "0.1.0"
