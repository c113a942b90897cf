"""pytorchocr_tpu_torch — the PyTorch / CUDA port of pytorchocr_tpu.

The port runs on one NVIDIA H100 (Hopper, sm_90a). It mirrors the layout of
the JAX package `pytorchocr_tpu/`, which stays the reference: every module
here names its JAX counterpart, and `tests/test_torch_*.py` hold each one
against it on the same inputs with bridged weights.

This slice covers the flagship serving path only:

  DB-ResNet18 (FPN, DBHead) -> device DB front half (threshold, connected
  components through the hand-written run-max kernel, per-label
  count/score/bbox) -> host minAreaRect + unclip -> line crops ->
  CRNN (VGG, BiLSTM, CTCHead) -> CTC greedy collapse,

composed by `deploy.run_ocr.OCRer.run_many`. Everything else of the JAX
package raises `NotImplementedError` naming the ROADMAP.md item that ports it.

Layouts: modules are NCHW `nn.Module`s (channels_last on CUDA); the public
functions keep the JAX layouts (HWC image batches in, (N, H, W, 1) DB maps,
(N, T, C) CTC probabilities, (H, W) label maps).

Nothing here imports jax or flax. The JAX package's framework-free host code
(data transforms, geometry, config loading, the character tables) is reused
by import. CUDA kernels are compiled with nvcc at first use (`_kernels.py`),
so importing this package needs neither a card nor a compiler.
"""

__version__ = "0.1.0"
