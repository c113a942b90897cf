"""Multi-card training: the (data, model) process layout (mesh.py), the
reductions across ranks with their gradients (functional.py) and the CTC
head's vocabulary split (shardings.py). Port of pytorchocr_tpu/parallel/."""
