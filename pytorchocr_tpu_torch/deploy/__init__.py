"""Deploy runtime and CLIs of the port (python -m pytorchocr_tpu_torch.deploy.run_ocr)."""
