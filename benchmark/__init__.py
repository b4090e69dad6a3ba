"""Benchmark of the PyTorch and CUDA port (``pytorch_yolo_tpu_torch``); see README.md."""
