"""Tensor ops of the detection path: letterbox, decode, kernels, NMS."""
