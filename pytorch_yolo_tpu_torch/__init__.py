"""pytorch_yolo_tpu_torch — the YOLO (Darknet) detection path in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100.

The PyTorch counterpart of ``pytorch_yolo_tpu`` (JAX + Pallas), which stays
beside it as the reference.  This package imports torch and never jax.

Quick start::

    import pytorch_yolo_tpu_torch as pyt
    det = pyt.Detector.load("yolov3", device="cuda", dtype=torch.bfloat16)
    dets = det.detect_batch(frames_uint8_nhwc, size=416, conf=0.6, iou=0.45)
"""

from .api import Detection, Detector, detect, load
from .ops.nms import NMSResult

__all__ = ["Detection", "Detector", "NMSResult", "detect", "load"]
