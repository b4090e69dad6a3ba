"""pytorch_yolo_tpu_torch — the YOLO (Darknet) detection path in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100.

The PyTorch counterpart of ``pytorch_yolo_tpu`` (JAX + Pallas), which stays
beside it as the reference.  This package imports torch and never jax.

Quick start::

    import pytorch_yolo_tpu_torch as pyt
    det = pyt.Detector.load("yolov3", device="cuda", dtype=torch.bfloat16)
    dets = det.detect_batch(frames_uint8_nhwc, size=416, conf=0.6, iou=0.45)

The command line: ``python -m pytorch_yolo_tpu_torch --help``.
"""

from .api import Detection, Detector, detect, load
from .config import ModelSpec, build_spec, load_model_spec, parse_cfg_file, parse_cfg_text
from .models.zoo import available_models, model_spec, write_cfg
from .ops.nms import NMSResult
from .weights import fold_batchnorm, load_weights, random_raw_params, write_weights_file
from . import parallel  # the batch mesh: Detector(mesh=parallel.make_batch_mesh(...))

__all__ = [
    "Detection",
    "Detector",
    "NMSResult",
    "detect",
    "load",
    "ModelSpec",
    "load_model_spec",
    "parse_cfg_file",
    "parse_cfg_text",
    "build_spec",
    "available_models",
    "model_spec",
    "write_cfg",
    "load_weights",
    "write_weights_file",
    "fold_batchnorm",
    "random_raw_params",
]
