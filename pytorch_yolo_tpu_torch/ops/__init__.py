"""Tensor ops of the detection path: letterbox, decode, kernels, NMS."""

from .decode import decode_all, decode_head
from .nms import NMSResult, batched_nms, greedy_suppress, iou_matrix
from .postprocess import unletterbox_boxes
from .preprocess import LetterboxGeometry, letterbox_batch, letterbox_geometry, letterbox_image

__all__ = [
    "decode_all",
    "decode_head",
    "NMSResult",
    "batched_nms",
    "greedy_suppress",
    "iou_matrix",
    "unletterbox_boxes",
    "LetterboxGeometry",
    "letterbox_batch",
    "letterbox_geometry",
    "letterbox_image",
]
