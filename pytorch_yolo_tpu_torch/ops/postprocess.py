"""Map detections from net-input (letterboxed) pixels back to source images.

Counterpart of ``pytorch_yolo_tpu/ops/postprocess.py``: subtract the pad,
divide by the scale, clamp to the original image bounds; with the geometry
fixed per pipeline (:func:`unletterbox_boxes`) or one row an image
(:func:`unletterbox_boxes_dynamic`, the prepared pipeline).
"""

from __future__ import annotations

import torch

from .preprocess import LetterboxGeometry


def unletterbox_boxes(boxes: torch.Tensor, geo: LetterboxGeometry) -> torch.Tensor:
    """(…, 4) x1,y1,x2,y2 in net-input pixels -> original-image pixels,
    clamped to [0, W0] x [0, H0]."""
    x1 = ((boxes[..., 0] - geo.pad_x) / geo.scale).clamp(0.0, float(geo.orig_w))
    y1 = ((boxes[..., 1] - geo.pad_y) / geo.scale).clamp(0.0, float(geo.orig_h))
    x2 = ((boxes[..., 2] - geo.pad_x) / geo.scale).clamp(0.0, float(geo.orig_w))
    y2 = ((boxes[..., 3] - geo.pad_y) / geo.scale).clamp(0.0, float(geo.orig_h))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def unletterbox_boxes_dynamic(boxes: torch.Tensor, geos: torch.Tensor) -> torch.Tensor:
    """Per-image un-letterboxing for heterogeneous source shapes: boxes
    (N, K, 4), geos (N, 5) fp32 rows [scale, pad_x, pad_y, orig_w, orig_h];
    the math of :func:`unletterbox_boxes` with the geometry as data."""
    scale, pad_x, pad_y = geos[:, 0:1], geos[:, 1:2], geos[:, 2:3]
    w0, h0 = geos[:, 3:4], geos[:, 4:5]
    zero = torch.zeros_like(w0)
    x1 = torch.clamp((boxes[..., 0] - pad_x) / scale, zero, w0)
    y1 = torch.clamp((boxes[..., 1] - pad_y) / scale, zero, h0)
    x2 = torch.clamp((boxes[..., 2] - pad_x) / scale, zero, w0)
    y2 = torch.clamp((boxes[..., 3] - pad_y) / scale, zero, h0)
    return torch.stack([x1, y1, x2, y2], dim=-1)
