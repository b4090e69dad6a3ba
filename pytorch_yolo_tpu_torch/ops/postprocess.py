"""Map detections from net-input (letterboxed) pixels back to source images.

Counterpart of ``pytorch_yolo_tpu/ops/postprocess.py: unletterbox_boxes``:
subtract the pad, divide by the scale, clamp to the original image bounds.
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
