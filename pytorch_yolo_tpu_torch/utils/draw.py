"""Box drawing for the command line's outputs.

A copy of ``pytorch_yolo_tpu/utils/draw.py``.  Where ``cv2`` imports, the
boxes and their labels are drawn with OpenCV exactly as there.  A host
without OpenCV (the port's card machine has none) gets the same box
outlines and filled label bars drawn in numpy, with no text: the bar is
about as large as OpenCV's 0.5-scale simplex label would be (7 px a
character, 14 px high), so the layout matches and the class shows by color.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .palette import class_colors

_CHAR_W, _TEXT_H, _BASELINE = 7, 14, 3  # ~cv2.getTextSize at FONT_HERSHEY_SIMPLEX, 0.5, 1


def _rect(image: np.ndarray, x1: int, y1: int, x2: int, y2: int, color, thickness: int) -> None:
    """``cv2.rectangle`` in numpy, square-cornered: an outline of edges
    ``2 * (thickness // 2) + 1`` px wide centred on the box's edges (3 px at
    OpenCV's thickness 2, as it draws them), or filled for a negative
    thickness; clipped to the image."""
    h, w = image.shape[:2]
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))

    def fill(ya: int, yb: int, xa: int, xb: int) -> None:  # inclusive corners
        image[min(max(ya, 0), h):min(max(yb + 1, 0), h),
              min(max(xa, 0), w):min(max(xb + 1, 0), w)] = color

    if thickness < 0:
        fill(y1, y2, x1, x2)
        return
    r = thickness // 2
    fill(y1 - r, y1 + r, x1 - r, x2 + r)  # top
    fill(y2 - r, y2 + r, x1 - r, x2 + r)  # bottom
    fill(y1 - r, y2 + r, x1 - r, x1 + r)  # left
    fill(y1 - r, y2 + r, x2 - r, x2 + r)  # right


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    cls_ids: np.ndarray,
    scores: np.ndarray,
    class_names: Sequence[str],
    thickness: int = 2,
) -> np.ndarray:
    """Draw labeled boxes in-place on a BGR uint8 image; returns the image."""
    try:
        import cv2
    except ImportError:
        cv2 = None

    colors = class_colors(max(len(class_names), 1))
    for (x1, y1, x2, y2), cid, score in zip(boxes.astype(int), cls_ids, scores):
        color = colors[int(cid) % len(colors)]
        name = class_names[int(cid)] if int(cid) < len(class_names) else str(int(cid))
        label = f"{name} {score:.2f}"
        if cv2 is None:
            _rect(image, x1, y1, x2, y2, color, thickness)
            tw, th, baseline = _CHAR_W * len(label), _TEXT_H, _BASELINE
            ty = max(y1, th + baseline)
            _rect(image, x1, ty - th - baseline, x1 + tw, ty, color, -1)
            continue
        cv2.rectangle(image, (x1, y1), (x2, y2), color, thickness)
        (tw, th), baseline = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = max(y1, th + baseline)
        cv2.rectangle(image, (x1, ty - th - baseline), (x1 + tw, ty), color, -1)
        cv2.putText(image, label, (x1, ty - baseline // 2), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return image
