"""Class-name handling (reference: ``load_classes`` + ``coco.names``,
SURVEY.md §2.1 #11).  The 80 COCO class names are public, stable data; we
embed them so the framework works with zero data files, while still accepting
a user ``.names`` path.

A copy of ``pytorch_yolo_tpu/utils/names.py`` (that package imports jax on
import); ``tests/test_torch_config_weights.py`` holds the two equal."""

from __future__ import annotations

COCO_NAMES: tuple[str, ...] = (
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "sofa", "pottedplant",
    "bed", "diningtable", "toilet", "tvmonitor", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


def load_classes(path: str | None = None) -> tuple[str, ...]:
    """Read a Darknet ``.names`` file (one class per line); default COCO-80."""
    if path is None:
        return COCO_NAMES
    with open(path, "r", encoding="utf-8") as f:
        return tuple(line.strip() for line in f if line.strip())
