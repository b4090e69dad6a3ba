"""Deterministic class-color palette for box drawing.

A copy of ``pytorch_yolo_tpu/utils/palette.py``: a golden-angle hue walk in
HSV, so no binary palette asset is needed."""

from __future__ import annotations

import colorsys


def class_colors(num_classes: int = 80) -> list[tuple[int, int, int]]:
    """BGR uint8 color per class, visually well-separated and deterministic."""
    colors = []
    for i in range(num_classes):
        hue = (i * 0.61803398875) % 1.0
        sat = 0.65 + 0.35 * ((i * 7) % 3) / 2.0
        val = 0.75 + 0.25 * ((i * 5) % 2)
        r, g, b = colorsys.hsv_to_rgb(hue, sat, val)
        colors.append((int(b * 255), int(g * 255), int(r * 255)))
    return colors
