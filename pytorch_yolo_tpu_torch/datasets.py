"""Dataset plumbing: COCO-format annotations + image iteration.

A copy of ``pytorch_yolo_tpu/datasets.py``.  The accuracy metric is mAP@0.5
on COCO val.  This module reads COCO instance-annotation JSON with the
standard library only (no pycocotools) and yields (image path,
ground-truth boxes/classes) pairs for the evaluation runner in ``cli.py``.

COCO category ids are sparse (1..90 with gaps); Darknet models emit dense
0..79 indices in ``coco.names`` order — ``category_id_map`` bridges them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Sample:
    image_id: int
    path: str
    width: int
    height: int
    gt_boxes: np.ndarray   # (G, 4) xyxy pixels
    gt_classes: np.ndarray  # (G,) dense 0..C-1
    gt_crowd: np.ndarray   # (G,) bool iscrowd flags (ignore regions for eval)


def category_id_map(categories: list[dict]) -> dict[int, int]:
    """COCO sparse category id -> dense contiguous index (name order kept)."""
    ids = sorted(c["id"] for c in categories)
    return {cid: i for i, cid in enumerate(ids)}


def load_coco(
    annotations_json: str,
    images_dir: str,
    max_images: int | None = None,
    skip_crowd: bool = False,
) -> Iterator[Sample]:
    """Yield Samples for every image in a COCO instances JSON.

    Crowd annotations are kept and flagged via ``Sample.gt_crowd`` (the
    evaluator treats them as ignore regions, per pycocotools); pass
    ``skip_crowd=True`` to drop them entirely."""
    with open(annotations_json, "r", encoding="utf-8") as f:
        coco = json.load(f)
    cat_map = category_id_map(coco.get("categories", []))
    anns_by_img: dict[int, list[dict]] = {}
    for a in coco.get("annotations", []):
        if skip_crowd and a.get("iscrowd"):
            continue
        anns_by_img.setdefault(a["image_id"], []).append(a)

    images = coco.get("images", [])
    if max_images is not None:
        images = images[:max_images]
    for im in images:
        anns = anns_by_img.get(im["id"], [])
        if anns:
            xywh = np.asarray([a["bbox"] for a in anns], dtype=np.float64)
            boxes = np.stack([xywh[:, 0], xywh[:, 1],
                              xywh[:, 0] + xywh[:, 2], xywh[:, 1] + xywh[:, 3]], axis=1)
            classes = np.asarray([cat_map[a["category_id"]] for a in anns],
                                 dtype=np.int64)
            crowd = np.asarray([bool(a.get("iscrowd")) for a in anns], dtype=bool)
        else:
            boxes = np.zeros((0, 4), dtype=np.float64)
            classes = np.zeros((0,), dtype=np.int64)
            crowd = np.zeros((0,), dtype=bool)
        yield Sample(
            image_id=im["id"],
            path=os.path.join(images_dir, im["file_name"]),
            width=im["width"],
            height=im["height"],
            gt_boxes=boxes,
            gt_classes=classes,
            gt_crowd=crowd,
        )
