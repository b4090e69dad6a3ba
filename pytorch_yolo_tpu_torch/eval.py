"""Detection-quality evaluation: PASCAL/COCO-style mAP.

A copy of ``pytorch_yolo_tpu/eval.py``.  Greedy IoU matching per class
following pycocotools semantics (highest-score detections first; each
detection takes the best *unmatched* ground truth above the threshold;
crowd ground truths are ignore regions — a detection whose
intersection-over-detection-area with a crowd box clears the threshold is
neither TP nor FP) and AP as the area under the interpolated
precision-recall curve, both the continuous VOC-2010+ integral and COCO's
101-point variant, plus mAP@[.5:.95].

Pure numpy, on the host: evaluation is offline bookkeeping, not a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass
class ImageEval:
    """Detections + ground truth for one image.

    det_boxes: (M, 4) xyxy; det_scores: (M,); det_classes: (M,) int
    gt_boxes: (G, 4) xyxy; gt_classes: (G,) int
    gt_crowd: (G,) bool — COCO iscrowd flags; crowd GTs are ignore regions
    (excluded from the GT count; detections matching them are dropped from
    the PR curve), per pycocotools.  Defaults to all-False.
    """

    det_boxes: np.ndarray
    det_scores: np.ndarray
    det_classes: np.ndarray
    gt_boxes: np.ndarray
    gt_classes: np.ndarray
    gt_crowd: np.ndarray | None = None

    def crowd_flags(self) -> np.ndarray:
        if self.gt_crowd is None:
            return np.zeros(len(self.gt_boxes), dtype=bool)
        return np.asarray(self.gt_crowd, dtype=bool)


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,), dtype=np.float64)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = np.clip(box[2] - box[0], 0, None) * np.clip(box[3] - box[1], 0, None)
    b = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
    union = a + b - inter
    return np.where(union > 0, inter / union, 0.0)


def _iof_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Intersection over the *detection's* area — pycocotools' crowd overlap."""
    if boxes.size == 0:
        return np.zeros((0,), dtype=np.float64)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = np.clip(box[2] - box[0], 0, None) * np.clip(box[3] - box[1], 0, None)
    return np.where(a > 0, inter / np.maximum(a, 1e-12), 0.0)


def _match_class(
    dets: list[tuple[float, int, np.ndarray]],
    gts: dict[int, np.ndarray],
    iou_thresh: float,
    crowds: dict[int, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Greedy matching for one class across the dataset (pycocotools rules).

    dets: (score, image_id, box) list; gts: image_id -> (G, 4) non-crowd
    boxes; crowds: image_id -> (Gc, 4) crowd ignore regions.
    Each detection (descending score) takes the best *unmatched* GT whose IoU
    clears the threshold; otherwise, if its intersection-over-detection-area
    with any crowd region clears the threshold it is ignored (neither TP nor
    FP); otherwise FP.  Returns (tp, fp) with ignored detections removed, and
    the non-crowd GT count."""
    n_gt = sum(len(g) for g in gts.values())
    dets = sorted(dets, key=lambda t: -t[0])
    matched: dict[int, np.ndarray] = {i: np.zeros(len(g), bool) for i, g in gts.items()}
    crowds = crowds or {}
    tp: list[float] = []
    fp: list[float] = []
    for score, img, box in dets:
        g = gts.get(img)
        if g is not None and len(g):
            ious = _iou_one_to_many(box, g)
            avail = (~matched[img]) & (ious >= iou_thresh)
            if avail.any():
                j = int(np.argmax(np.where(avail, ious, -1.0)))
                matched[img][j] = True
                tp.append(1.0)
                fp.append(0.0)
                continue
        cg = crowds.get(img)
        if cg is not None and len(cg):
            if float(_iof_one_to_many(box, cg).max()) >= iou_thresh:
                continue  # inside a crowd ignore region: drop from PR curve
        tp.append(0.0)
        fp.append(1.0)
    return np.asarray(tp), np.asarray(fp), n_gt


def average_precision(tp: np.ndarray, fp: np.ndarray, n_gt: int,
                      method: str = "continuous") -> float:
    """AP from per-detection TP/FP flags (descending score order).

    ``continuous``: exact area under the interpolated PR curve (VOC 2010+).
    ``coco101``: COCO's 101-point average."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    # interpolated precision: running max from the right
    p_interp = np.maximum.accumulate(precision[::-1])[::-1]
    if method == "coco101":
        grid = np.linspace(0, 1, 101)
        idx = np.searchsorted(recall, grid, side="left")
        p = np.where(idx < len(p_interp), p_interp[np.minimum(idx, len(p_interp) - 1)], 0.0)
        return float(p.mean())
    # continuous integral over recall
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[p_interp[0]], p_interp])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def evaluate(
    images: Iterable[ImageEval],
    iou_thresh: float = 0.5,
    method: str = "continuous",
) -> dict:
    """mAP at one IoU threshold.  Returns {"mAP", "per_class": {cls: AP}}."""
    by_class_dets: dict[int, list] = {}
    by_class_gts: dict[int, dict[int, np.ndarray]] = {}
    by_class_crowds: dict[int, dict[int, np.ndarray]] = {}
    for img_id, im in enumerate(images):
        crowd = im.crowd_flags()
        for c in np.unique(im.gt_classes).tolist() if im.gt_classes.size else []:
            sel = im.gt_classes == c
            if (sel & ~crowd).any():
                by_class_gts.setdefault(int(c), {})[img_id] = im.gt_boxes[sel & ~crowd]
            if (sel & crowd).any():
                by_class_crowds.setdefault(int(c), {})[img_id] = im.gt_boxes[sel & crowd]
        for b, s, c in zip(im.det_boxes, im.det_scores, im.det_classes):
            by_class_dets.setdefault(int(c), []).append((float(s), img_id, np.asarray(b)))

    per_class: dict[int, float] = {}
    for c in sorted(set(by_class_gts) | set(by_class_dets)):
        tp, fp, n_gt = _match_class(
            by_class_dets.get(c, []), by_class_gts.get(c, {}), iou_thresh,
            crowds=by_class_crowds.get(c))
        ap = average_precision(tp, fp, n_gt, method=method)
        if not np.isnan(ap):
            per_class[c] = ap
    m = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"mAP": m, "per_class": per_class, "iou_thresh": iou_thresh}


def evaluate_coco(images: Sequence[ImageEval]) -> dict:
    """COCO headline numbers: AP@[.5:.95] (101-point), AP50, AP75."""
    thresholds = np.arange(0.5, 1.0, 0.05)
    aps = [evaluate(images, iou_thresh=float(t), method="coco101")["mAP"]
           for t in thresholds]
    return {
        "AP": float(np.mean(aps)),
        "AP50": aps[0],
        "AP75": aps[5],
        "per_threshold": dict(zip([round(float(t), 2) for t in thresholds], aps)),
    }
