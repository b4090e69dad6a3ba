"""The comparison that decides ``correct``: the program's results of a sample
of the window's batches, judged against the plain reference run on the same
frames.

For each judged image the program gives its K = min(max_det, D) slots
(corner box in frame pixels, objectness, class score, class, kept); its
candidates are the slots whose objectness clears ``conf``.  The reference
gives every anchor (box, objectness, every class's probability).  The distance
of a program candidate k to an anchor a is the largest of

    |box_k - box_a| (any corner coordinate, in network pixels) / the
                   anchor's box's longer side (at least 8 network pixels,
                   the finest head's stride),
    |obj_k - obj_a|,
    |score_k - p_a(class_k)|, and
    max_c p_a(c) - p_a(class_k)   (how far the served class lies below the
                                   reference's best at that anchor).

Three numbers are compared, each with its limit:

- ``row_gap_image``: over the judged images, the largest mean distance from
  an image's candidates to their nearest anchors: how far the served rows of
  the worst answer (one frame's detections) lie from the reference's.  An
  answer altered or taken from other frames reads large.  (The mean over
  every candidate, ``row_gap_mean``, and the largest single distance,
  ``row_gap_max``, are printed too and not compared: the largest single
  distance is an extreme over some 10^5 candidates that swings 2x from seed
  to seed in bf16, while the nearest-anchor search caps the control's, so
  the two readings can lie within 3x of each other.)
- ``cover_gap``: the largest distance from an anchor that is due (reference
  objectness above the threshold by ``DUE_MARGIN``; where the program's
  slots are all candidates, above its lowest candidate's objectness by the
  margin) to its nearest program candidate; ``NONE_SERVED`` where due anchors
  meet no candidate at all.  A dropped result reads ``NONE_SERVED``; an
  altered box or class, or results of other frames, leave due anchors far
  from every candidate.
- ``keep_errors``: candidates whose kept flag breaks greedy class-wise NMS
  over the program's own ranking and boxes (the frame-pixel boxes are the
  network-pixel ones scaled and shifted, which keeps every IoU): kept though
  a kept candidate of its class ranked above it overlaps it by more than
  ``iou + IOU_MARGIN``, or dropped though none overlaps it by more than
  ``iou - IOU_MARGIN``; and kept slots that are no candidates.  A pair with
  a box clamped to the frame's edge is no evidence either way.  The margin
  covers the rounding of the unletterbox arithmetic.
"""

from __future__ import annotations

import torch

from .reference.darknet import iou

NAMES = ("row_gap_image", "cover_gap", "keep_errors")
NONE_SERVED = 1e6  # cover_gap of an image with due anchors and no candidate
DUE_MARGIN = 0.05  # objectness over the threshold that makes an anchor due
IOU_MARGIN = 0.001  # the unletterbox arithmetic's rounding of an IoU


def judge_image(prog: dict, ref, conf: float, iou_thresh: float, frame_w: float,
                frame_h: float, scale: float) -> dict:
    """Numbers for one image.  ``prog``: (K, ...) tensors boxes, obj, score,
    cls, keep; ``ref``: the reference's Rows of this image, (D, ...);
    ``scale``: network pixels a frame pixel (the letterbox's)."""
    boxes, obj, score, cls, keep = (prog[k] for k in ("boxes", "obj", "score", "cls", "keep"))
    k_slots = obj.shape[0]
    cand = obj > conf
    idx = torch.nonzero(cand).flatten()
    out = {"candidates": int(idx.numel()), "kept": int((keep & cand).sum()),
           "keep_errors": int((keep & ~cand).sum())}
    if idx.numel():
        bp, op, sp, cp = boxes[idx], obj[idx], score[idx], cls[idx].long()
        side = (ref.boxes_net[:, 2:] - ref.boxes_net[:, :2]).amax(dim=-1).clamp(min=8.0)
        d = (bp[:, None, :] - ref.boxes[None, :, :]).abs().amax(dim=-1) * (scale / side[None, :])
        d = torch.maximum(d, (op[:, None] - ref.obj[None, :]).abs())
        pc = ref.cls[:, cp].T                                 # p_a(class_k), (m, D)
        d = torch.maximum(d, (sp[:, None] - pc).abs())
        d = torch.maximum(d, ref.cls.amax(dim=-1)[None, :] - pc)
        near = d.min(dim=1).values
        out["row_gap_max"], out["row_gap_sum"] = float(near.max()), float(near.sum())
        thr = conf if idx.numel() < k_slots else float(op.min())
        due = ref.obj > thr + DUE_MARGIN
        out["cover_gap"] = float(d[:, due].min(dim=0).values.max()) if bool(due.any()) else 0.0
        # greedy class-wise NMS over the program's own ranking and boxes; a
        # box clamped to the frame's edge has lost its network-pixel shape,
        # so a pair with one holds no evidence either way
        o = iou(bp, bp)
        edge = ((bp[:, 0] <= 0) | (bp[:, 1] <= 0) | (bp[:, 2] >= frame_w)
                | (bp[:, 3] >= frame_h))
        known = ~(edge[:, None] | edge[None, :])
        above = torch.ones_like(o, dtype=torch.bool).triu(1) & (cp[:, None] == cp[None, :])
        kept_above = above & keep[idx][:, None]
        over = kept_above & known & (o > iou_thresh + IOU_MARGIN)
        maybe = kept_above & (~known | (o > iou_thresh - IOU_MARGIN))
        out["keep_errors"] += (int((keep[idx] & over.any(dim=0)).sum())
                               + int((~keep[idx] & ~maybe.any(dim=0)).sum()))
    else:
        out["row_gap_max"] = out["row_gap_sum"] = 0.0
        out["cover_gap"] = NONE_SERVED if bool((ref.obj > conf + DUE_MARGIN).any()) else 0.0
    return out


def merge(per_image: list) -> dict:
    """The run's numbers: the largest gaps, the summed counts."""
    n = sum(p["candidates"] for p in per_image)
    return {"row_gap_image": max((p["row_gap_sum"] / p["candidates"] for p in per_image
                                  if p["candidates"]), default=0.0),
            "row_gap_mean": sum(p["row_gap_sum"] for p in per_image) / max(n, 1),
            "row_gap_max": max((p["row_gap_max"] for p in per_image), default=0.0),
            "cover_gap": max((p["cover_gap"] for p in per_image), default=0.0),
            "keep_errors": sum(p["keep_errors"] for p in per_image),
            "images": len(per_image),
            "candidates": n,
            "kept": sum(p["kept"] for p in per_image)}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[n] <= limits[n] for n in NAMES)
