"""Fixed-shape, class-wise non-maximum suppression.

Counterpart of ``pytorch_yolo_tpu/ops/nms.py``: per image, the top K =
min(max_det, D) candidates by masked score (invalid = -1, so they sort
last), then a greedy keep mask over them — :func:`ops.kernels.nms_keep`
(K2) on the device, its plain version (the parallel fixpoint) on the CPU.
:func:`batched_nms_fused` takes the serving pipeline's 8-column rows,
:func:`batched_nms` the 85-column decoded rows (the whole batch in one
K2 launch).  :func:`fixpoint_suppress`, :func:`greedy_suppress` and
:func:`leader_election_suppress` are the single-image oracles the tests
hold K2's plain version against.

Top-K is a stable descending sort, not ``torch.topk``: the keep mask
depends on the candidates' order, ``lax.top_k`` puts equal scores lowest
index first, and ``torch.topk`` does not (on [1, .5, 1, 1, -1, 1] it gave
indices [3, 5, 0, 2] for ``lax.top_k``'s [0, 2, 3, 5]).  Ties are the norm
when synthetic weights saturate every objectness to exactly 1.0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import nms_keep


class NMSResult(NamedTuple):
    """Fixed-shape NMS output for a batch.

    boxes:  (N, K, 4) x1,y1,x2,y2 in net-input pixels (letterboxed frame)
    obj:    (N, K) objectness
    cls_score: (N, K) best-class probability
    cls_id: (N, K) int32 class index
    valid:  (N, K) bool — True for rows that survived filter + NMS
    """

    boxes: torch.Tensor
    obj: torch.Tensor
    cls_score: torch.Tensor
    cls_id: torch.Tensor
    valid: torch.Tensor


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) corner boxes -> (..., K, K)."""
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0.0) * (iy2 - iy1).clamp(min=0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def fixpoint_suppress(iou: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy NMS as a parallel fixpoint over one image's (K, K) IoU matrix."""
    return fixpoint_keep(iou > iou_thresh, valid)


def fixpoint_keep(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Keep mask from an overlap relation (..., K, K) and validity (..., K).

    Rows are rank order; only over[j, i] with j < i counts.  A round keeps
    every undecided candidate with no unkilled higher-ranked overlapper and
    kills every undecided one with a kept overlapper; invalid rows start
    killed.  The keep-set equals sequential greedy NMS's."""
    return _fixpoint(over, valid)[0]


def fixpoint_rounds(over: torch.Tensor, valid: torch.Tensor) -> int:
    """The number of rounds :func:`fixpoint_keep` takes on a batch (its
    deepest image): the depth of the longest suppression chain, plus one."""
    return _fixpoint(over, valid)[1]


def _fixpoint(over: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, int]:
    k = over.shape[-1]
    over = over & torch.ones((k, k), dtype=torch.bool, device=over.device).triu(1)
    kept = torch.zeros_like(valid)
    killed = ~valid
    rounds = 0
    while bool((~(kept | killed)).any()):
        undecided = ~(kept | killed)
        blocked = (over & ~killed[..., :, None]).any(dim=-2)
        kill_now = (over & kept[..., :, None]).any(dim=-2)
        kept = kept | (undecided & ~blocked)
        killed = killed | (undecided & kill_now)
        rounds += 1
    return kept, rounds


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Sequential greedy NMS over one image's score-sorted candidates: row i
    survives iff it is valid and no higher-ranked kept row overlaps it."""
    over = iou > iou_thresh
    keep = torch.zeros_like(valid)
    for i in range(iou.shape[0]):
        keep[i] = valid[i] & ~(over[i, :i] & keep[:i]).any()
    return keep


def batched_nms_fused(
    rows: torch.Tensor,
    conf_thresh: float = 0.5,
    iou_thresh: float = 0.4,
    max_det: int = 300,
    class_agnostic: bool = False,
) -> NMSResult:
    """NMS over fused decode+score rows (N, D, 8) from
    :func:`ops.kernels.decode_score_all`.

    Columns: x1, y1, x2, y2, obj, cls_score, cls_id, rank."""
    n, d, _ = rows.shape
    k = min(max_det, d)
    masked = torch.where(rows[..., 4] > conf_thresh, rows[..., 7],
                         torch.full_like(rows[..., 7], -1.0))
    top_rank, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top_rank, idx = top_rank[:, :k], idx[:, :k]
    sel = torch.gather(rows, 1, idx[..., None].expand(n, k, rows.shape[-1]))  # (N, K, 8)
    valid = top_rank > 0.0
    boxes = sel[..., 0:4].contiguous()
    cls_f = sel[..., 6].contiguous()
    keep = nms_keep(boxes, valid, iou_thresh, cls_id=None if class_agnostic else cls_f)
    return NMSResult(boxes=boxes, obj=sel[..., 4], cls_score=sel[..., 5],
                     cls_id=cls_f.to(torch.int32), valid=keep)


def leader_election_suppress(iou: torch.Tensor, valid: torch.Tensor,
                             iou_thresh: float) -> torch.Tensor:
    """Greedy NMS by leader election over one image's score-sorted (K, K)
    IoU matrix: each round keeps the highest-ranked undecided candidate and
    eliminates every candidate it overlaps, so it runs once a kept box.
    The keep-set equals :func:`greedy_suppress`'s."""
    over = iou > iou_thresh
    keep = torch.zeros_like(valid)
    undecided = valid.clone()
    while bool(undecided.any()):
        lead = int(undecided.nonzero()[0, 0])
        keep[lead] = True
        undecided &= ~over[lead]
        undecided[lead] = False
    return keep


def _select_topk(det: torch.Tensor, conf_thresh: float, max_det: int, score_mode: str):
    """Candidate selection from (N, D, 5+C) decoded rows: each image's top
    K = min(max_det, D) rows by masked score (objectness, or objectness
    times the best class score), in a stable descending sort; returns the
    rows, their objectness, best class score and class, and validity."""
    obj = det[..., 4]
    cls_score, cls_id = det[..., 5:].max(dim=-1)  # the first of equal maxima, as argmax
    rank = obj if score_mode == "obj" else obj * cls_score
    masked = torch.where(obj > conf_thresh, rank, torch.full_like(rank, -1.0))
    k = min(max_det, det.shape[1])
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    sel = torch.gather(det, 1, idx[..., None].expand(-1, -1, det.shape[-1]))
    return (sel, torch.gather(obj, 1, idx), torch.gather(cls_score, 1, idx),
            torch.gather(cls_id, 1, idx).to(torch.int32), top > 0.0)


def batched_nms(
    detections: torch.Tensor,
    conf_thresh: float = 0.5,
    iou_thresh: float = 0.4,
    max_det: int = 300,
    score_mode: str = "obj",
    class_agnostic: bool = False,
) -> NMSResult:
    """Class-wise NMS over a batch of decoded detections (N, D, 5+C), fp32
    rows [cx, cy, w, h, obj, class scores...]: the top-K candidates of each
    image, their corners, and the greedy keep mask, one K2 launch for the
    batch on the card."""
    if score_mode not in ("obj", "obj*cls"):
        raise ValueError(f"unknown score_mode {score_mode!r} ('obj' or 'obj*cls')")
    sel, obj, cls_score, cls_id, valid = _select_topk(detections, conf_thresh, max_det,
                                                      score_mode)
    cx, cy, w, h = sel[..., 0], sel[..., 1], sel[..., 2], sel[..., 3]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    keep = nms_keep(boxes, valid, iou_thresh,
                    cls_id=None if class_agnostic else cls_id.to(torch.float32))
    return NMSResult(boxes=boxes, obj=obj, cls_score=cls_score, cls_id=cls_id, valid=keep)
