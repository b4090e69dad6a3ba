"""YOLO detection-head decode: raw feature maps -> anchor boxes (plain torch).

Counterpart of ``pytorch_yolo_tpu/ops/decode.py``.  Decode math:

    bx = (sigmoid(tx) + cx) * stride      bw = pw * exp(tw)
    by = (sigmoid(ty) + cy) * stride      bh = ph * exp(th)
    obj = sigmoid(to)
    p(class_i) = sigmoid(ti)              # [region]: softmax or raw logits

Anchors (pw, ph) are in net-input pixels.  Rows are cell-major, anchor-minor
per head, heads concatenated in network order.  This full (D, 5+C) decode is
the oracle that the fused decode+score kernel's plain version
(``ops/kernels.decode_score_head_ref``) is tested against.
"""

from __future__ import annotations

import torch

from ..config import ModelSpec, RegionSpec, YoloSpec, head_strides


def head_decode_args(head: "YoloSpec | RegionSpec", stride: int):
    """(anchors in net-input px, class activation, scale_x_y, new_coords).

    [yolo] anchors are already in pixels with sigmoid class scores; [region]
    anchors are in grid-cell units (scaled by the head stride here) with a
    softmax over classes (raw logits when the cfg sets softmax=0).
    ``scale_x_y`` is the YOLOv4 grid-sensitivity factor (1.0 for v2/v3).
    ``new_coords`` ([yolo] only — Scaled-YOLOv4) selects the pre-activated
    decode; class scores then pass through ("linear": the preceding
    logistic conv already applied the sigmoid)."""
    if isinstance(head, RegionSpec):
        anchors = tuple((w * stride, h * stride) for w, h in head.anchors)
        return anchors, ("softmax" if head.softmax else "linear"), 1.0, False
    if head.new_coords:
        return head.anchors, "linear", head.scale_x_y, True
    return head.anchors, "sigmoid", head.scale_x_y, False


def decode_head(
    raw: torch.Tensor,
    anchors: tuple[tuple[float, float], ...],
    stride: int,
    num_classes: int,
    cls_act: str = "sigmoid",
    scale_xy: float = 1.0,
    new_coords: bool = False,
) -> torch.Tensor:
    """Decode one head's raw (N, Gy, Gx, A*(5+C)) map to (N, Gy*Gx*A, 5+C).

    Returns [bx, by, bw, bh, obj, p0..pC-1] with box centres/sizes in
    net-input pixels, fp32.  ``new_coords`` (Scaled-YOLOv4) decodes inputs
    the head conv already passed through a sigmoid:
    ``bx = (tx * scale - 0.5 * (scale - 1) + cx) * stride``,
    ``bw = (2 * tw)^2 * pw``, obj passes through."""
    n, gy, gx, ch = raw.shape
    a = len(anchors)
    assert ch == a * (5 + num_classes), (tuple(raw.shape), anchors, num_classes)
    x = raw.reshape(n, gy, gx, a, 5 + num_classes).to(torch.float32)
    cx = torch.arange(gx, dtype=torch.float32, device=raw.device)[None, None, :, None]
    cy = torch.arange(gy, dtype=torch.float32, device=raw.device)[None, :, None, None]

    al, sh = float(scale_xy), 0.5 * (float(scale_xy) - 1.0)
    txy0 = x[..., 0] if new_coords else torch.sigmoid(x[..., 0])
    txy1 = x[..., 1] if new_coords else torch.sigmoid(x[..., 1])
    bx = (txy0 * al - sh + cx) * float(stride)
    by = (txy1 * al - sh + cy) * float(stride)
    pw = torch.tensor([w for w, _ in anchors], dtype=torch.float32, device=raw.device)
    ph = torch.tensor([h for _, h in anchors], dtype=torch.float32, device=raw.device)
    if new_coords:
        bw = pw * torch.square(2.0 * x[..., 2])
        bh = ph * torch.square(2.0 * x[..., 3])
        obj = x[..., 4]
    else:
        bw = pw * torch.exp(x[..., 2])
        bh = ph * torch.exp(x[..., 3])
        obj = torch.sigmoid(x[..., 4])
    if cls_act == "softmax":
        cls = torch.softmax(x[..., 5:], dim=-1)
    elif cls_act == "linear":
        cls = x[..., 5:]
    else:
        cls = torch.sigmoid(x[..., 5:])
    out = torch.cat([bx[..., None], by[..., None], bw[..., None], bh[..., None],
                     obj[..., None], cls], dim=-1)
    return out.reshape(n, gy * gx * a, 5 + num_classes)


def decode_all(heads: tuple[torch.Tensor, ...], spec: ModelSpec) -> torch.Tensor:
    """Decode and concatenate every head: -> (N, D, 5+C)."""
    outs = []
    for raw, head, stride in zip(heads, spec.yolo_layers, head_strides(spec)):
        anchors, cls_act, sxy, nc = head_decode_args(head, stride)
        outs.append(decode_head(raw, anchors, stride, head.classes, cls_act,
                                scale_xy=sxy, new_coords=nc))
    return torch.cat(outs, dim=1)
