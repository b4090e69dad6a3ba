"""Plain fp32 reference of a Darknet YOLO detector, from the .cfg text.

Written from the Darknet semantics (pjreddie/darknet, AlexeyAB/darknet), not
from the program under test: it imports torch and numpy only.  Everything the
program derives in its own set-up (casts, plans, repacked weights) is worked
out again here from the cfg text, the folded fp32 weights and the uint8
frames that the benchmark hands to both sides.

    net = Darknet(cfg_text, weights)          # weights: {conv index: (w OIHW, b)}
    x, geo = letterbox(frames_u8, size)       # (N, 3, S, S) fp32 in [0, 1]
    rows = net.rows(x, geo)                   # every anchor of every head

The forward runs in fp32 with TF32 off (``fp32_exact``).  ``rows`` gives,
for each anchor, its corner box in network pixels (``boxes_net``) and in
frame pixels clamped to the frame (``boxes``), its objectness and its class
probabilities.  ``greedy_keep`` is class-wise greedy NMS in float64.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# cfg text
# ---------------------------------------------------------------------------


def parse_sections(text: str) -> list[dict]:
    """The cfg's sections in order, each a dict of its options (strings)
    with its header under ``"type"``; comments (``#``, ``;``) dropped."""
    sections: list[dict] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].split(";", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            sections.append({"type": line.strip("[]").strip()})
        elif "=" in line:
            key, value = line.split("=", 1)
            sections[-1][key.strip()] = value.strip()
    return sections


def _ints(value: str) -> list[int]:
    return [int(t) for t in value.replace(" ", "").split(",") if t]


class Layer(NamedTuple):
    """One layer of the walked cfg: its kind, its sources (absolute indices)
    and input / output shapes as (C, H, W)."""

    index: int
    kind: str
    opts: dict
    sources: tuple
    in_shape: tuple
    out_shape: tuple


def walk(text: str, size: "int | None" = None) -> tuple[dict, list[Layer]]:
    """([net] options, layers with their shapes) at input ``size`` (square;
    the cfg's own width when None)."""
    sections = parse_sections(text)
    net, body = sections[0], sections[1:]
    if net["type"] not in ("net", "network"):
        raise ValueError("a cfg starts with [net]")
    s = size or int(net["width"])
    shape = (int(net.get("channels", 3)), s, s)
    layers: list[Layer] = []
    for i, opts in enumerate(body):
        kind = opts["type"]
        prev = layers[-1].out_shape if layers else shape
        if kind == "convolutional":
            k, stride = int(opts.get("size", 1)), int(opts.get("stride", 1))
            pad = k // 2 if int(opts.get("pad", 0)) else int(opts.get("padding", 0))
            h = (prev[1] + 2 * pad - k) // stride + 1
            w = (prev[2] + 2 * pad - k) // stride + 1
            out, srcs = (int(opts["filters"]), h, w), (i - 1,)
        elif kind == "maxpool":
            k, stride = int(opts["size"]), int(opts.get("stride", 1))
            h = (prev[1] + k - 1 - k) // stride + 1
            w = (prev[2] + k - 1 - k) // stride + 1
            out, srcs = (prev[0], h, w), (i - 1,)
        elif kind == "upsample":
            st = int(opts.get("stride", 2))
            out, srcs = (prev[0], prev[1] * st, prev[2] * st), (i - 1,)
        elif kind == "route":
            srcs = tuple(j if j >= 0 else i + j for j in _ints(opts["layers"]))
            if int(opts.get("groups", 1)) != 1:
                raise ValueError("grouped [route] is not in this reference")
            first = layers[srcs[0]].out_shape
            out = (sum(layers[j].out_shape[0] for j in srcs), first[1], first[2])
        elif kind == "shortcut":
            j = int(opts["from"])
            srcs = (i - 1, j if j >= 0 else i + j)
            out = prev
        elif kind == "yolo":
            out, srcs = prev, (i - 1,)
        else:
            raise ValueError(f"layer {i}: [{kind}] is not in this reference")
        layers.append(Layer(i, kind, opts, srcs, prev, out))
    return net, layers


def conv_layers(layers: list[Layer]) -> list[Layer]:
    return [layer for layer in layers if layer.kind == "convolutional"]


class Head(NamedTuple):
    """A [yolo] head's decode arguments."""

    anchors: tuple   # (w, h) pairs in network pixels, the masked ones
    classes: int
    scale_xy: float
    new_coords: bool


def heads_of(layers: list[Layer]) -> list[Head]:
    out = []
    for layer in layers:
        if layer.kind != "yolo":
            continue
        o = layer.opts
        flat = [float(t) for t in o["anchors"].replace(" ", "").split(",") if t]
        pairs = list(zip(flat[0::2], flat[1::2]))
        mask = _ints(o["mask"]) if "mask" in o else list(range(len(pairs)))
        out.append(Head(tuple(pairs[m] for m in mask), int(o["classes"]),
                        float(o.get("scale_x_y", 1.0)), bool(int(o.get("new_coords", 0)))))
    return out


# ---------------------------------------------------------------------------
# letterbox
# ---------------------------------------------------------------------------


class Geometry(NamedTuple):
    scale: float
    new_w: int
    new_h: int
    pad_x: int
    pad_y: int
    frame_w: int
    frame_h: int


def geometry(frame_h: int, frame_w: int, size: int) -> Geometry:
    """Darknet's letterbox placement: the frame scaled by min(S/W, S/H),
    the new sizes truncated, centred on an S x S canvas."""
    scale = min(size / frame_w, size / frame_h)
    new_w, new_h = int(frame_w * scale), int(frame_h * scale)
    return Geometry(scale, new_w, new_h, (size - new_w) // 2, (size - new_h) // 2,
                    frame_w, frame_h)


def letterbox(frames: torch.Tensor, size: int, bgr: bool = True) -> tuple[torch.Tensor, Geometry]:
    """(N, H, W, 3) uint8 frames -> ((N, 3, S, S) fp32 in [0, 1], geometry):
    BGR to RGB, bilinear resize with half-pixel centres and no antialias,
    gray (128) canvas, / 255."""
    n, h, w, _ = frames.shape
    geo = geometry(h, w, size)
    x = frames.permute(0, 3, 1, 2).to(torch.float32)
    if bgr:
        x = x[:, [2, 1, 0]]
    x = F.interpolate(x, size=(geo.new_h, geo.new_w), mode="bilinear", align_corners=False)
    canvas = torch.full((n, 3, size, size), 128.0, dtype=torch.float32, device=frames.device)
    canvas[:, :, geo.pad_y:geo.pad_y + geo.new_h, geo.pad_x:geo.pad_x + geo.new_w] = x
    return canvas / 255.0, geo


# ---------------------------------------------------------------------------
# forward, decode, NMS
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_exact():
    """cuDNN and cuBLAS in true fp32 (no TF32) for the duration."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def activate(y: torch.Tensor, name: str) -> torch.Tensor:
    if name == "leaky":
        return torch.where(y > 0, y, 0.1 * y)
    if name == "mish":
        return y * torch.tanh(F.softplus(y))
    if name == "logistic":
        return torch.sigmoid(y)
    if name == "relu":
        return torch.clamp(y, min=0.0)
    if name == "linear":
        return y
    raise ValueError(f"activation {name!r} is not in this reference")


class Rows(NamedTuple):
    """Every anchor of every head, (N, D, ...), cell-major and anchor-minor
    within a head, heads in network order."""

    boxes_net: torch.Tensor  # (N, D, 4) x1, y1, x2, y2 in network pixels
    boxes: torch.Tensor      # (N, D, 4) the same in frame pixels, clamped to the frame
    obj: torch.Tensor        # (N, D)
    cls: torch.Tensor        # (N, D, C) class probabilities


class Darknet:
    """The cfg's forward in fp32 on ``weights``' device.

    ``weights`` maps each conv's layer index to (w (O, C, KH, KW), b (O,)),
    batch norm already folded."""

    def __init__(self, cfg_text: str, weights: dict, size: "int | None" = None) -> None:
        self.net, self.layers = walk(cfg_text, size)
        self.size = self.layers[0].in_shape[1]
        self.heads = heads_of(self.layers)
        self.weights = weights
        last_use: dict[int, int] = {}
        for layer in self.layers:
            for j in layer.sources:
                last_use[j] = layer.index
        self._last_use = last_use
        self._head_inputs = [layer.sources[0] for layer in self.layers if layer.kind == "yolo"]

    def forward(self, x: torch.Tensor, conv=None) -> list[torch.Tensor]:
        """(N, 3, S, S) fp32 -> the head maps (N, A*(5+C), Gy, Gx), fp32.
        ``conv(index, x, w, b, stride, pad)``, when given, computes each
        conv in place of ``F.conv2d`` (the weight maker's calibration)."""
        conv = conv or (lambda i, x, w, b, stride, pad: F.conv2d(x, w, b, stride=stride,
                                                                 padding=pad))
        outs: dict[int, torch.Tensor] = {-1: x}
        heads = []
        with fp32_exact():
            for layer in self.layers:
                i, o = layer.index, layer.opts
                src = [outs[j] for j in layer.sources]
                if layer.kind == "convolutional":
                    w, b = self.weights[i]
                    k = int(o.get("size", 1))
                    pad = k // 2 if int(o.get("pad", 0)) else int(o.get("padding", 0))
                    y = conv(i, src[0], w, b, int(o.get("stride", 1)), pad)
                    y = activate(y, o.get("activation", "logistic"))
                elif layer.kind == "maxpool":
                    k, st = int(o["size"]), int(o.get("stride", 1))
                    lo = (k - 1) // 2
                    y = F.pad(src[0], (lo, k - 1 - lo, lo, k - 1 - lo), value=-math.inf)
                    y = F.max_pool2d(y, k, st)
                elif layer.kind == "upsample":
                    st = int(o.get("stride", 2))
                    y = src[0].repeat_interleave(st, dim=2).repeat_interleave(st, dim=3)
                elif layer.kind == "route":
                    y = torch.cat(src, dim=1) if len(src) > 1 else src[0]
                elif layer.kind == "shortcut":
                    y = activate(src[0] + src[1], o.get("activation", "linear"))
                else:  # yolo
                    heads.append(src[0])
                    y = src[0]
                outs[i] = y
                for j in layer.sources:  # free what no later layer reads
                    if self._last_use.get(j) == i and j not in self._head_inputs:
                        outs.pop(j, None)
        return heads

    def decode(self, maps: list[torch.Tensor], geo: Geometry) -> Rows:
        """Head maps -> :class:`Rows`.  [yolo]: box centre (sigmoid(t) * s -
        (s - 1) / 2 + cell) * stride, size anchor * exp(t), sigmoid objectness
        and classes; with new_coords the head conv's logistic already ran, so
        centre (t * s - (s - 1) / 2 + cell) * stride, size anchor * (2t)^2,
        objectness and classes as they are."""
        boxes, objs, clss = [], [], []
        for m, head in zip(maps, self.heads):
            n, _, gy, gx = m.shape
            a = len(head.anchors)
            t = m.reshape(n, a, 5 + head.classes, gy, gx).permute(0, 3, 4, 1, 2)
            cy, cx = torch.meshgrid(torch.arange(gy, device=m.device, dtype=torch.float32),
                                    torch.arange(gx, device=m.device, dtype=torch.float32),
                                    indexing="ij")
            cx, cy = cx[None, :, :, None], cy[None, :, :, None]
            anc = torch.tensor(head.anchors, dtype=torch.float32, device=m.device)
            s, shift = head.scale_xy, 0.5 * (head.scale_xy - 1.0)
            stride_x, stride_y = self.size / gx, self.size / gy
            if head.new_coords:
                bx = (t[..., 0] * s - shift + cx) * stride_x
                by = (t[..., 1] * s - shift + cy) * stride_y
                bw = anc[:, 0] * (2.0 * t[..., 2]) ** 2
                bh = anc[:, 1] * (2.0 * t[..., 3]) ** 2
                obj, cls = t[..., 4], t[..., 5:]
            else:
                bx = (torch.sigmoid(t[..., 0]) * s - shift + cx) * stride_x
                by = (torch.sigmoid(t[..., 1]) * s - shift + cy) * stride_y
                bw = anc[:, 0] * torch.exp(t[..., 2])
                bh = anc[:, 1] * torch.exp(t[..., 3])
                obj, cls = torch.sigmoid(t[..., 4]), torch.sigmoid(t[..., 5:])
            box = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], dim=-1)
            boxes.append(box.reshape(n, gy * gx * a, 4))
            objs.append(obj.reshape(n, gy * gx * a))
            clss.append(cls.reshape(n, gy * gx * a, head.classes))
        net_boxes = torch.cat(boxes, dim=1)
        frame = torch.empty_like(net_boxes)
        for j, (pad, bound) in enumerate(((geo.pad_x, geo.frame_w), (geo.pad_y, geo.frame_h)) * 2):
            frame[..., j] = ((net_boxes[..., j] - pad) / geo.scale).clamp(0.0, float(bound))
        return Rows(net_boxes, frame, torch.cat(objs, dim=1), torch.cat(clss, dim=1))

    def rows(self, x: torch.Tensor, geo: Geometry) -> Rows:
        return self.decode(self.forward(x), geo)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of corner boxes (..., P, 4) x (..., Q, 4) -> (..., P, Q), float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(dim=-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def greedy_keep(boxes: torch.Tensor, cls: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Class-wise greedy NMS over one image's candidates in rank order:
    a candidate is kept when no kept candidate of its class ranked above it
    overlaps it by more than ``iou_thresh``."""
    over = (iou(boxes, boxes) > iou_thresh) & (cls[:, None] == cls[None, :])
    keep = torch.zeros(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    for k in range(boxes.shape[0]):
        keep[k] = not bool((over[:k, k] & keep[:k]).any())
    return keep
